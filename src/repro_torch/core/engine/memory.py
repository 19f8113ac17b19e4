"""Tiered memory policy for the condensed distance store.

PR 4's read-only dense float32 cache made steady-state admissions ~4x
cheaper, but it is all-or-nothing: one persistent ``(K, K)`` float32 next to
the condensed vector, which is the wrong answer once K reaches the 10^4-10^6
regime the sharded proximity engine targets.  This module replaces the
hardcoded cache with a **policy layer** that every dense-ish read of
:class:`~repro_torch.core.engine.store.CondensedDistances` routes through:

``dense``
    PR 4 behavior: a persistent read-only ``(K, K)`` float32 cache, kept
    warm across admissions by one contiguous memcpy per ``append_block``.
    Costs ``4 K^2`` bytes; the fastest tier for replay-heavy admission
    streams at small/medium K.
``banded``
    A fixed window of **hot rows** in float32 (:class:`BandedRowCache`),
    LRU-promoted by the replay's ``leaf_rows`` / promotion-fallback gathers
    and pre-seeded with newcomer rows on every admission (the replay reads
    exactly those first).  Costs ``4 * window * K`` bytes; cold rows fall
    back to strided gathers from the condensed vector.
``condensed_only``
    No cache at all — every row read is a strided gather.  Minimal memory
    (the condensed vector only), for K where even a band is too expensive.
``spilled``
    Past the host-RAM wall: even the condensed vector itself no longer
    fits, so the store switches its backend to
    :class:`~repro_torch.core.engine.store_backends.SpilledSegments` — cold
    column-range segments live in an mmap'd spill file, only a hot tail
    plus a bounded residency window of cold pages stay in RAM.  No cache
    on top; every row read is a strided gather through the segments.
``auto``
    Picks a tier per current K from a byte budget (default
    :data:`DEFAULT_BYTE_BUDGET`): ``spilled`` once the condensed vector
    itself (``2 K (K - 1)`` bytes) exceeds the budget, else ``dense``
    while the full cache fits, ``banded`` while a window does,
    ``condensed_only`` beyond that.  The band window additionally tracks
    the *observed* per-operation row locality (:attr:`StoreMemory.hot_rows`,
    a decayed max of distinct rows gathered per replay) and regrows when
    an operation overflows it.

Label parity: every tier returns bitwise-identical row values (the store is
float32; float32 -> float64 upcasts are exact), and all consumers aggregate
those rows with tier-independent blocked arithmetic — so HC labels are
bitwise identical across tiers.  ``tests/test_memory_policy.py`` pins this
on the randomized + tie-grid suites and asserts the banded/condensed
bootstrap + replay never materialize a ``(K, K)`` float64.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MEMORY_MODES = ("auto", "dense", "banded", "condensed_only", "spilled")

# auto-mode byte budget for cache structures (the persistent condensed
# vector is not counted — it is the store itself, not a cache — EXCEPT for
# the spill decision: once the vector itself outgrows the budget, auto
# resolves to "spilled" and the budget bounds the store's resident bytes).
# 256 MiB keeps `dense` up to K ~ 8k, a 512-row band up to K ~ 128k, and
# the condensed vector fully in RAM up to K ~ 11.5k.
DEFAULT_BYTE_BUDGET = 256 * 2**20

# Gather blocking note: consumers aggregate leaf rows through
# repro_torch.core.hc.blocked_column_fold (ROW_BLOCK-row blocks), so no tier ever
# materializes more than (ROW_BLOCK, K) float64 at once and the aggregation
# arithmetic — hence the HC labels — is bitwise equal across tiers.


@dataclass(frozen=True)
class MemoryPolicy:
    """How the distance store may spend memory on dense-ish caches.

    Parameters
    ----------
    mode: ``"auto"`` (default) | ``"dense"`` | ``"banded"`` |
        ``"condensed_only"`` | ``"spilled"`` — see the module docstring for
        the tiers.  ``auto`` resolves a concrete tier per current client
        count K against ``byte_budget``.
    byte_budget: cache byte budget for ``auto`` resolution (bytes; the
        condensed store itself is not counted, except for the spill
        decision — see the module docstring).  ``None`` (default) means
        :data:`DEFAULT_BYTE_BUDGET` (256 MiB).  In the ``spilled`` tier
        this same budget bounds the store's *resident* bytes (hot tail +
        cold-segment residency window).
    band_rows: requested window height of the banded row cache, in rows
        (default 512).  The effective window is clamped to the budget and
        to K, and in ``auto`` mode grows with the observed per-operation
        row locality.
    spill_dir: directory for the ``spilled`` tier's segment file
        (default ``None`` — the system temp dir).
    spill_segment_rows: columns per cold segment flushed by the
        ``spilled`` tier (default 1024).  Smaller segments mean finer
        residency granularity; larger ones fewer mmap regions.

    All tiers produce bitwise-identical HC labels; the policy trades
    memory against steady-state admission latency only.
    """

    mode: str = "auto"
    byte_budget: Optional[int] = None
    band_rows: int = 512
    spill_dir: Optional[str] = None
    spill_segment_rows: int = 1024

    def __post_init__(self):
        if self.mode not in MEMORY_MODES:
            raise ValueError(
                f"unknown memory mode: {self.mode!r} (want one of {MEMORY_MODES})"
            )
        if self.band_rows < 1:
            raise ValueError("band_rows must be >= 1")
        if self.spill_segment_rows < 1:
            raise ValueError("spill_segment_rows must be >= 1")

    @property
    def budget(self) -> int:
        return (
            DEFAULT_BYTE_BUDGET if self.byte_budget is None else int(self.byte_budget)
        )

    def resolve(self, n: int) -> str:
        """Concrete tier for a store of ``n`` clients.

        Resolution order: ``spilled`` first — once the condensed vector
        itself (``4 * n(n-1)/2`` bytes) exceeds the budget, no in-RAM
        cache arrangement can help — then ``dense`` / ``banded`` /
        ``condensed_only`` by cache cost as before.
        """
        if self.mode != "auto":
            return self.mode
        if 2 * n * (n - 1) > self.budget:
            return "spilled"
        if 4 * n * n <= self.budget:
            return "dense"
        if 4 * n * min(self.band_rows, max(n, 1)) <= self.budget:
            return "banded"
        return "condensed_only"

    def band_window(self, n: int, hot_rows: int = 0) -> int:
        """Effective band height for ``n`` clients.

        Explicit ``banded`` mode honors ``band_rows`` as requested
        (clamped to n only — the byte budget is documented as an
        ``auto``-mode knob and must not silently shrink a user-chosen
        window).  In ``auto`` mode the window additionally grows to cover
        the observed per-operation row locality ``hot_rows`` (2x headroom)
        so a workload whose replays touch more rows than ``band_rows``
        stops thrashing the LRU — clamped to the byte budget and to n.
        """
        want = self.band_rows
        if self.mode != "auto":
            return int(max(1, min(n, want)))
        if hot_rows > 0:
            want = max(want, 2 * int(hot_rows))
        cap = max(1, self.budget // max(4 * n, 1))
        return int(max(1, min(n, cap, want)))


@dataclass
class MemoryStats:
    """What the policy layer actually did (telemetry for benchmarks/tests)."""

    band_hits: int = 0
    band_misses: int = 0
    gathered_rows: int = 0       # rows handed out across all gathers
    peak_gather_bytes: int = 0   # largest single gather allocation
    densifications: int = 0      # dense-tier cache builds
    spilled_bytes: int = 0       # store bytes in the spill file (spilled tier)
    cold_segment_reads: int = 0  # cold-segment touches (spilled tier)


class BandedRowCache:
    """Fixed float32 window of hot store rows, LRU-promoted on access.

    Slots hold full ``(n,)`` rows of the symmetric distance matrix; the
    mapping row-id -> slot is LRU-ordered, so the window converges on the
    rows the dendrogram replay actually reads (dirty-cluster seeds,
    promotion aggregates).  ``extend`` keeps the window warm across an
    admission: cached rows gain their new cross-block entries in place and
    the B newcomer rows are pre-seeded (the replay gathers exactly those
    first).  Values are bitwise the store's (float32 in, float32 kept), so
    hit/miss patterns can never change downstream labels.
    """

    def __init__(self, n: int, window: int):
        self.n = int(n)
        self.window = max(1, int(window))
        self._buf = np.empty((self.window, self.n), dtype=np.float32)
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # row -> slot
        self._free = list(range(self.window - 1, -1, -1))
        self.hits = 0
        self.misses = 0

    @property
    def nbytes(self) -> int:
        return self._buf.nbytes

    @property
    def resident(self) -> int:
        return len(self._lru)

    def _insert(self, row: int, vals: np.ndarray) -> None:
        slot = self._lru.get(row)
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:
                _, slot = self._lru.popitem(last=False)  # evict LRU
            self._lru[row] = slot
        else:
            self._lru.move_to_end(row)
        self._buf[slot, : self.n] = vals

    def gather(self, store, idx: np.ndarray, promote: bool = True) -> np.ndarray:
        """(len(idx), n) float64 rows; misses come from the condensed store.

        ``promote=False`` reads through without touching the LRU or
        inserting — for streaming full-matrix scans (the n_clusters tail)
        that would otherwise evict the entire hot window.
        """
        out = np.empty((idx.size, self.n), dtype=np.float64)
        miss_pos = []
        for t, r in enumerate(idx):
            slot = self._lru.get(int(r))
            if slot is None:
                miss_pos.append(t)
            else:
                out[t] = self._buf[slot, : self.n]
                if promote:
                    self._lru.move_to_end(int(r))
                self.hits += 1
        if miss_pos:
            self.misses += len(miss_pos)
            miss_idx = idx[np.asarray(miss_pos, dtype=np.int64)]
            rows = store.rows(miss_idx)  # float64, exact float32 upcast
            out[np.asarray(miss_pos, dtype=np.int64)] = rows
            if promote:
                # out holds exact float32 upcasts, so the float32 insert
                # round-trips bitwise
                for t, r in zip(miss_pos, miss_idx):
                    self._insert(int(r), out[t])
        return out

    def extend(self, cross: np.ndarray, square: np.ndarray) -> None:
        """Admission of B newcomers: widen rows in place, seed newcomer rows."""
        M, B = self.n, int(square.shape[0])
        n_new = M + B
        buf = np.empty((self.window, n_new), dtype=np.float32)
        buf[:, :M] = self._buf[:, :M]
        for row, slot in self._lru.items():
            buf[slot, M:] = cross[row]
        self._buf = buf
        self.n = n_new
        j = np.arange(B)
        for b in range(B):
            # mirror the condensed layout exactly: the store keeps the
            # square block's UPPER triangle, so seed row M+b from it
            # (square[min(b,j), max(b,j)]) with a zero diagonal — bitwise
            # what store.rows would return even for a caller-supplied
            # square that violates the symmetric/zero-diag precondition
            sq_row = np.where(j < b, square[:, b], square[b, :])
            sq_row[b] = 0.0
            self._insert(M + b, np.concatenate([cross[:, b], sq_row]))

    def regrow(self, window: int) -> None:
        """Enlarge the window in place, keeping every resident row warm.

        Auto-mode locality growth uses this instead of dropping the band:
        an admission immediately before the regrow has just memcpy-extended
        and newcomer-seeded the buffer — discarding it would cold-start the
        very replay whose locality pressure triggered the growth.
        """
        if window <= self.window:
            return
        buf = np.empty((window, self.n), dtype=np.float32)
        lru = OrderedDict()
        slot = 0
        for row, old_slot in self._lru.items():  # preserves LRU order
            buf[slot, : self.n] = self._buf[old_slot, : self.n]
            lru[row] = slot
            slot += 1
        self._buf = buf
        self._lru = lru
        self._free = list(range(window - 1, slot - 1, -1))
        self.window = window

    def fork(self) -> "BandedRowCache":
        c = BandedRowCache.__new__(BandedRowCache)
        c.n = self.n
        c.window = self.window
        c._buf = self._buf.copy()
        c._lru = OrderedDict(self._lru)
        c._free = list(self._free)
        c.hits = self.hits
        c.misses = self.misses
        return c


class StoreMemory:
    """Per-store policy state: tier resolution, band cache, telemetry.

    Owned by :class:`~repro_torch.core.engine.store.CondensedDistances`; all row
    gathers (`CondensedDistances.gather_rows`) route through :meth:`gather`,
    which dispatches on the resolved tier.  The engine/replay call
    :meth:`begin_op` at the start of every bootstrap/admit/depart so the
    dense tier's adaptive densify threshold and the auto band sizing see
    per-operation row counts.
    """

    def __init__(self, policy: Optional[MemoryPolicy] = None):
        self.policy = policy if policy is not None else MemoryPolicy()
        self.band: Optional[BandedRowCache] = None
        self.stats = MemoryStats()
        self.hot_rows = 0           # decayed max of distinct rows per op
        self._op_seen: set[int] = set()  # distinct row ids this operation

    def tier(self, n: int) -> str:
        return self.policy.resolve(n)

    @property
    def cache_nbytes(self) -> int:
        return self.band.nbytes if self.band is not None else 0

    def begin_op(self, store) -> None:
        """Start of a bootstrap/admit/depart: fold the last operation's
        distinct-row count into the locality estimate and regrow an
        overflowed band."""
        op_rows = len(self._op_seen)
        self.hot_rows = max(op_rows, (self.hot_rows + op_rows) // 2)
        self._op_seen = set()
        if self.band is not None and self.policy.mode == "auto":
            # regrow in place (resident rows stay warm — an admission may
            # have just extended + newcomer-seeded this buffer)
            self.band.regrow(self.policy.band_window(store.n, self.hot_rows))

    def _band_for(self, store) -> BandedRowCache:
        if self.band is None or self.band.n != store.n:
            self.band = BandedRowCache(
                store.n, self.policy.band_window(store.n, self.hot_rows)
            )
        return self.band

    def gather(self, store, idx: np.ndarray, promote: bool = True) -> np.ndarray:
        """(len(idx), K) float64 row gather under the resolved tier."""
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        tier = self.tier(store.n)
        if promote:
            # promote=False marks streaming full-forest scans (e.g. the
            # n_clusters tail): they must not count toward the hot-row
            # locality estimate, or auto mode would balloon the band window
            # to the full budget and drop the warm band after every tail.
            # Distinct ids, not raw counts: cascades re-gather the same
            # cluster rows per promotion and would inflate a raw counter
            # far past the true working set.
            self._op_seen.update(idx.tolist())
        self.stats.gathered_rows += int(idx.size)
        if tier == "dense":
            if store.has_dense_cache or not promote or (
                len(self._op_seen) * 8 > store.n
            ):
                # cascades amortize one densification (kept warm by
                # append_block thereafter); small scattered gathers below
                # the K/8 threshold stay on strided condensed reads.
                if not store.has_dense_cache:
                    self.stats.densifications += 1
                out = store.dense_ro()[idx].astype(np.float64)  # repro-lint: ignore[R3]  # port of src/repro/core/engine/memory.py, allowlisted there
            else:
                out = store.rows(idx)
        elif tier == "banded":
            band = self._band_for(store)
            out = band.gather(store, idx, promote=promote)
            self.stats.band_hits = band.hits
            self.stats.band_misses = band.misses
        else:
            # condensed_only and spilled: strided condensed gathers — the
            # spilled backend walks cold segments one at a time under its
            # residency budget inside store.rows
            out = store.rows(idx)
            if tier == "spilled":
                self.stats.spilled_bytes = int(
                    getattr(store, "spilled_nbytes", 0)
                )
                self.stats.cold_segment_reads = int(
                    getattr(store, "cold_segment_reads", 0)
                )
        self.stats.peak_gather_bytes = max(
            self.stats.peak_gather_bytes, int(out.nbytes)
        )
        return out

    def on_append(self, cross: np.ndarray, square: np.ndarray) -> None:
        if self.band is None:
            return
        n_new = self.band.n + int(square.shape[0])
        if self.tier(n_new) != "banded":
            # an auto policy crossed out of the banded tier at the new K:
            # gather() will never read the band again — drop it instead of
            # memcpy-extending a dead buffer past the budget every admission
            self.band = None
            return
        self.band.extend(cross, square)

    def on_remove(self) -> None:
        self.band = None

    def fork(self) -> "StoreMemory":
        m = StoreMemory(self.policy)
        m.band = self.band.fork() if self.band is not None else None
        m.hot_rows = self.hot_rows
        m._op_seen = set(self._op_seen)
        return m
