"""Condensed upper-triangular float32 distance store.

The streaming cluster engine's persistent memory: ``K (K - 1) / 2`` unique
pairwise distances in *column-block* condensed layout — entries of column
``j`` (pairs ``(i, j)`` with ``i < j``) live contiguously at offset
``j (j - 1) / 2``.  Unlike the scipy row-major condensed convention,
admitting a batch of B newcomers is then a pure append — each newcomer
contributes one contiguous column block — so the store grows in amortized
O((M + B) * B) without rewriting seen-pair entries.  Departure compacts the
store (O(K^2), the rare path).

Storage itself is delegated to a **segmented backend**
(:mod:`repro_torch.core.engine.store_backends`): :class:`RamSegments` keeps the
flat vector in one growable RAM buffer (geometric capacity growth, so
appends stop recopying the whole vector), while :class:`SpilledSegments`
flushes cold column-range segments to an mmap'd spill file under a byte
budget and keeps only a hot tail in RAM — the ``spilled`` memory tier that
breaks the host-RAM wall at large K.  Both hold bitwise-identical float32
values, so the backend choice can never change labels.

Dense views (``dense()`` / ``rows()``) are materialized on demand for API
back-compat (``PACFLClustering.A``); they are transient — persistent state
stays condensed.  What the store may *cache* on top of the condensed vector
— and which backend holds the vector — is decided by a
:class:`~repro_torch.core.engine.memory.MemoryPolicy` (dense / banded /
condensed_only / spilled tiers, ``auto`` by a byte budget): the engine's
replay reads rows through :meth:`gather_rows`, which routes through the
policy, and :meth:`dense_ro` retains its ``(K, K)`` float32 cache only in
the ``dense`` tier.  See ``docs/ENGINE.md``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine.memory import MemoryPolicy, StoreMemory
from repro_torch.core.engine.store_backends import RamSegments, SpilledSegments
from repro_torch.core.hc import condensed_row_gather


def _tri(n):
    """Triangular count n(n-1)/2 — elementwise on ndarrays too."""
    return n * (n - 1) // 2


# Column-chunk size (in condensed entries) for streaming builds/compactions:
# bounds transient index/value tensors to ~8 MiB while staying large enough
# to amortize per-chunk backend bookkeeping.
_CHUNK_ENTRIES = 1 << 20


class CondensedDistances:
    """Growable/shrinkable condensed symmetric distance store (float32)."""

    def __init__(
        self,
        n: int = 0,
        values: np.ndarray | None = None,
        policy: Optional[MemoryPolicy] = None,
    ):
        self.n = int(n)
        need = _tri(self.n)
        if values is None:
            values = np.zeros(need, dtype=np.float32)
        values = np.asarray(values, dtype=np.float32)
        if values.size != need:
            raise ValueError(
                f"condensed store for n={self.n} needs {need} entries, "
                f"got {values.size}"
            )
        # Read-only float32 dense cache (see dense_ro): built lazily,
        # extended in place by append_block, dropped on remove — retained
        # only when the memory policy resolves to the "dense" tier.
        # Persistent state remains the condensed vector; banded /
        # condensed_only caching state lives in self.memory.
        self._dense32: np.ndarray | None = None
        self.memory = StoreMemory(policy)
        if self.memory.tier(self.n) == "spilled":
            # stream the caller's vector into the spilling backend in
            # column chunks so cold columns hit disk as they arrive
            self._backend = self._fresh_backend("spilled")
            for c0, c1, t0, t1 in self._column_chunks(self.n):
                self._backend.append(values[t0:t1], c1 - c0)
        else:
            self._backend = RamSegments.from_values(values, self.n)

    # -- backend plumbing ---------------------------------------------------

    def _fresh_backend(self, tier: str):
        """Empty backend of the kind the given tier wants."""
        p = self.memory.policy
        if tier == "spilled":
            return SpilledSegments(
                budget=p.budget,
                seg_cols=p.spill_segment_rows,
                spill_dir=p.spill_dir,
            )
        return RamSegments()

    def _sync_backend(self) -> None:
        """Migrate between backend kinds when an ``auto`` policy crosses the
        spill threshold at the current K (streamed segment by segment —
        never through a second full-RAM copy of the vector)."""
        tier = self.memory.tier(self.n)
        p = self.memory.policy
        if tier == "spilled" and not isinstance(self._backend, SpilledSegments):
            self._backend = SpilledSegments.from_backend(
                self._backend,
                budget=p.budget,
                seg_cols=p.spill_segment_rows,
                spill_dir=p.spill_dir,
            )
        elif tier != "spilled" and isinstance(self._backend, SpilledSegments):
            self._backend = RamSegments.from_backend(self._backend)

    @staticmethod
    def _column_chunks(n: int):
        """Yield ``(c0, c1, tri(c0), tri(c1))`` column ranges of bounded
        condensed size (~:data:`_CHUNK_ENTRIES` entries per range)."""
        c0 = 0
        while c0 < n:
            c1 = c0 + 1
            while c1 < n and _tri(c1 + 1) - _tri(c0) <= _CHUNK_ENTRIES:
                c1 += 1
            yield c0, c1, _tri(c0), _tri(c1)
            c0 = c1

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dense(
        cls, A: np.ndarray, policy: Optional[MemoryPolicy] = None
    ) -> "CondensedDistances":
        """Condense a symmetric (K, K) matrix (upper triangle is kept).

        Streams column chunks straight into the backend, so a spilling
        store never materializes the full flat vector in RAM.
        """
        A = np.asarray(A, dtype=np.float32)  # store dtype; cast once up front
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError("A must be square")
        st = cls(0, None, policy=policy)
        st.n = n
        st._backend = st._fresh_backend(st.memory.tier(n))
        for c0, c1, t0, t1 in cls._column_chunks(n):
            block = np.empty(t1 - t0, dtype=np.float32)
            off = 0
            for j in range(c0, c1):  # column slices beat a tril_indices gather
                block[off : off + j] = A[:j, j]
                off += j
            st._backend.append(block, c1 - c0)
        return st

    def copy(self) -> "CondensedDistances":
        st = CondensedDistances.__new__(CondensedDistances)
        st.n = self.n
        # fork semantics live in the backend: RAM forks copy the live
        # prefix; spilled forks share the mmap'd cold segments read-only
        # and diverge on append (each fork flushes its own new regions of
        # the shared append-only spill file)
        st._backend = self._backend.fork()
        st._dense32 = self._dense32  # read-only, safely shared across forks
        st.memory = self.memory.fork()
        return st

    # -- introspection ------------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Logical condensed bytes (4 * tri(K)) regardless of backend."""
        return self._backend.nbytes

    @property
    def resident_nbytes(self) -> int:
        """Store bytes actually held in RAM right now (hot tail + resident
        cold pages for a spilling backend; buffer capacity for RAM)."""
        return self._backend.resident_nbytes

    @property
    def spilled_nbytes(self) -> int:
        """Store bytes living in the spill file (0 for the RAM backend)."""
        return self._backend.spilled_nbytes

    @property
    def cold_segment_reads(self) -> int:
        """Cold-segment touches (0 for the RAM backend) — telemetry."""
        return getattr(self._backend, "cold_reads", 0)

    @property
    def values(self) -> np.ndarray:
        """The raw condensed vector (column-block order), read-only view.

        The read-only flag is set on a *fresh* view object, never on the
        backing buffer — handing out this property can't poison later
        in-place writes through the store or its forks.  On a spilling
        backend this materializes the full vector (sanitize rule S4 flags
        that outside ``allow_dense()`` while armed).
        """
        v = self._backend.materialize().view()
        v.flags.writeable = False
        return v

    def condensed_source(self):
        """Flat condensed read source for segment-aware consumers
        (:func:`repro_torch.core.hc.condensed_row_gather`,
        :class:`repro_torch.core.hc.CondensedWorkingMatrix`): the raw ndarray for
        a RAM backend, the backend itself (``gather_flat``/``segments``)
        when spilling — so bootstrap reads fault at most one cold segment
        at a time instead of materializing the vector."""
        return self._backend.reader()

    def get(self, i: int, j: int) -> float:
        if i == j:
            return 0.0
        lo, hi = (i, j) if i < j else (j, i)
        return self._backend.get_flat(_tri(hi) + lo)

    # -- dense views --------------------------------------------------------

    def dense(self, dtype=np.float32) -> np.ndarray:
        """Materialize the full symmetric (K, K) matrix (transient)."""
        n = self.n
        out = np.zeros((n, n), dtype=dtype)
        for seg in self._backend.segments():
            v = seg.values
            for j in range(seg.col0, seg.col1):  # cheap slice writes
                col = v[_tri(j) - seg.base : _tri(j) - seg.base + j]
                out[:j, j] = col
                out[j, :j] = col
        return out

    @property
    def cache_enabled(self) -> bool:
        """True when the memory policy resolves to the ``dense`` tier at the
        current K — i.e. :meth:`dense_ro` is allowed to retain its cache."""
        return self.memory.tier(self.n) == "dense"

    def dense_ro(self) -> np.ndarray:
        """Read-only float32 dense view — the ``dense`` policy tier.

        Unlike :meth:`dense` (a fresh mutable transient the HC merge loop is
        allowed to consume), this view is shared between engine forks and
        dropped on ``remove``.  ``append_block`` keeps it in sync by
        building a fresh array from one contiguous memcpy of the old matrix
        plus the new blocks — still O(K^2) bytes moved per admission, but a
        plain memcpy instead of the ~5x-slower strided per-column rebuild,
        and deliberately never in place: the old array stays immutable, so
        forks sharing it can admit independently without corrupting each
        other.  The engine's replay seeds promotion vectors from the view.

        Under the ``banded`` / ``condensed_only`` / ``spilled`` tiers the
        view is built fresh each call and NOT retained — dense memory stays
        transient.  (Policy-aware consumers should prefer
        :meth:`gather_rows`, which never materializes (K, K) outside the
        dense tier.)
        """
        if self._dense32 is None:
            d = self.dense(np.float32)  # repro-lint: ignore[R3]  # port of src/repro/core/engine/store.py, allowlisted there
            d.flags.writeable = False
            if not self.cache_enabled:
                return d
            self._dense32 = d
        return self._dense32

    def drop_dense_cache(self) -> None:
        """Release the cached dense view (it rebuilds lazily if re-needed)."""
        self._dense32 = None

    @property
    def has_dense_cache(self) -> bool:
        return self._dense32 is not None

    def rows(self, idx: np.ndarray, dtype=np.float64) -> np.ndarray:
        """Gather full rows ``(len(idx), K)`` without densifying everything.

        The engine's replay uses this to seed distance vectors for dirty
        clusters (newcomers already have theirs from the admission blocks;
        orphans and absorbed clean clusters aggregate over these rows).
        One shared strided-gather implementation
        (:func:`repro_torch.core.hc.condensed_row_gather`) serves this and the
        HC working matrix, so the two can never drift.  On a spilling
        backend the gather walks cold segments one at a time under the
        residency budget.
        """
        return condensed_row_gather(
            self._backend.reader(), self.n, idx, diag_fill=0.0, dtype=dtype
        )

    def gather_rows(self, idx: np.ndarray, promote: bool = True) -> np.ndarray:
        """Policy-routed row gather — the engine-facing read path.

        Returns ``(len(idx), K)`` float64 rows (exact float32 upcasts, so
        every tier returns bitwise-identical values).  The resolved tier
        decides where they come from: the retained dense cache (``dense``,
        with the adaptive K/8 densify threshold), the LRU banded row cache
        (``banded``), or strided condensed gathers (``condensed_only`` /
        ``spilled`` — the latter through mmap'd cold segments).
        ``promote=False`` marks a streaming full-matrix scan that must not
        evict the hot band.
        """
        return self.memory.gather(self, idx, promote=promote)

    # -- mutation -----------------------------------------------------------

    def append_block(self, cross: np.ndarray, square: np.ndarray) -> None:
        """Admit B newcomers: ``cross`` is (M, B) seen-vs-new distances,
        ``square`` the (B, B) symmetric new-vs-new block (zero diagonal).

        Appends B contiguous column blocks *into the backend's tail* —
        amortized O(B * K) per admit (geometric capacity growth in RAM, a
        hot-tail write when spilling); seen-pair entries are untouched and
        never recopied.
        """
        M, B = self.n, int(square.shape[0])
        cross = np.asarray(cross, dtype=np.float32)
        square = np.asarray(square, dtype=np.float32)
        if cross.shape != (M, B):
            raise ValueError(
                f"cross block must be (M, B) = ({M}, {B}), got {cross.shape}"
            )
        if square.shape != (B, B):
            raise ValueError("square block must be (B, B)")
        block = np.empty(_tri(M + B) - _tri(M), dtype=np.float32)
        off = 0
        for b in range(B):
            block[off : off + M] = cross[:, b]
            block[off + M : off + M + b] = square[:b, b]
            off += M + b
        self._backend.append(block, B)
        self.n = M + B
        self._sync_backend()
        self.memory.on_append(cross, square)
        if self._dense32 is not None and self.cache_enabled:
            d = np.zeros((self.n, self.n), dtype=np.float32)
            d[:M, :M] = self._dense32
            d[:M, M:] = cross
            d[M:, :M] = cross.T
            d[M:, M:] = square
            d.flags.writeable = False
            self._dense32 = d
        elif self._dense32 is not None:
            # an auto policy crossed its byte budget at the new K: demote —
            # drop the dense cache instead of growing it past the budget
            self._dense32 = None

    def remove(self, idx: np.ndarray) -> np.ndarray:
        """Depart clients ``idx``: drop their rows/columns, compact.

        Compacts the condensed column blocks segment by segment: surviving
        column ``j`` (new index ``jj``) keeps exactly its old entries at the
        surviving ``i < j``, which in column-block layout is one gather at
        ``tri(j) + keep[:jj]``.  The gather runs in bounded column chunks
        appended to a fresh backend, so peak memory is O(chunk) plus the
        surviving store — never the dense (K, K) matrix an earlier revision
        materialized here, and on a spilling backend never more than one
        cold segment past the residency budget.

        Returns the sorted array of surviving leaf ids (old numbering), in
        the order they occupy the compacted store.
        """
        idx = np.unique(np.asarray(idx, dtype=np.int64))
        if idx.size and (idx[0] < 0 or idx[-1] >= self.n):
            raise IndexError("departing ids out of range")
        self._dense32 = None
        self.memory.on_remove()
        keep = np.setdiff1d(np.arange(self.n, dtype=np.int64), idx)
        m = int(keep.size)
        new_backend = self._fresh_backend(self.memory.tier(m))
        # flat target t in the new vector lives in column jj = col_of[t] at
        # row position pos_in_col[t]; its source pair is (keep[pos], keep[jj])
        # with keep sorted, so keep[pos] < keep[jj] always holds.
        for c0, c1, t0, t1 in self._column_chunks(m):
            cols = np.arange(c0, c1, dtype=np.int64)
            col_of = np.repeat(cols, cols)
            pos_in_col = np.arange(t0, t1, dtype=np.int64) - _tri(col_of)
            src = _tri(keep[col_of]) + keep[pos_in_col]
            new_backend.append(self._backend.gather_flat(src), c1 - c0)
        self._backend = new_backend
        self.n = m
        return keep
