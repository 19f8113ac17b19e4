"""Stateful streaming cluster-membership engine.

The pre-engine lifecycle was batch-synchronous: every newcomer batch went
``pme.assign_newcomers`` -> assemble a dense ``(M+B, M+B)`` float64 matrix ->
``hierarchical_clustering`` from scratch — the "re-cluster-the-world step".
:class:`ClusterEngine` replaces it with a living structure that owns

* the stacked signatures ``U`` (K, n, p),
* a condensed upper-triangular float32 distance store
  (:class:`repro_torch.core.engine.store.CondensedDistances` — half the dense
  footprint, pure-append admission),
* the cached dendrogram *merge script* of the last clustering, replayable
  incrementally (:mod:`repro_torch.core.engine.dendrogram`),
* stable client ids and cluster labels that survive admissions and
  departures.

``admit(U_new)`` costs the O((M+B) * B) proximity blocks plus near-O(B * K)
dendrogram maintenance (clean script runs fold *en bloc* — see the
dendrogram module); ``depart(ids)`` is the symmetric delete — a scenario
the batch API could not express at all; ``move(ids, U_new)`` is the fused
composition for *drifted* clients (signature refresh): tombstoned depart
and dirty-singleton re-admission in a single replay pass, with the movers
keeping their stable client ids.  All reproduce the labels a full
re-clustering of the current distance matrix would produce (oracle-checked
up to degenerate distance ties; see the dendrogram module docstring).
Server memory is governed by a tiered policy
(:class:`~repro_torch.core.engine.memory.MemoryPolicy`, via
``EngineConfig.memory``): a persistent dense float32 mirror, an LRU banded
hot-row window, or condensed-only — bitwise-identical labels under every
tier.  In the dense tier, steady-state admission streams can
:meth:`ClusterEngine.warm_cache` the store's read-only dense view once —
``admit`` keeps it in sync thereafter; the banded window warms itself from
the replay's gathers.

``PACFLClustering`` (:mod:`repro_torch.core.pacfl`) is a thin view over this
engine; ``pme.assign_newcomers`` delegates to ``admit``; the FL layer
consumes :meth:`membership` snapshots for mid-federation churn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.core.angles import proximity_matrix
from repro_torch.core.engine.dendrogram import (
    Merge,
    ReplayStats,
    filter_script_for_depart,
    replay,
)
from repro_torch.core.engine.memory import MemoryPolicy
from repro_torch.core.engine.sanitize import allow_dense
from repro_torch.core.engine.store import CondensedDistances
from repro_torch.core.hc import CondensedWorkingMatrix, labels_from_members, merge_forest


@dataclass(frozen=True)
class EngineConfig:
    """Clustering criterion + proximity + memory knobs the engine needs.

    Parameters
    ----------
    beta: HC distance threshold in **degrees** (default 10.0) — merging
        stops once the closest pair is farther apart.  Ignored when
        ``n_clusters`` is set.
    n_clusters: fixed cluster count; overrides ``beta`` exactly as in the
        one-shot phase.  Default ``None`` (threshold mode).
    measure: ``"eq3"`` (default) | ``"eq2"`` — the paper's two
        principal-angle measures.
    linkage: ``"average"`` (default) | ``"single"`` | ``"complete"``.
    backend / block_size: forwarded to
        :func:`repro_torch.core.angles.proximity_matrix` / ``cross_proximity``
        for the admission blocks (defaults: backend ``"auto"``,
        block_size ``None`` = the backend's tuned tile edge).
    memory: distance-store memory policy mode — ``"auto"`` (default) |
        ``"dense"`` | ``"banded"`` | ``"condensed_only"`` | ``"spilled"``;
        see :class:`repro_torch.core.engine.memory.MemoryPolicy`.  All modes
        produce bitwise-identical labels; they trade cache memory against
        steady-state admission latency.
    memory_budget_bytes: ``auto``-mode cache byte budget (default ``None``
        = 256 MiB); in the ``spilled`` tier it also bounds the store's
        resident bytes.
    band_rows: banded-tier window height in rows (default 512).
    spill_dir: directory for the ``spilled`` tier's segment file (default
        ``None`` = system temp dir).
    spill_segment_rows: columns per cold segment the ``spilled`` tier
        flushes (default 1024).
    dense_cache: legacy opt-out (PR 4's knob).  ``False`` with the default
        ``memory="auto"`` forces the ``condensed_only`` tier — no
        persistent dense cache, exactly the old opt-out guarantee.
        Ignored when ``memory`` is set explicitly.
    """

    beta: float = 10.0
    n_clusters: Optional[int] = None
    measure: str = "eq3"
    linkage: str = "average"
    backend: str = "auto"
    block_size: Optional[int] = None
    dense_cache: bool = True
    memory: str = "auto"
    memory_budget_bytes: Optional[int] = None
    band_rows: int = 512
    spill_dir: Optional[str] = None
    spill_segment_rows: int = 1024

    def memory_policy(self) -> MemoryPolicy:
        """The :class:`MemoryPolicy` this config resolves to."""
        mode = self.memory
        if mode == "auto" and not self.dense_cache:
            mode = "condensed_only"
        return MemoryPolicy(
            mode=mode,
            byte_budget=self.memory_budget_bytes,
            band_rows=self.band_rows,
            spill_dir=self.spill_dir,
            spill_segment_rows=self.spill_segment_rows,
        )


@dataclass
class MembershipSnapshot:
    """Immutable view of the engine's membership at one version."""

    version: int
    ids: np.ndarray       # (K,) stable client ids
    labels: np.ndarray    # (K,) stable cluster labels

    def label_of(self, client_id: int) -> int:
        hit = np.where(self.ids == client_id)[0]
        if not hit.size:
            raise KeyError(f"client id {client_id} not in engine")
        return int(self.labels[hit[0]])


@dataclass
class AdmitResult:
    """Outcome of one (possibly batched) admission.

    ``canonical`` carries the full-re-cluster-parity labels: bitwise what a
    from-scratch :func:`~repro_torch.core.angles.proximity_matrix` + HC run on the
    post-admission roster would produce (degenerate-tie caveats aside).
    """

    ids: np.ndarray               # (B,) stable ids assigned to the newcomers
    labels: np.ndarray            # (K,) stable labels after admission
    newcomer_labels: np.ndarray   # (B,)
    new_cluster: np.ndarray       # (B,) bool — newcomer formed a new cluster
    canonical: np.ndarray         # (K,) full-re-cluster-parity labels
    stats: ReplayStats


@dataclass
class DepartResult:
    """Outcome of one (possibly batched) departure.

    ``canonical`` is full-re-cluster parity for the surviving roster: bitwise
    the labels a from-scratch run over the survivors would produce.
    """

    departed: np.ndarray          # stable ids removed
    labels: np.ndarray            # (K',) stable labels of the survivors
    canonical: np.ndarray         # (K',) full-re-cluster-parity labels
    stats: ReplayStats


@dataclass
class MoveResult:
    """Outcome of one fused signature-refresh move (:meth:`ClusterEngine.move`).

    The movers keep their stable **client** ids (same client, refreshed
    signature); their *cluster* labels may change — that is the point.
    ``canonical`` carries the usual full-re-cluster-parity guarantee for the
    post-move roster.  ``changed`` flags movers whose stable cluster label
    differs from their pre-move one — the drifted clients that actually
    migrated.
    """

    moved: np.ndarray             # (B,) stable ids whose signatures moved
    labels: np.ndarray            # (K,) stable labels after the move
    moved_labels: np.ndarray      # (B,) stable labels of the movers
    changed: np.ndarray           # (B,) bool — mover's cluster label changed
    new_cluster: np.ndarray       # (B,) bool — mover landed in a fresh cluster
    canonical: np.ndarray         # (K,) full-re-cluster-parity labels
    stats: ReplayStats


class ClusterEngine:
    """Owns signatures + condensed distances + the incremental dendrogram."""

    def __init__(self, config: EngineConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.U: Optional[torch.Tensor] = None
        self.store = CondensedDistances(0, policy=config.memory_policy())
        self.ids = np.zeros(0, dtype=np.int64)
        self._next_id = 0
        self._script: list[Merge] = []
        self._canonical = np.zeros(0, dtype=np.int64)
        self._stable = np.zeros(0, dtype=np.int64)
        self.version = 0
        self.last_stats: Optional[ReplayStats] = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_signatures(
        cls, U_stack: torch.Tensor, config: EngineConfig, *, device: DeviceLike = None
    ) -> "ClusterEngine":
        """One-shot phase: proximity matrix + HC, with the script cached.

        ``U_stack`` moves to ``device`` (default ``"cuda"``), where the
        engine keeps its signatures and computes its proximity blocks.
        """
        eng = cls(config, device)
        U = as_f32(U_stack, eng.device)
        A = proximity_matrix(
            U,
            measure=config.measure,
            backend=config.backend,
            block_size=config.block_size,
        ).cpu().numpy()
        eng._bootstrap(A, U)
        return eng

    @classmethod
    def from_proximity(
        cls,
        A: np.ndarray,
        U_stack: torch.Tensor,
        config: EngineConfig,
        *,
        device: DeviceLike = None,
    ) -> "ClusterEngine":
        """Adopt an existing proximity matrix (upper triangle is kept)."""
        eng = cls(config, device)
        eng._bootstrap(np.asarray(A, dtype=np.float32), as_f32(U_stack, eng.device))
        return eng

    def _bootstrap(self, A: np.ndarray, U_stack: torch.Tensor) -> None:
        K = int(A.shape[0])
        if U_stack.shape[0] != K:
            raise ValueError("A and U_stack disagree on the client count")
        self.store = CondensedDistances.from_dense(
            A, policy=self.config.memory_policy()
        )
        self.U = U_stack
        self.ids = np.arange(K, dtype=np.int64)
        self._next_id = K
        self.store.memory.begin_op(self.store)
        # Bootstrap working matrix: the dense tier runs the merge loop on a
        # transient (K, K) float64 (fastest); the other tiers run the
        # (K, K)-free strided path on a condensed float64 working vector —
        # half the dense float64 footprint, bitwise-identical merges.  The
        # vector is built from the store's segment-aware condensed source,
        # so a spilled store streams it one cold segment at a time instead
        # of materializing the full float32 vector first.
        if self.store.cache_enabled:
            work = self.store.dense(np.float64)  # repro-lint: ignore[R3]  # port of src/repro/core/engine/engine.py, allowlisted there
        else:
            work = CondensedWorkingMatrix(self.store.condensed_source(), K)
        active, members, merges = merge_forest(
            work,
            np.ones(K, dtype=np.int64),
            [[i] for i in range(K)],
            **self._criterion(),
        )
        self._script = merges
        self._canonical = labels_from_members(active, members, K)
        self._stable = self._canonical.copy()
        self.last_stats = None
        self.version += 1

    # -- views --------------------------------------------------------------

    @property
    def n_clients(self) -> int:
        return self.store.n

    @property
    def labels(self) -> np.ndarray:
        """Stable labels (old cluster identities preserved across churn)."""
        return self._stable

    @property
    def canonical_labels(self) -> np.ndarray:
        """Labels as a from-scratch re-clustering would produce them."""
        return self._canonical

    @property
    def n_clusters(self) -> int:
        return int(np.unique(self._stable).size) if self._stable.size else 0

    def dense(self, dtype=np.float32) -> np.ndarray:
        """Transient dense view of the condensed store (API back-compat).

        The caller explicitly asked for (K, K) memory, so this is a
        sanitizer-sanctioned dense materialization on every tier.
        """
        with allow_dense():
            return self.store.dense(dtype)  # repro-lint: ignore[R3]  # port of src/repro/core/engine/engine.py, allowlisted there

    def warm_cache(self) -> None:
        """Build the store's read-only dense float32 cache now (dense tier).

        Replay seeds promotion vectors from this cache; without warming it
        is built lazily on the first admission whose promotions cascade,
        and ``append_block`` then keeps it in sync (one contiguous memcpy
        per admission instead of the much slower strided per-column
        rebuild).  Copies made *after* warming share the cache (a fork
        snapshots the cache reference at copy time).
        Departures drop it (it rebuilds lazily).  Costs one (K, K) float32
        alongside the condensed store — a no-op unless the engine's memory
        policy resolves to the ``dense`` tier at the current K; under
        ``banded`` the hot-row window warms itself from the replay's
        gathers instead (see :class:`repro_torch.core.engine.memory.MemoryPolicy`
        and ``docs/ENGINE.md``).
        """
        if self.store.cache_enabled:
            self.store.dense_ro()  # repro-lint: ignore[R3]  # port of src/repro/core/engine/engine.py, allowlisted there

    def membership(self) -> MembershipSnapshot:
        return MembershipSnapshot(
            self.version, self.ids.copy(), self._stable.copy()
        )

    def copy(self) -> "ClusterEngine":
        """Independent fork (signature stacks are shared: the engine never
        writes into ``U`` in place, it rebinds it)."""
        eng = ClusterEngine(self.config, self.device)
        eng.U = self.U
        eng.store = self.store.copy()
        eng.ids = self.ids.copy()
        eng._next_id = self._next_id
        eng._script = list(self._script)
        eng._canonical = self._canonical.copy()
        eng._stable = self._stable.copy()
        eng.version = self.version
        return eng

    def _criterion(self) -> dict:
        if self.config.n_clusters is not None:
            return {
                "n_clusters": self.config.n_clusters,
                "linkage": self.config.linkage,
            }
        return {"beta": self.config.beta, "linkage": self.config.linkage}

    # -- streaming ops ------------------------------------------------------

    def admit(self, U_new: torch.Tensor) -> AdmitResult:
        """Fold B newcomers into the membership (Algorithms 2+3, streaming).

        ``U_new`` is the (B, n, p) stack of newcomer signatures (B >= 1).
        Computes only the (M, B) cross and (B, B) square proximity blocks
        (degrees, via the config's measure/backend), appends them to the
        condensed store, and replays the cached dendrogram with the
        newcomers as dirty singletons — near-O(B * K) instead of the
        O(K^2) re-cluster.

        Parity guarantee: the resulting ``canonical`` labels equal a full
        re-clustering of the current distance store (oracle-exact up to the
        degenerate-tie caveats in ``docs/ENGINE.md``), independent of batch
        split, en-bloc folding, and the store's memory tier — all pinned
        bitwise by the test suites.  ``labels`` additionally keeps seen
        clients' stable ids.  Admission is in-place; use
        :meth:`copy`/``PACFLClustering.extend`` for a fork.
        """
        from repro_torch.core.pme import remap_onto_old_ids

        U_new = as_f32(U_new, self.device)
        B = int(U_new.shape[0])
        if B == 0:
            raise ValueError("admit needs at least one newcomer")
        M = self.store.n
        cfg = self.config
        if M == 0:
            nid0, ver0 = self._next_id, self.version
            eng = ClusterEngine.from_signatures(U_new, cfg, device=self.device)
            self.__dict__.update(eng.__dict__)
            # stable ids / version continue from the pre-churn lineage
            self.ids = np.arange(nid0, nid0 + B, dtype=np.int64)
            self._next_id = nid0 + B
            self.version = ver0 + 1
            stats = ReplayStats()
            self.last_stats = stats
            return AdmitResult(
                ids=self.ids.copy(),
                labels=self._stable.copy(),
                newcomer_labels=self._stable.copy(),
                new_cluster=np.ones(B, dtype=bool),
                canonical=self._canonical.copy(),
                stats=stats,
            )
        from repro_torch.core.pme import proximity_blocks

        cross, square = proximity_blocks(
            self.U, U_new,
            measure=cfg.measure, backend=cfg.backend, block_size=cfg.block_size,
        )
        self.store.append_block(cross, square)
        self.U = torch.cat([self.U, U_new.to(self.U.dtype)], dim=0)
        new_ids = np.arange(self._next_id, self._next_id + B, dtype=np.int64)
        self._next_id += B
        self.ids = np.concatenate([self.ids, new_ids])

        canonical, script, stats = replay(
            self.store,
            self._script,
            [[M + t] for t in range(B)],
            **self._criterion(),
        )
        old_stable = self._stable
        stable = remap_onto_old_ids(canonical, old_stable, M)
        self._canonical = canonical
        self._stable = stable
        self._script = script
        self.last_stats = stats
        self.version += 1
        seen = set(stable[:M].tolist())
        newcomer_labels = stable[M:]
        return AdmitResult(
            ids=new_ids,
            labels=stable.copy(),
            newcomer_labels=newcomer_labels.copy(),
            new_cluster=np.array(
                [l not in seen for l in newcomer_labels], dtype=bool
            ),
            canonical=canonical.copy(),
            stats=stats,
        )

    def depart(self, client_ids: np.ndarray) -> DepartResult:
        """Remove clients (churn) — the symmetric delete to :meth:`admit`.

        ``client_ids`` are **stable** engine ids (``engine.ids``, equal to
        row position until the first departure); unknown ids raise
        ``KeyError``.  Drops their rows from the condensed store (O(K^2)
        compaction, the rare path), splits the cached script (merges whose
        subtree contained a departed client are dropped; the surviving
        sides become dirty orphans via tombstones) and replays.  The same
        oracle-parity guarantee as :meth:`admit` applies: ``canonical``
        equals a full re-clustering of the surviving store, under every
        memory tier.
        """
        from repro_torch.core.pme import remap_onto_old_ids

        client_ids = np.atleast_1d(np.asarray(client_ids, dtype=np.int64))
        pos = np.where(np.isin(self.ids, client_ids))[0]
        if pos.size != np.unique(client_ids).size:
            missing = np.setdiff1d(client_ids, self.ids)
            raise KeyError(f"unknown client ids: {missing.tolist()}")
        K = self.store.n
        departed_ids = self.ids[pos].copy()
        if pos.size == K:  # everyone leaves
            cfg = self.config
            nid, ver = self._next_id, self.version
            self.__init__(cfg, self.device)
            # stable ids / version continue from the pre-churn lineage,
            # mirroring the admit-into-empty path
            self._next_id = nid
            self.version = ver + 1
            stats = ReplayStats()
            self.last_stats = stats
            return DepartResult(
                departed=departed_ids,
                labels=self._stable.copy(),
                canonical=self._canonical.copy(),
                stats=stats,
            )
        kept_script = filter_script_for_depart(self._script, K, pos)
        keep = self.store.remove(pos)
        inv = np.full(K, -1, dtype=np.int64)
        inv[keep] = np.arange(keep.size, dtype=np.int64)
        script_new = [
            (int(inv[a]), int(inv[b]) if b >= 0 else -1, h)
            for a, b, h in kept_script
        ]
        self.U = self.U[torch.as_tensor(keep, device=self.device)]
        old_stable = self._stable[keep]
        self.ids = self.ids[keep]

        canonical, script, stats = replay(
            self.store, script_new, [], **self._criterion()
        )
        stable = remap_onto_old_ids(canonical, old_stable, self.store.n)
        self._canonical = canonical
        self._stable = stable
        self._script = script
        self.last_stats = stats
        self.version += 1
        return DepartResult(
            departed=departed_ids,
            labels=stable.copy(),
            canonical=canonical.copy(),
            stats=stats,
        )

    def move(self, client_ids: np.ndarray, U_new: torch.Tensor) -> MoveResult:
        """Fused depart+admit: migrate drifted clients in ONE replay pass.

        ``client_ids`` are stable engine ids whose signatures have drifted;
        ``U_new[t]`` is the refreshed (n, p) signature of ``client_ids[t]``.
        The sequential schedule (``depart(ids)`` then ``admit(U_new)``) pays
        two full script replays and two stable-label remaps; the fused move
        exploits that :func:`~repro_torch.core.engine.dendrogram.replay` natively
        handles a tombstoned script AND dirty singletons *simultaneously*:
        the movers' old rows are tombstoned out of the script
        (:func:`filter_script_for_depart`) and their refreshed signatures
        re-enter as dirty singletons in the same pass — one store
        compaction, one cross-block append, one replay, one remap, one
        version bump.

        Parity: the final distance store is bitwise the sequential
        schedule's (same survivors, same refreshed cross blocks), so
        ``canonical`` labels equal both the sequential depart-then-admit
        result and a full re-clustering of the post-move store — under
        every memory tier (gated in ``--quick`` CI and the fuzz suite).
        Stable *cluster* labels are remapped against the pre-move
        partition, so a mover whose refreshed signature still belongs to
        its old cluster keeps that cluster's label and its model; unlike
        the sequential schedule, the movers also keep their stable
        *client* ids (same client, new signature).
        """
        from repro_torch.core.pme import proximity_blocks, remap_onto_old_ids

        client_ids = np.atleast_1d(np.asarray(client_ids, dtype=np.int64))
        U_new = as_f32(U_new, self.device)
        B = int(client_ids.size)
        if B == 0:
            raise ValueError("move needs at least one client")
        if np.unique(client_ids).size != B:
            raise ValueError("duplicate client ids in move")
        if int(U_new.shape[0]) != B:
            raise ValueError(
                f"U_new has {int(U_new.shape[0])} signatures for {B} clients"
            )
        id_pos = {int(c): p for p, c in enumerate(self.ids)}
        missing = [int(c) for c in client_ids if int(c) not in id_pos]
        if missing:
            raise KeyError(f"unknown client ids: {missing}")
        pos = np.array([id_pos[int(c)] for c in client_ids], dtype=np.int64)
        K = self.store.n
        prev_labels = self._stable[pos].copy()
        cfg = self.config
        if B == K:  # whole-roster refresh: re-bootstrap, keeping id lineage
            nid, ver = self._next_id, self.version
            eng = ClusterEngine.from_signatures(U_new, cfg, device=self.device)
            self.__dict__.update(eng.__dict__)
            self.ids = client_ids.copy()
            self._next_id = nid
            self.version = ver + 1
            stats = ReplayStats()
            self.last_stats = stats
            moved_labels = self._stable.copy()
            return MoveResult(
                moved=client_ids.copy(),
                labels=self._stable.copy(),
                moved_labels=moved_labels,
                changed=moved_labels != prev_labels,
                new_cluster=np.ones(B, dtype=bool),
                canonical=self._canonical.copy(),
                stats=stats,
            )
        kept_script = filter_script_for_depart(self._script, K, pos)
        keep = self.store.remove(np.sort(pos))
        inv = np.full(K, -1, dtype=np.int64)
        inv[keep] = np.arange(keep.size, dtype=np.int64)
        script_new = [
            (int(inv[a]), int(inv[b]) if b >= 0 else -1, h)
            for a, b, h in kept_script
        ]
        M = int(keep.size)
        U_keep = self.U[torch.as_tensor(keep, device=self.device)]
        cross, square = proximity_blocks(
            U_keep, U_new,
            measure=cfg.measure, backend=cfg.backend, block_size=cfg.block_size,
        )
        self.store.append_block(cross, square)
        self.U = torch.cat([U_keep, U_new.to(U_keep.dtype)], dim=0)
        old_stable = self._stable[keep]
        # movers keep their stable client ids, re-entering at tail positions
        self.ids = np.concatenate([self.ids[keep], client_ids])

        canonical, script, stats = replay(
            self.store,
            script_new,
            [[M + t] for t in range(B)],
            **self._criterion(),
        )
        stable = remap_onto_old_ids(canonical, old_stable, M)
        self._canonical = canonical
        self._stable = stable
        self._script = script
        self.last_stats = stats
        self.version += 1
        moved_labels = stable[M:]
        seen = set(stable[:M].tolist())
        return MoveResult(
            moved=client_ids.copy(),
            labels=stable.copy(),
            moved_labels=moved_labels.copy(),
            changed=moved_labels != prev_labels,
            new_cluster=np.array(
                [l not in seen for l in moved_labels], dtype=bool
            ),
            canonical=canonical.copy(),
            stats=stats,
        )
