"""Membership-as-a-service: snapshot-isolated, batched assignment serving.

Port of ``repro.serving.server``.  Queries and representatives are torch
tensors on the engine's device, where the cross proximity kernel scores
them (its plain twin on the CPU); labels come back as NumPy.

:class:`AssignmentServer` splits the engine into the two production roles:

* **Read path** (``assign`` / ``assign_many``): answer "which cluster model
  should this client pull?" in O(C) — one
  :func:`~repro_torch.serving.dispatch.serve_assign` call against the
  :class:`~repro_torch.serving.representatives.RepresentativeCache` stack, with
  concurrent queries micro-batched through the power-of-two shape buckets
  and exactly **one** host readback per dispatched batch.
* **Write path** (``submit_join`` / ``submit_leave`` / ``drain``): churn
  flows through a :class:`~repro_torch.fl.churn.ChurnQueue` and is applied to the
  live engine only at drain time, in arrival order, honoring the
  :class:`~repro_torch.fl.churn.DrainPolicy` (batch sizing, and the
  availability-aware ``deadline_s`` / ``priority_departures`` knobs that
  bound write-path staleness).

**Snapshot isolation.**  Queries never touch the live engine: they run
against a read-only :meth:`ClusterEngine.copy` fork captured in a frozen
:class:`ServingSnapshot`.  The fork shares the warm dense/banded store
cache (``store.copy`` shares the read-only mirror), so a snapshot costs one
condensed-vector memcpy, not a recompute.  When a drain commits, the server
forks the post-drain engine, refreshes the representative cache
incrementally, and **epoch-swaps**: ``snapshot`` now returns the new epoch
while any in-flight reader holding the old :class:`ServingSnapshot` keeps
getting answers consistent with the pre-drain membership — the old fork is
immutable and stays valid until the last reference drops.

Parity contract (gated in ``benchmarks/proximity_scale.py``): on clustered
data, a batched served assignment is **bitwise** the label that admitting
the same query one-by-one through ``engine.admit`` on a throwaway fork
would assign (``admit_oracle`` below is that ground truth), with
``distance > beta`` mapping to the admit path's new-cluster outcome.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.fl.churn import ChurnQueue
from repro_torch.serving.dispatch import serve_assign
from repro_torch.serving.representatives import RepresentativeCache


@dataclass(frozen=True)
class ServingSnapshot:
    """One epoch's immutable read state: engine fork + representative stack.

    ``engine`` is a read-only fork — mutating it voids the isolation
    guarantee; all writes go through the server's queue.  ``beta`` is the
    assignment threshold in degrees (``None`` in fixed-``n_clusters`` mode,
    where no query ever opens a new cluster).
    """

    epoch: int
    engine: Any                      # read-only ClusterEngine fork
    rep_stack: Optional[torch.Tensor]  # (C, n, p), None when no clusters
    rep_labels: np.ndarray           # (C,) stable labels, stack-aligned
    beta: Optional[float]


@dataclass(frozen=True)
class AssignmentResult:
    """Batched assignment answer, all host-side numpy.

    ``labels[i]`` is the stable cluster label serving query ``i``, or -1
    where ``new_cluster[i]`` — the query sits farther than ``beta`` from
    every representative, i.e. the admit path would open a new cluster for
    it.  ``distances`` are degrees to the nearest representative.
    """

    labels: np.ndarray       # (B,) int64
    distances: np.ndarray    # (B,) float64 degrees
    new_cluster: np.ndarray  # (B,) bool
    epoch: int


@dataclass(frozen=True)
class DrainReport:
    """What one ``drain`` applied and where that left the queue."""

    epoch: int
    batches: int
    joins: int
    leaves: int
    pending: int


class AssignmentServer:
    """Batched O(C) assignment over snapshot-isolated engine forks.

    Parameters
    ----------
    engine: the live (write-side) :class:`ClusterEngine`.  The server owns
        churn application to it; apply external mutations only between
        ``drain`` calls, then call ``refresh_snapshot``.
    representative: ``"medoid"`` (default; the parity-gated kind) or
        ``"centroid"`` — see :mod:`repro_torch.serving.representatives`.
    queue: an existing :class:`ChurnQueue` (e.g. one whose ``signature_fn``
        maps FL client payloads); default is a queue accepting (n, p)
        signature arrays directly.
    batch_max: micro-batch cap — larger query stacks are split into
        ``batch_max`` chunks, each one dispatch + one host readback.
    eq2_solver: forwarded to the measure core when the engine's measure is
        eq2.
    """

    def __init__(
        self,
        engine,
        *,
        representative: str = "medoid",
        queue: Optional[ChurnQueue] = None,
        batch_max: int = 128,
        eq2_solver: str = "jacobi",
    ):
        if batch_max < 1:
            raise ValueError("batch_max must be >= 1")
        self._write = engine
        self.queue = (
            queue if queue is not None else ChurnQueue(signature_fn=torch.as_tensor)
        )
        self.batch_max = int(batch_max)
        self.eq2_solver = eq2_solver
        self.reps = RepresentativeCache(kind=representative)
        # Projected membership: live ids plus queued-but-undrained churn, in
        # arrival order.  Lets submit_leave translate a stable client id to
        # the queue's sequential-position contract, and predicts the stable
        # id a queued join will get (admits preserve arrival order, so the
        # engine assigns _next_id + k to the k-th queued join).
        self._projected: list[int] = [int(i) for i in engine.ids]
        self._projected_next: int = int(engine._next_id)
        self._epoch = -1
        self._snapshot: Optional[ServingSnapshot] = None
        self._commit()

    # -- read path ----------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def snapshot(self) -> ServingSnapshot:
        """The current epoch's read state (hold it for a consistent view
        across multiple ``assign`` calls spanning a drain)."""
        return self._snapshot

    def assign(
        self, U_queries, *, snapshot: Optional[ServingSnapshot] = None
    ) -> AssignmentResult:
        """Assign a same-shape query stack to clusters.

        ``U_queries`` is (B, n, p) (a single (n, p) query is promoted to
        B=1).  Chunks of ``batch_max`` go through the pow2-bucketed dispatch;
        per chunk there is exactly one device->host readback.  Pass a held
        ``snapshot`` to pin the epoch; default is the current one.

        Parity: labels are bitwise-stable for a fixed snapshot — identical
        across batch splits and repeated calls (see the module docstring
        for the admit-parity contract).
        """
        snap = self._snapshot if snapshot is None else snapshot
        Uq = torch.as_tensor(U_queries)
        if Uq.ndim == 2:
            Uq = Uq[None]
        if Uq.ndim != 3:
            raise ValueError(f"expected (B, n, p) queries, got {Uq.shape}")
        B = int(Uq.shape[0])
        if snap.rep_stack is None:
            # no clusters yet: every query would open a new cluster
            return AssignmentResult(
                labels=np.full(B, -1, dtype=np.int64),
                distances=np.full(B, np.inf),
                new_cluster=np.ones(B, dtype=bool),
                epoch=snap.epoch,
            )
        measure = snap.engine.config.measure
        labels = np.empty(B, dtype=np.int64)
        dists = np.empty(B, dtype=np.float64)
        for lo in range(0, B, self.batch_max):
            chunk = Uq[lo : lo + self.batch_max]
            idx, dmin = serve_assign(
                chunk, snap.rep_stack, measure, eq2_solver=self.eq2_solver
            )
            # the one host sync per dispatched micro-batch
            idx_np = idx.cpu().numpy()
            labels[lo : lo + idx_np.size] = snap.rep_labels[idx_np]
            dists[lo : lo + idx_np.size] = dmin.cpu().numpy().astype(np.float64)
        if snap.beta is not None:
            new = dists > snap.beta
        else:
            new = np.zeros(B, dtype=bool)
        labels = np.where(new, np.int64(-1), labels)
        return AssignmentResult(
            labels=labels, distances=dists, new_cluster=new, epoch=snap.epoch
        )

    def assign_many(self, queries: Sequence[Any]) -> AssignmentResult:
        """Assign a ragged query list, bucketing by signature shape.

        Queries are grouped by (n, p), each group dispatched as one stacked
        ``assign`` against a single pinned snapshot, and results are
        returned in the original order.  Mixed ``p`` requires the eq2
        measure (rectangular Gram); mismatched ambient ``n`` raises.
        Parity: identical to calling ``assign`` per query on the same
        snapshot, bitwise.
        """
        snap = self._snapshot
        arrs = [torch.as_tensor(q) for q in queries]
        for a in arrs:
            if a.ndim != 2:
                raise ValueError(
                    f"assign_many wants per-query (n, p) arrays, got {a.shape}"
                )
        groups: dict[tuple[int, int], list[int]] = {}
        for i, a in enumerate(arrs):
            groups.setdefault((int(a.shape[0]), int(a.shape[1])), []).append(i)
        Q = len(arrs)
        labels = np.full(Q, -1, dtype=np.int64)
        dists = np.full(Q, np.inf)
        new = np.ones(Q, dtype=bool)
        for shape in sorted(groups):
            idxs = groups[shape]
            res = self.assign(
                torch.stack([arrs[i] for i in idxs]), snapshot=snap
            )
            labels[idxs] = res.labels
            dists[idxs] = res.distances
            new[idxs] = res.new_cluster
        return AssignmentResult(
            labels=labels, distances=dists, new_cluster=new, epoch=snap.epoch
        )

    # -- write path ---------------------------------------------------------

    def submit_join(self, payload: Any) -> int:
        """Queue a join (signature computed eagerly by the queue's
        ``signature_fn``); returns the stable id the client will hold once
        a drain admits it."""
        self.queue.enqueue_join(payload)
        cid = self._projected_next
        self._projected.append(cid)
        self._projected_next += 1
        return cid

    def submit_leave(self, client_id: int) -> None:
        """Queue a departure by **stable client id** (including an id a
        prior ``submit_join`` predicted).  KeyError if unknown."""
        cid = int(client_id)
        try:
            pos = self._projected.index(cid)
        except ValueError:
            raise KeyError(
                f"client id {cid} not in projected membership"
            ) from None
        self.queue.enqueue_leave(pos)
        self._projected.pop(pos)

    def drain(self, *, force: bool = True) -> DrainReport:
        """Apply queued churn to the live engine and epoch-swap.

        Drains the queue (arrival order; the policy's ``deadline_s`` /
        ``priority_departures`` bound how much applies per call), applies
        each batch — departures first, then the admission — and, if
        anything applied, commits a fresh snapshot: new engine fork (warm
        cache shared), incremental representative refresh, ``epoch += 1``.
        Held snapshots from earlier epochs stay valid and immutable.

        Parity: because batches preserve arrival order and the engine's
        labels are a pure function of the distance store, any drain
        slicing reproduces the synchronous schedule's labels bitwise.
        """
        batches = self.queue.drain(force=force)
        joins = leaves = 0
        for batch in batches:
            if batch.leave:
                gone, _ = batch.resolve_leaves(self._write.ids)
                self._write.depart(np.asarray(gone, dtype=np.int64))
                leaves += len(gone)
            if batch.join:
                sigs = batch.signatures
                if sigs is None:
                    sigs = torch.stack([torch.as_tensor(j) for j in batch.join])
                self._write.admit(sigs)
                joins += len(batch.join)
        if batches:
            self._commit()
        return DrainReport(
            epoch=self._epoch,
            batches=len(batches),
            joins=joins,
            leaves=leaves,
            pending=len(self.queue),
        )

    def refresh_snapshot(self) -> ServingSnapshot:
        """Force a commit against the live engine's current state (for
        out-of-band engine mutations); normally ``drain`` does this."""
        self._commit()
        return self._snapshot

    def _commit(self) -> None:
        fork = self._write.copy()
        self.reps.refresh(fork)
        self._epoch += 1
        cfg = fork.config
        self._snapshot = ServingSnapshot(
            epoch=self._epoch,
            engine=fork,
            rep_stack=self.reps.rep_stack,
            rep_labels=self.reps.rep_labels.copy(),
            beta=None if cfg.n_clusters is not None else float(cfg.beta),
        )


def admit_oracle(engine, U_query) -> tuple[int, bool]:
    """Ground truth for the assignment-parity gate.

    Admits the single query through ``engine.admit`` on a throwaway fork
    (the live engine is untouched) and returns ``(label, new_cluster)`` —
    the stable label the write path would assign and whether it opened a
    new cluster.  Deterministic: the fork replays the same cached
    dendrogram against the same distance store.
    """
    U = torch.as_tensor(U_query)
    if U.ndim == 2:
        U = U[None]
    res = engine.copy().admit(U)
    return int(res.newcomer_labels[0]), bool(res.new_cluster[0])
