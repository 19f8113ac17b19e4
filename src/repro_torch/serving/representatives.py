"""Per-cluster representative signatures for the O(C) assignment read path.

Port of ``repro_torch.serving.representatives``: representatives are torch
tensors on the engine's device.

A production assignment query ("which cluster model should this client
pull?") must not replay the dendrogram — it only needs the principal angle
between the query signature and **one representative per cluster**, then an
argmin over the C clusters.  :class:`RepresentativeCache` maintains that
(C, n, p) representative stack against a :class:`~repro_torch.core.engine.engine.
ClusterEngine` and invalidates it *incrementally*: a refresh recomputes a
cluster's representative only when that cluster's member-id set changed
since the last refresh (admit/depart/replay can reshuffle a few clusters
per drain; the other C-1 representatives are reused as-is), and a refresh
against an engine whose ``version`` is unchanged is a no-op.

Two representative kinds (see ``docs/SERVING.md`` for when to pick which):

* ``"medoid"`` — the member minimizing the summed intra-cluster distance,
  read from the engine's condensed store via the policy-routed
  ``gather_rows(..., promote=False)`` path (a streaming scan that must not
  evict the write path's hot banded window).  Deterministic: ties break to
  the lowest member row position.  The representative is an *actual client
  signature*, so a query's angle to it is an entry the engine itself could
  have computed — this is the kind the assignment-parity gate runs on.
* ``"centroid"`` — the QR-orthonormalization of the member bases' mean, a
  synthetic subspace that can sit closer to the cluster bulk than any
  member but is not a row of the proximity matrix.

Determinism: for a fixed engine state and kind, the representative stack is
a pure function of the membership and the distance store (exact float32
upcasts on the medoid row sums, one fixed QR on the centroid mean), so
repeated refreshes are bitwise-stable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

REPRESENTATIVE_KINDS = ("medoid", "centroid")


@dataclass(frozen=True)
class ClusterRepresentative:
    """One cluster's cached representative.

    ``member_ids`` is the sorted-by-row-position tuple of stable client ids
    the representative was computed from — the cache's invalidation key.
    ``medoid_id`` is the stable id of the chosen member (``None`` for
    centroids, which are synthetic subspaces rather than members).
    """

    label: int
    member_ids: tuple[int, ...]
    rep: torch.Tensor             # (n, p) orthonormal basis
    medoid_id: Optional[int]


class RepresentativeCache:
    """Incrementally maintained (C, n, p) representative stack.

    ``refresh(engine)`` synchronizes with the engine's current membership:
    unchanged clusters (same stable label, same member-id tuple) keep their
    cached representative, changed or new clusters are recomputed, and
    clusters that vanished are dropped.  ``rebuilt`` / ``reused`` count
    those decisions across the cache's lifetime (telemetry for tests and
    the serving benchmark).  The stacked array is rebuilt only when at
    least one entry changed, so steady-state refreshes after a no-churn
    drain cost one version comparison.
    """

    def __init__(self, kind: str = "medoid"):
        if kind not in REPRESENTATIVE_KINDS:
            raise ValueError(
                f"unknown representative kind: {kind!r} "
                f"(want one of {REPRESENTATIVE_KINDS})"
            )
        self.kind = kind
        self._by_label: dict[int, ClusterRepresentative] = {}
        self._version: Optional[int] = None
        self._stack: Optional[torch.Tensor] = None
        self._labels: np.ndarray = np.zeros(0, dtype=np.int64)
        self.rebuilt = 0
        self.reused = 0

    @property
    def rep_stack(self) -> Optional[torch.Tensor]:
        """(C, n, p) representatives in ``rep_labels`` order, or ``None``
        when the engine had no clusters at the last refresh."""
        return self._stack

    @property
    def rep_labels(self) -> np.ndarray:
        """(C,) stable cluster labels aligned with :attr:`rep_stack` rows."""
        return self._labels

    def representative(self, label: int) -> ClusterRepresentative:
        """The cached entry for one stable cluster label (KeyError if gone)."""
        return self._by_label[int(label)]

    def refresh(self, engine) -> None:
        """Synchronize with ``engine``'s membership (incremental, see class
        docstring).  A refresh against an unchanged ``engine.version`` is a
        no-op; otherwise only clusters whose member-id sets changed are
        recomputed — deterministic for a fixed engine state."""
        if self._version == engine.version:
            return
        labels = engine.labels
        ids = engine.ids
        fresh: dict[int, ClusterRepresentative] = {}
        changed = False
        for lbl in np.unique(labels):
            lbl = int(lbl)
            pos = np.flatnonzero(labels == lbl)
            member_ids = tuple(int(i) for i in ids[pos])
            old = self._by_label.get(lbl)
            if old is not None and old.member_ids == member_ids:
                fresh[lbl] = old
                self.reused += 1
                continue
            fresh[lbl] = self._build(engine, lbl, pos, member_ids)
            self.rebuilt += 1
            changed = True
        if changed or len(fresh) != len(self._by_label):
            order = sorted(fresh)
            self._labels = np.fromiter(order, dtype=np.int64, count=len(order))
            self._stack = (
                torch.stack([fresh[lbl].rep for lbl in order]) if order else None
            )
        self._by_label = fresh
        self._version = engine.version

    def _build(
        self, engine, lbl: int, pos: np.ndarray, member_ids: tuple[int, ...]
    ) -> ClusterRepresentative:
        if self.kind == "medoid":
            # promote=False: a serving-side scan must not evict the write
            # path's hot banded window (sanitizer rule S3).
            rows = engine.store.gather_rows(pos, promote=False)
            total = rows[:, pos].sum(axis=1)  # float64, exact f32 upcasts
            mpos = int(np.argmin(total))      # ties -> lowest row position
            rep = engine.U[int(pos[mpos])]
            return ClusterRepresentative(
                lbl, member_ids, rep, int(engine.ids[pos[mpos]])
            )
        members = engine.U[torch.as_tensor(pos, device=engine.U.device)]
        q, _ = torch.linalg.qr(torch.mean(members, dim=0))
        return ClusterRepresentative(lbl, member_ids, q, None)
