"""Drift detection: per-cluster principal-angle dispersion across snapshots.

A cluster whose members' subspaces are drifting apart shows up as growing
*intra-cluster dispersion* — the aggregated pairwise principal-angle
distance between its members — while two clusters drifting together show
up as an *inter-cluster* linkage distance sinking below the merge
threshold.  :class:`DriftTracker` observes a
:class:`~repro_torch.core.engine.engine.ClusterEngine` across versions and flags

* **split candidates**: clusters whose intra dispersion exceeds the
  threshold the clustering merged them under (their members would no
  longer merge if re-clustered from scratch is *not* implied — HC heights
  are history-dependent — but the cluster is internally wider than the
  criterion, the paper's cue that one distribution became several);
* **merge candidates**: cluster pairs whose linkage distance is at or
  below the threshold (two distributions became one).

All reads go through ``store.gather_rows(..., promote=False)`` in
``ROW_BLOCK`` blocks — tier-independent, never a (K, K) materialization,
and streaming-scan pure (the banded tier's hot window is left untouched),
so the tracker is safe to run every round on a production engine under
any memory tier (the runtime sanitizer's S1-S3 contracts hold).

History is keyed by **stable** cluster labels, so per-cluster dispersion
deltas survive churn: ``ClusterDrift.delta_mean_deg`` is the change since
the previous observation of the *same* cluster identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.hc import ROW_BLOCK, cluster_distances_from_rows


@dataclass(frozen=True)
class ClusterDrift:
    """Dispersion snapshot of one cluster at one engine version."""

    label: int                 # stable cluster label
    size: int
    mean_intra_deg: float      # mean pairwise member distance (0 for singletons)
    max_intra_deg: float       # cluster diameter
    delta_mean_deg: Optional[float]  # vs previous observation; None on first


@dataclass(frozen=True)
class DriftReport:
    """One observation: per-cluster dispersion + split/merge candidates."""

    version: int               # engine version observed
    n_clients: int
    threshold_deg: float
    clusters: tuple[ClusterDrift, ...]
    split_candidates: tuple[int, ...]             # stable labels
    merge_candidates: tuple[tuple[int, int, float], ...]  # (label_a, label_b, deg)

    def drift_of(self, label: int) -> Optional[ClusterDrift]:
        for c in self.clusters:
            if c.label == int(label):
                return c
        return None


class DriftTracker:
    """Tracks per-cluster dispersion across engine snapshots.

    Parameters
    ----------
    threshold_deg: split/merge flag threshold in degrees.  Default ``None``
        = the engine's ``beta`` at observe time; engines in ``n_clusters``
        mode (no beta semantics) must pass one explicitly.
    min_cluster_size: clusters smaller than this are never split
        candidates (a singleton has no dispersion).  Default 2.
    """

    def __init__(
        self,
        threshold_deg: Optional[float] = None,
        *,
        min_cluster_size: int = 2,
    ):
        self.threshold_deg = threshold_deg
        self.min_cluster_size = int(min_cluster_size)
        self.history: list[DriftReport] = []
        self._prev_mean: dict[int, float] = {}

    def _threshold_for(self, engine) -> float:
        if self.threshold_deg is not None:
            return float(self.threshold_deg)
        if engine.config.n_clusters is not None:
            raise ValueError(
                "engine runs in n_clusters mode — pass an explicit "
                "threshold_deg to DriftTracker"
            )
        return float(engine.config.beta)

    @staticmethod
    def _intra_dispersion(store, members: np.ndarray) -> tuple[float, float]:
        """(mean, max) pairwise distance inside one cluster, blocked reads.

        Rows are gathered ``ROW_BLOCK`` at a time with ``promote=False`` —
        bounded transients on every tier and no hot-window eviction.  The
        diagonal contributes exact zeros, so the ordered-pair mean divides
        by ``m * (m - 1)``.
        """
        m = int(members.size)
        if m < 2:
            return 0.0, 0.0
        total = 0.0
        peak = 0.0
        for lo in range(0, m, ROW_BLOCK):
            idx = members[lo : lo + ROW_BLOCK]
            rows = store.gather_rows(idx, promote=False)
            sub = rows[:, members]
            total += float(sub.sum())
            peak = max(peak, float(sub.max()))
        return total / (m * (m - 1)), peak

    def observe(self, engine) -> DriftReport:
        """Measure the engine's current clustering; append to history.

        The split flag uses the linkage's own aggregation flavor: cluster
        diameter (max) under ``complete`` linkage, mean pairwise dispersion
        otherwise — the quantity the merge criterion bounded when the
        cluster formed.
        """
        thr = self._threshold_for(engine)
        labels = engine.labels
        store = engine.store
        linkage = engine.config.linkage
        uniq = np.unique(labels)
        groups = [np.where(labels == l)[0] for l in uniq]

        clusters: list[ClusterDrift] = []
        splits: list[int] = []
        for l, members in zip(uniq, groups):
            mean_d, max_d = self._intra_dispersion(store, members)
            crit = max_d if linkage == "complete" else mean_d
            prev = self._prev_mean.get(int(l))
            clusters.append(
                ClusterDrift(
                    label=int(l),
                    size=int(members.size),
                    mean_intra_deg=mean_d,
                    max_intra_deg=max_d,
                    delta_mean_deg=None if prev is None else mean_d - prev,
                )
            )
            if members.size >= self.min_cluster_size and crit > thr:
                splits.append(int(l))

        merges: list[tuple[int, int, float]] = []
        if len(groups) > 1:
            D = cluster_distances_from_rows(
                lambda idx: store.gather_rows(idx, promote=False),
                groups,
                linkage,
            )
            for i in range(len(uniq)):
                for j in range(i + 1, len(uniq)):
                    if D[i, j] <= thr:
                        merges.append((int(uniq[i]), int(uniq[j]), float(D[i, j])))

        report = DriftReport(
            version=engine.version,
            n_clients=engine.n_clients,
            threshold_deg=thr,
            clusters=tuple(clusters),
            split_candidates=tuple(splits),
            merge_candidates=tuple(merges),
        )
        self._prev_mean = {c.label: c.mean_intra_deg for c in clusters}
        self.history.append(report)
        return report
