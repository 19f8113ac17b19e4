"""Agglomerative hierarchical clustering on the PACFL proximity matrix.

The server clusters clients from the proximity matrix ``A`` (pairwise
principal-angle distances, degrees) with a distance threshold ``beta`` — the
paper's globalization/personalization knob (Fig. 2).  No a-priori number of
clusters is required; optionally a fixed ``n_clusters`` stops the merging at a
target count (used for ablations vs IFCA).

Implemented from scratch (Lance-Williams updates) so the framework has no
SciPy dependency at runtime; tests cross-check against
``scipy.cluster.hierarchy`` as an oracle (including at K=512).

The merge loop is O(K^2): a per-cluster nearest-neighbor cache (``nn`` /
``nn_dist``) replaces the old global ``D[np.ix_(sub, sub)]`` re-slice (an
O(K^2) copy per merge, O(K^3) total — it dominated the one-shot phase once
the proximity matrix itself got fast).  Each merge costs one vectorized
Lance-Williams row update plus argmin rescans only for clusters whose
cached neighbor was touched by the merge.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

_LINKAGES = ("single", "complete", "average")

# Row-block edge for gather-based aggregation (cluster_distances_from_rows,
# blocked_column_fold, CondensedWorkingMatrix.prepare — and, via
# blocked_column_fold, every engine-side gather): bounds
# every transient at (ROW_BLOCK, K) float64 and — because all callers
# block identically through blocked_column_fold — keeps the reduction
# arithmetic bitwise-equal no matter where the rows come from (dense
# matrix, dense cache, band, strided condensed gathers).
ROW_BLOCK = 256


def condensed_row_gather(
    values: np.ndarray,
    n: int,
    idx: np.ndarray,
    diag_fill: float = 0.0,
    dtype=np.float64,
) -> np.ndarray:
    """Gather full symmetric rows from a column-block condensed vector.

    ``values`` holds the ``n (n - 1) / 2`` unique pairwise entries with
    pair ``(i, j)``, ``i < j`` at flat offset ``j (j - 1) / 2 + i``; the
    result is ``(len(idx), n)`` in ``dtype`` with the diagonal set to
    ``diag_fill`` (0 for distance stores, inf for HC working matrices).
    The single implementation of the strided-gather formula — shared by
    :meth:`CondensedDistances.rows` and
    :meth:`CondensedWorkingMatrix.rows_block`, so the two can never drift.

    ``values`` may be a flat ndarray or a segmented store backend
    (anything with ``gather_flat``, e.g.
    :class:`repro_torch.core.engine.store_backends.SpilledSegments`) — a
    segmented source resolves the fancy-gather itself, walking its cold
    segments one at a time under the residency budget, and returns the
    bitwise-same float32 values a flat vector would.
    """
    idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
    if values.size == 0:  # n <= 1: no pairs
        return np.full((idx.size, n), diag_fill, dtype=dtype)
    J = np.arange(n, dtype=np.int64)
    hi = np.maximum(idx[:, None], J[None, :])
    lo = np.minimum(idx[:, None], J[None, :])
    flat = hi * (hi - 1) // 2 + lo
    diag = hi == lo
    flat[diag] = 0  # any in-range slot; overwritten below
    take = getattr(values, "gather_flat", None)
    out = values[flat] if take is None else take(flat)
    if out.dtype != dtype:
        out = out.astype(dtype)
    out[diag] = diag_fill
    return out


def blocked_column_fold(gather, idx: np.ndarray, linkage: str) -> np.ndarray:
    """Columnwise linkage fold (sum / min / max) over the rows ``idx``.

    ``gather(sub_idx)`` returns ``(len(sub_idx), K)`` float64 rows; they
    are requested in blocks of ``ROW_BLOCK``, so peak transient memory is
    one block regardless of ``len(idx)``.  This is THE shared reduction
    every consumer of leaf rows uses (``cluster_distances_from_rows``,
    the dendrogram replay's promotion aggregation) — single implementation
    + fixed blocking is what makes heights bitwise-identical across the
    store's memory tiers.
    """
    idx = np.asarray(idx, dtype=np.int64)
    col = None
    for lo in range(0, idx.size, ROW_BLOCK):
        R = gather(idx[lo : lo + ROW_BLOCK])
        if linkage == "average":
            part = R.sum(axis=0)
            col = part if col is None else col + part
        elif linkage == "single":
            part = R.min(axis=0)
            col = part if col is None else np.minimum(col, part)
        else:  # complete
            part = R.max(axis=0)
            col = part if col is None else np.maximum(col, part)
    return col


class CondensedWorkingMatrix:
    """(K, K)-free float64 working matrix for :func:`merge_forest`.

    Wraps a *column-block condensed* vector (pair ``(i, j)``, ``i < j`` at
    flat offset ``j (j - 1) / 2 + i`` — the layout of
    :class:`repro_torch.core.engine.store.CondensedDistances`) and exposes exactly
    the row reads/writes the merge loop performs.  Rows are strided gathers
    and symmetric row writes are single scatters (each pair is stored once),
    so the loop runs in ``K (K - 1) / 2`` float64 — half a dense float64
    matrix, and never a ``(K, K)`` allocation.

    Bitwise parity with the dense path is by construction: gathered rows
    hold the same float64 values a dense matrix would (the diagonal reads
    as inf, exactly like the dense path's ``fill_diagonal``), and the merge
    loop performs identical arithmetic on them.  Like the dense input, the
    working vector is CONSUMED (mutated in place).
    """

    def __init__(self, values, n: int):
        self.n = int(n)
        need = self.n * (self.n - 1) // 2
        segs = getattr(values, "segments", None)
        if segs is not None:
            # segmented store backend: fill the private float64 working
            # copy one column-range segment at a time (exact float32
            # upcasts — bitwise what the flat path computes), so a spilled
            # source faults in at most one cold segment per step and the
            # full float32 vector is never materialized alongside
            v = np.empty(int(values.size), dtype=np.float64)
            for seg in segs():
                v[seg.base : seg.base + seg.values.size] = seg.values
        else:
            v = np.array(values, dtype=np.float64)  # private working copy
        if v.size != need:
            raise ValueError(
                f"condensed working vector for n={self.n} needs "
                f"{need} entries, got {v.size}"
            )
        self.v = v
        self._J = np.arange(self.n, dtype=np.int64)
        self._tri = self._J * (self._J - 1) // 2

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nbytes(self) -> int:
        return self.v.nbytes

    def _row_indices(self, i: int) -> np.ndarray:
        idx = np.empty(self.n, dtype=np.int64)
        t = int(self._tri[i])
        idx[:i] = t + self._J[:i]          # pairs (j, i), j < i: contiguous
        idx[i] = 0                         # placeholder; callers mask it
        idx[i + 1 :] = self._tri[i + 1 :] + i  # pairs (i, j), j > i: strided
        return idx

    def row(self, i: int) -> np.ndarray:
        out = self.v[self._row_indices(i)]
        out[i] = np.inf
        return out

    def rows_block(self, idx: np.ndarray) -> np.ndarray:
        """(len(idx), n) gather, diagonal read as inf (working matrix)."""
        return condensed_row_gather(self.v, self.n, idx, diag_fill=np.inf)

    def write_row(self, i: int, vals: np.ndarray) -> None:
        """Symmetric row write (``D[i, :] = D[:, i] = vals``), one scatter."""
        idx = self._row_indices(i)
        keep = np.ones(self.n, dtype=bool)
        keep[i] = False
        self.v[idx[keep]] = vals[keep]

    def clear_row(self, j: int) -> None:
        idx = self._row_indices(j)
        keep = np.ones(self.n, dtype=bool)
        keep[j] = False
        self.v[idx[keep]] = np.inf

    def argmin_row(self, k: int) -> tuple[int, float]:
        r = self.row(k)
        a = int(r.argmin())
        return a, r[a]

    def prepare(self) -> tuple[np.ndarray, np.ndarray]:
        """Initial nearest-neighbor caches via cache-blocked column segments.

        The condensed layout is column-major: segment ``j`` is
        ``v[tri(j) : tri(j) + j]`` holding ``d(j, 0..j-1)`` contiguously.
        Instead of the strided per-row gathers of :meth:`prepare_rowgather`,
        each block of segments is memcpy'd into a ``(block, c1)`` scratch
        and reduced with two vectorized argmins: rowwise over each in-block
        row's own segment (its columns ``< j`` — the first candidates that
        row ever sees, so a direct set), then columnwise under strict ``<``
        folding the block's segments into every row ``< c1`` as candidate
        columns ``j``.  Blocks ascend and updates are strict, so ties
        resolve to the smallest column index — ``np.argmin``'s
        first-occurrence rule — and parity with the dense oracle is bitwise
        (values are copied, never recomputed).  Peak scratch is
        ``ROW_BLOCK * n`` float64, same as the row-gather path.  All reads
        hit the private float64 working copy — for a segmented (spilled)
        source that copy was already filled one cold segment at a time in
        ``__init__``, so bootstrap never re-touches the store's segments.
        """
        n = self.n
        nn = np.zeros(n, dtype=np.int64)    # all-inf rows argmin to 0, like dense
        nnd = np.full(n, np.inf, dtype=np.float64)
        for c0 in range(0, n, ROW_BLOCK):
            c1 = min(c0 + ROW_BLOCK, n)
            cb = c1 - c0
            Mb = np.full((cb, c1), np.inf, dtype=np.float64)
            for j in range(c0, c1):
                t = int(self._tri[j])
                Mb[j - c0, :j] = self.v[t : t + j]
            pa = Mb.argmin(axis=1)          # in-block prefix (inf pad is safe)
            nn[c0:c1] = pa
            nnd[c0:c1] = Mb[np.arange(cb), pa]
            ca = Mb.argmin(axis=0)          # candidate column j per row, min j wins
            cv = Mb[ca, np.arange(c1)]
            upd = cv < nnd[:c1]
            nn[:c1][upd] = c0 + ca[upd]
            nnd[:c1][upd] = cv[upd]
        return nn, nnd

    def prepare_rowgather(self) -> tuple[np.ndarray, np.ndarray]:
        """Strided row-gather reference for :meth:`prepare` (kept for the
        parity test and the before/after benchmark row)."""
        n = self.n
        nn = np.empty(n, dtype=np.int64)
        nnd = np.empty(n, dtype=np.float64)
        for lo in range(0, n, ROW_BLOCK):
            hi = min(lo + ROW_BLOCK, n)
            R = self.rows_block(np.arange(lo, hi, dtype=np.int64))
            nn[lo:hi] = R.argmin(axis=1)
            nnd[lo:hi] = R[np.arange(hi - lo), nn[lo:hi]]
        return nn, nnd


class _DenseWorking:
    """Adapter giving a dense (K, K) float64 matrix the same row interface
    (views, not copies — the ops below are bitwise the pre-refactor code)."""

    __slots__ = ("D",)

    def __init__(self, D: np.ndarray):
        self.D = D

    @property
    def shape(self):
        return self.D.shape

    def row(self, i):
        return self.D[i]

    def write_row(self, i, vals):
        self.D[i, :] = vals
        self.D[:, i] = vals

    def clear_row(self, j):
        self.D[j, :] = np.inf
        self.D[:, j] = np.inf

    def argmin_row(self, k):
        r = self.D[k]
        a = int(r.argmin())
        return a, r[a]

    def prepare(self):
        np.fill_diagonal(self.D, np.inf)
        nn = self.D.argmin(axis=1)
        return nn, self.D[np.arange(self.D.shape[0]), nn]


def lance_williams(
    di: np.ndarray, dj: np.ndarray, si, sj, linkage: str
) -> np.ndarray:
    """Distance of (i u j) to everything, from the rows/entries of i and j.

    Vectorized over whatever shape ``di``/``dj`` share; ``si``/``sj`` are the
    member counts of i and j (only average linkage uses them).
    """
    if linkage == "single":
        return np.minimum(di, dj)
    if linkage == "complete":
        return np.maximum(di, dj)
    return (si * di + sj * dj) / (si + sj)  # average (UPGMA)


def merge_forest(
    D: Union[np.ndarray, CondensedWorkingMatrix],
    size: np.ndarray,
    members: list[list[int]],
    *,
    beta: Optional[float] = None,
    n_clusters: Optional[int] = None,
    linkage: str = "average",
) -> tuple[np.ndarray, list[list[int]], list[tuple[int, int, float]]]:
    """Core agglomerative merge loop, generalized to non-singleton starts.

    Runs the generic (global closest pair) algorithm on an initial forest of
    clusters: ``D`` is the (C, C) float64 cluster-distance matrix — either a
    dense ndarray or a :class:`CondensedWorkingMatrix` (the strided path the
    streaming engine's ``banded`` / ``condensed_only`` memory tiers use for
    a (K, K)-free bootstrap; both are CONSUMED — mutated in place, diagonal
    read as inf).  ``size[i]`` is the member count and ``members[i]`` the
    client ids of initial cluster ``i``.  For tie-breaking to match a
    singleton-start run on the same leaves, initial clusters must be ordered
    by their smallest member id (rows then stand in for leaf indices:
    merging keeps the smaller row, so a row's id stays the min member of its
    cluster).  The two input paths produce bitwise-identical merges: the
    condensed path gathers rows holding exactly the values the dense rows
    would, and the loop's arithmetic is shared.

    Returns ``(active, members, merges)``: the liveness mask, the merged
    member lists, and the merge script — ``(rep_i, rep_j, height)`` per merge
    in application order, where a rep is the smallest member id of the
    cluster at merge time.  Heights are nondecreasing for the three
    (reducible) linkages here, which is what makes the script replayable by
    the streaming engine (``repro_torch.core.engine``).
    """
    if (beta is None) == (n_clusters is None):
        raise ValueError("specify exactly one of beta / n_clusters")
    if linkage not in _LINKAGES:
        raise ValueError(f"linkage must be one of {_LINKAGES}")
    work = D if isinstance(D, CondensedWorkingMatrix) else _DenseWorking(D)
    K = work.shape[0]
    merges: list[tuple[int, int, float]] = []
    active = np.ones(K, dtype=bool)
    if K == 1:
        return active, members, merges

    # `nn[i]` caches the argmin of row i (first occurrence on ties, matching
    # a fresh row-major argmin) and `nn_dist[i]` its distance, so the closest
    # pair is an O(K) vectorized lookup instead of an O(K^2) submatrix scan.
    remaining = K
    nn, nn_dist = work.prepare()

    target = 1 if n_clusters is None else max(int(n_clusters), 1)
    while remaining > target:
        # Closest active pair.  For symmetric D the cached row minima cover
        # every pair, and argmin-over-rows + first-occurrence-per-row picks
        # the same (i, j) as a row-major scan of the full active submatrix.
        masked = np.where(active, nn_dist, np.inf)
        i = int(np.argmin(masked))
        dmin = float(masked[i])
        if beta is not None and dmin > beta:
            break
        j = int(nn[i])
        if i > j:
            i, j = j, i
        # Vectorized Lance-Williams update of distances from merged (i u j);
        # inactive entries hold inf in both rows and stay inf under all
        # three updates.
        new = lance_williams(work.row(i), work.row(j), size[i], size[j], linkage)
        new[i] = new[j] = np.inf
        work.write_row(i, new)
        work.clear_row(j)
        merges.append((min(members[i]), min(members[j]), dmin))
        size[i] += size[j]
        members[i].extend(members[j])
        active[j] = False
        nn_dist[j] = np.inf
        remaining -= 1

        # Nearest-neighbor maintenance.  Clusters whose cached neighbor was
        # i or j rescan their row (the merged cluster may have moved away
        # under complete/average linkage); everyone else can only have been
        # improved by the merged row, a vectorized compare.  The tie rule
        # (equal distance, lower index wins) mirrors np.argmin.
        touched = active & ((nn == i) | (nn == j))
        touched[i] = False
        for k in np.where(touched)[0]:
            nn[k], nn_dist[k] = work.argmin_row(k)
        others = active & ~touched
        others[i] = False
        better = others & ((new < nn_dist) | ((new == nn_dist) & (i < nn)))
        nn[better] = i
        nn_dist[better] = new[better]
        nn[i], nn_dist[i] = work.argmin_row(i)

    return active, members, merges


def labels_from_members(
    active: np.ndarray, members: list[list[int]], n_leaves: int
) -> np.ndarray:
    """Canonical flat labels: cluster ids ordered by first client occurrence."""
    labels = np.full(n_leaves, -1, dtype=np.int64)
    next_id = 0
    order = sorted(np.where(active)[0], key=lambda c: min(members[c]))
    for c in order:
        for m in members[c]:
            labels[m] = next_id
        next_id += 1
    assert (labels >= 0).all()
    return labels


def cluster_distances_from_rows(
    gather, groups: list[list[int]], linkage: str = "average"
) -> np.ndarray:
    """Cluster-cluster distances from a *row gather*, never a full matrix.

    For the three supported linkages the cluster distance is a plain
    reduction over leaf pairs (mean / max / min), so it can be computed
    from leaf rows instead of replaying Lance-Williams merge by merge — the
    engine uses this to seed a continuation run on a small active forest.
    ``gather(idx)`` must return the ``(len(idx), K)`` float64 leaf-distance
    rows (e.g. :meth:`CondensedDistances.gather_rows`); rows are requested
    in blocks of at most ``ROW_BLOCK``, so peak transient memory is
    ``(ROW_BLOCK, K)`` float64 regardless of group sizes — no (K, K)
    materialization.  The two-stage reduction (columnwise fold over each
    group's rows, then a fold over the partner group's columns) is
    tier-independent: any gather source holding the same values produces a
    bitwise-identical result.  Returns (C, C) float64 with an inf diagonal.
    """
    C = len(groups)
    cols = [np.asarray(g, dtype=np.int64) for g in groups]
    sizes = np.array([g.size for g in cols], dtype=np.float64)
    out = np.empty((C, C), dtype=np.float64)
    for a in range(C):
        # (K,) columnwise fold of group a's leaf rows
        col = blocked_column_fold(gather, cols[a], linkage)
        for b in range(a + 1, C):
            sub = col[cols[b]]
            if linkage == "average":
                val = sub.sum() / (sizes[a] * sizes[b])
            elif linkage == "single":
                val = sub.min()
            else:
                val = sub.max()
            out[a, b] = out[b, a] = val
    np.fill_diagonal(out, np.inf)
    return out


def cluster_distance_matrix(
    A: np.ndarray, groups: list[list[int]], linkage: str = "average"
) -> np.ndarray:
    """Cluster-cluster distances from a dense leaf matrix ``A`` (K, K).

    Thin adapter over :func:`cluster_distances_from_rows` — identical
    blocked arithmetic, so a dense matrix and a condensed store holding the
    same values produce bitwise-identical results.
    """
    A = np.asarray(A, dtype=np.float64)
    return cluster_distances_from_rows(lambda idx: A[idx], groups, linkage)


def hierarchical_clustering(
    A: np.ndarray,
    beta: Optional[float] = None,
    *,
    n_clusters: Optional[int] = None,
    linkage: str = "average",
) -> np.ndarray:
    """Cluster clients from proximity matrix ``A``.

    Parameters
    ----------
    A: (K, K) symmetric distance matrix, zero diagonal.
    beta: distance threshold — merging stops once the closest pair of
        clusters is farther than ``beta``.  (Paper's ``HC(A, beta)``.)
    n_clusters: alternatively stop at exactly this many clusters.
    linkage: "single" | "complete" | "average".

    Returns
    -------
    labels: (K,) int cluster ids in [0, Z).  Label ids are canonicalized by
        first client occurrence so results are deterministic.
    """
    A = np.asarray(A, dtype=np.float64)
    K = A.shape[0]
    if A.shape != (K, K):
        raise ValueError("A must be square")
    if K == 1:
        if (beta is None) == (n_clusters is None):
            raise ValueError("specify exactly one of beta / n_clusters")
        if linkage not in _LINKAGES:
            raise ValueError(f"linkage must be one of {_LINKAGES}")
        return np.zeros(1, dtype=np.int64)
    active, members, _ = merge_forest(
        A.copy(),
        np.ones(K, dtype=np.int64),
        [[i] for i in range(K)],
        beta=beta,
        n_clusters=n_clusters,
        linkage=linkage,
    )
    return labels_from_members(active, members, K)


def n_clusters_for_beta(A: np.ndarray, beta: float, linkage: str = "average") -> int:
    """Number of clusters HC(A, beta) forms (Fig. 2 red bars)."""
    return int(hierarchical_clustering(A, beta, linkage=linkage).max()) + 1


def beta_sweep(
    A: np.ndarray, betas: np.ndarray, linkage: str = "average"
) -> list[tuple[float, int]]:
    """(beta, n_clusters) pairs across a threshold sweep (Fig. 2)."""
    return [(float(b), n_clusters_for_beta(A, float(b), linkage)) for b in betas]
