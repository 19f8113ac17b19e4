"""Incremental dendrogram maintenance: script replay with a dirty set.

The engine caches the *merge script* of the last clustering run — the
``(rep_i, rep_j, height)`` sequence :func:`repro_torch.core.hc.merge_forest`
records, height-sorted because the three supported linkages (single /
complete / average) are *reducible*: the generic closest-pair algorithm
produces nondecreasing merge heights and a dendrogram that is invariant to
the order reciprocal-nearest-neighbor pairs are merged in.

Admission and departure both reduce to the same replay problem: a forest of
**clean** leaves whose pairwise distances are unchanged (so the cached
script is still exact for them), plus **dirty** clusters that deviate from
the script — newcomer singletons on admit; on depart, the survivors of
dropped merges, promoted lazily via *tombstone* entries the script rewrite
leaves at the drop heights (:func:`filter_script_for_depart`).  The two
dirty sources compose: :func:`replay` accepts a tombstoned script AND
dirty singletons *in the same pass*, which is what makes the engine's
fused ``move`` (signature refresh — depart the stale rows, re-admit the
refreshed ones) a single replay instead of two.  The replay
walks the script in height order, maintaining a Lance-Williams distance
*vector* (one row per dirty cluster, slots = leaf representatives) instead
of the full matrix:

* a cached merge ``(a, b, h)`` applies unchanged when no dirty cluster is
  closer than ``h`` to the current frontier — O(#dirty) vectorized column
  combines, no O(K) row work;
* when a dirty cluster's cached nearest neighbor comes closer than ``h``,
  the dirty merge happens first (Lance-Williams on insert).  Absorbing a
  clean cluster seeds its distance vector by direct aggregation over the
  condensed leaf store;
* a cached merge whose partner was absorbed is dropped and the surviving
  side is *promoted* to dirty — it no longer follows the script.

Exactness argument: clean-clean distances are unchanged, so between script
positions the minimum clean-clean distance is exactly the next script
height; dirty-X distances are tracked explicitly; hence every step merges
the globally closest active pair — the generic algorithm on the extended
(or shrunken) leaf set.  Replayed clean heights are bitwise the cached
ones; dirty heights follow the same Lance-Williams recursion in the same
order as a from-scratch run.  The one caveat is degenerate ties: promotion
vectors are aggregated (mean/min/max over leaf pairs) rather than replayed
merge-by-merge, so they can differ from a from-scratch run in the last few
ulps, and exact clean-vs-dirty height ties break by smallest representative
rather than the full argmin row scan.  Both only matter on degenerate
(duplicate-distance) inputs; the oracle parity suite pins the behavior on
clustered and random data.

Cost: O(S * #dirty) column work for a script of length S plus O(K) per
dirty merge/promotion — near O(B * K) for a B-newcomer admission, versus
O(K^2) row updates plus rescans for re-clustering the world.

Throughput: *runs* of consecutive clean entries — stretches of the script
where no dirty cluster comes closer than the cached heights — are folded
**en bloc** (:func:`_scan_clean_run` / :func:`_apply_run_enbloc`): one
grouped column reduction and one cache refresh replace per-entry numpy
dispatch, cutting the ~50-100us-per-entry call overhead to per-run.  The
min/max folds of single/complete linkage are exactly associative, so the
en-bloc result is bitwise the sequential one; average linkage uses a
grouped weighted mean (equal up to rounding), gated by a height-tie guard
that splits runs at tied heights.  Any fold whose value lands exactly on a
dirty row's cached minimum makes the nearest-neighbor choice
history-dependent — those runs fall back to the sequential path, keeping
the degenerate-tie behavior the oracle parity suite pins.

Memory: every leaf-row read goes through the store's tiered memory policy
(``CondensedDistances.gather_rows`` — dense cache / banded hot-row window /
strided condensed gathers, see :mod:`repro_torch.core.engine.memory`), in blocks
of at most ``ROW_BLOCK`` rows (repro_torch.core.hc), so the replay never materializes a
(K, K) outside the dense tier and its aggregation arithmetic — hence the
labels — is identical across tiers.  On the ``spilled`` tier those strided
gathers resolve through the store's segmented backend
(:mod:`repro_torch.core.engine.store_backends`), which walks mmap'd cold
column-range segments one at a time under a residency budget — so replay
never faults in more than one cold segment block at once and its peak RSS
is budget-bounded, not K-bounded.  The caveats above and the tier table
are documented for humans in ``docs/ENGINE.md``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.hc import (
    blocked_column_fold,
    cluster_distances_from_rows,
    labels_from_members,
    lance_williams,
    merge_forest,
)

Merge = tuple[int, int, float]

# Minimum clean-run length worth the en-bloc fold setup (union-find grouping
# plus one full nn rescan).  Below this the per-entry sequential path is
# cheaper; tests monkeypatch it to force either path.
ENBLOC_MIN_RUN = 4


@dataclass
class ReplayStats:
    """What one admit/depart replay actually did (engine telemetry)."""

    script_applied: int = 0
    script_dropped: int = 0
    dirty_merges: int = 0
    promotions: int = 0
    tail_merges: int = 0
    enbloc_runs: int = 0        # clean runs folded in one vectorized pass
    enbloc_entries: int = 0     # script entries covered by those runs
    enbloc_fallbacks: int = 0   # runs replayed sequentially (tie hazard)


@dataclass
class _DirtyRows:
    """Row-per-dirty-cluster Lance-Williams distance vectors."""

    K: int
    DV: np.ndarray = field(init=False)      # (cap, K) float64
    rep: np.ndarray = field(init=False)     # (cap,) slot rep or -1
    nn: np.ndarray = field(init=False)      # (cap,) cached argmin slot
    nnd: np.ndarray = field(init=False)     # (cap,) cached min distance
    count: int = field(init=False, default=0)

    def __post_init__(self):
        cap = 4
        self.DV = np.full((cap, self.K), np.inf, dtype=np.float64)
        self.rep = np.full(cap, -1, dtype=np.int64)
        self.nn = np.zeros(cap, dtype=np.int64)
        self.nnd = np.full(cap, np.inf, dtype=np.float64)

    def _grow(self) -> None:
        cap = self.DV.shape[0]
        self.DV = np.vstack(
            [self.DV, np.full((cap, self.K), np.inf, dtype=np.float64)]
        )
        self.rep = np.concatenate([self.rep, np.full(cap, -1, dtype=np.int64)])
        self.nn = np.concatenate([self.nn, np.zeros(cap, dtype=np.int64)])
        self.nnd = np.concatenate(
            [self.nnd, np.full(cap, np.inf, dtype=np.float64)]
        )

    def add(self, rep: int, vec: np.ndarray) -> int:
        if self.count == self.DV.shape[0]:
            self._grow()
        r = self.count
        self.DV[r] = vec
        self.rep[r] = rep
        self.nn[r] = int(np.argmin(vec))
        self.nnd[r] = vec[self.nn[r]]
        self.count += 1
        return r

    def live(self) -> np.ndarray:
        return np.where(self.rep[: self.count] >= 0)[0]

    def row_of(self, rep: int) -> Optional[int]:
        hits = np.where(self.rep[: self.count] == rep)[0]
        return int(hits[0]) if hits.size else None

    def rescan(self, r: int) -> None:
        self.nn[r] = int(np.argmin(self.DV[r]))
        self.nnd[r] = self.DV[r][self.nn[r]]

    def combine_columns(self, keep: int, drop: int, sk, sd, linkage: str) -> bool:
        """Fold slot ``drop`` into slot ``keep`` across every dirty row, then
        refresh nearest-neighbor caches (mirrors the hc maintenance rule).

        Returns True when any cached nearest neighbor changed — the replay
        uses this to keep its cross-iteration best-pair cache valid.
        """
        n = self.count
        if n == 0:
            return False
        newcol = lance_williams(self.DV[:n, keep], self.DV[:n, drop], sk, sd, linkage)
        self.DV[:n, keep] = newcol
        self.DV[:n, drop] = np.inf
        live = self.rep[:n] >= 0
        touched = live & ((self.nn[:n] == keep) | (self.nn[:n] == drop))
        changed = False
        for r in np.where(touched)[0]:
            self.rescan(r)
            changed = True
        others = live & ~touched
        # a fold can never go below the two source entries, so rows whose
        # neighbor was elsewhere only ever pick up an equal-distance,
        # smaller-index neighbor (the argmin first-occurrence rule)
        upd = others & (
            (newcol < self.nnd[:n])
            | ((newcol == self.nnd[:n]) & (keep < self.nn[:n]))
        )
        if upd.any():
            self.nn[:n][upd] = keep
            self.nnd[:n][upd] = newcol[upd]
            changed = True
        return changed

    def best(self) -> tuple[Optional[int], float]:
        """(row, distance) of the globally closest dirty pair.

        Equal-distance candidates are ordered by their sorted slot pair —
        the generic algorithm merges the pair whose smaller slot comes
        first (row-major argmin), then the smaller partner within it.
        """
        live = self.live()
        if live.size == 0:
            return None, np.inf
        d = self.nnd[live]
        m = d.min()
        if not np.isfinite(m):
            return None, np.inf
        cands = live[d == m]
        if cands.size > 1:  # ties only: order by sorted slot pair
            lo = np.minimum(self.rep[cands], self.nn[cands])
            hi = np.maximum(self.rep[cands], self.nn[cands])
            cands = cands[np.lexsort((hi, lo))]
        return int(cands[0]), float(m)


class _Forest:
    """Active clusters over leaf slots (slot id == smallest member leaf)."""

    def __init__(self, K: int, dirty_members: list[list[int]]):
        self.K = K
        self.active = np.ones(K, dtype=bool)
        self.size = np.ones(K, dtype=np.int64)
        self.rep_of_leaf = np.arange(K, dtype=np.int64)
        self.members: list[list[int]] = [[i] for i in range(K)]
        self.is_dirty = np.zeros(K, dtype=bool)
        for g in dirty_members:
            rep = min(g)
            self.members[rep] = sorted(g)
            self.size[rep] = len(g)
            self.is_dirty[rep] = True
            for leaf in g:
                self.rep_of_leaf[leaf] = rep
                if leaf != rep:
                    self.active[leaf] = False
        self.n_active = int(self.active.sum())

    def fold(self, keep: int, drop: int) -> None:
        self.members[keep].extend(self.members[drop])
        self.rep_of_leaf[np.asarray(self.members[drop], dtype=np.int64)] = keep
        self.size[keep] += self.size[drop]
        self.active[drop] = False
        self.n_active -= 1

    def aggregate_from(self, gather, members: list[int], linkage: str) -> np.ndarray:
        """Slot-level distance vector of a cluster from its leaf rows.

        ``gather(idx)`` returns the (len(idx), K) float64 leaf-distance rows
        of the requested members (the store's policy-routed
        ``gather_rows``); the shared :func:`repro_torch.core.hc.blocked_column_fold`
        requests them in fixed blocks, so the peak transient stays
        (block, K) under every memory tier and the columnwise fold
        (sum / min / max over leaf pairs — exact for the reducible linkages
        here) is arithmetic-identical no matter which tier served the rows.
        Inactive slots and the cluster's own slot come back inf.
        """
        mem = np.asarray(members, dtype=np.int64)
        m = mem.size
        col = blocked_column_fold(gather, mem, linkage)
        vec = np.full(self.K, np.inf, dtype=np.float64)
        if linkage == "average":
            acc = np.zeros(self.K, dtype=np.float64)
            np.add.at(acc, self.rep_of_leaf, col)
            vec[self.active] = acc[self.active] / (m * self.size[self.active])
        elif linkage == "single":
            acc = np.full(self.K, np.inf, dtype=np.float64)
            np.minimum.at(acc, self.rep_of_leaf, col)
            vec[self.active] = acc[self.active]
        else:  # complete
            acc = np.full(self.K, -np.inf, dtype=np.float64)
            np.maximum.at(acc, self.rep_of_leaf, col)
            vec[self.active] = acc[self.active]
        return vec


def _scan_clean_run(
    script: list[Merge],
    ptr: int,
    forest: "_Forest",
    d_d: float,
    beta: Optional[float],
    cap: int,
    linkage: str,
) -> int:
    """Length (>= 1) of the maximal en-bloc run of clean merges at ``ptr``.

    Entry ``ptr`` is already known applicable (the caller resolved the
    script-vs-dirty decision).  Subsequent entries extend the run while they
    are tombstone-free, both sides are clean and active (pre-run state is
    sufficient: within a clean run the only state change is deactivating
    drop slots, which the script never references again), strictly below the
    best dirty distance (clean folds never lower a dirty row's minimum, so
    ``d_d`` can only grow during the run — the gate stays valid), and inside
    the beta / target-count budget.  For average linkage the run additionally
    requires strictly increasing heights: tied heights fall back to the
    sequential Lance-Williams path, whose per-merge rounding the tied-merge
    order is pinned against.
    """
    S = len(script)
    L = 1
    prev_h = script[ptr][2]
    while L < cap and ptr + L < S:
        a, b, h = script[ptr + L]
        if b < 0:
            break
        if not (forest.active[a] and forest.active[b]):
            break
        if forest.is_dirty[a] or forest.is_dirty[b]:
            break
        if h >= d_d:
            break
        if beta is not None and h > beta:
            break
        if linkage == "average" and h <= prev_h:
            break
        prev_h = h
        L += 1
    return L


def _apply_run_enbloc(
    forest: "_Forest", dirty: _DirtyRows, entries: list[Merge], linkage: str
) -> bool:
    """Fold a run of clean script merges in one vectorized pass.

    Groups the run's folds by final surviving slot, then combines each
    group's dirty-row columns in one reduction: min/max for single/complete
    linkage (exactly associative, so bitwise-equal to the sequential fold)
    and a grouped weighted mean over pre-run sizes for average linkage
    (mathematically equal to the sequential Lance-Williams recursion, equal
    up to rounding in floats — which is why the caller's run scan splits
    average-linkage runs at tied heights).

    The nn caches are refreshed by a full rescan, which matches the
    sequential maintenance rule exactly whenever every live row's folded
    minimum is achieved at a unique column (clean folds never lower a row's
    minimum, so the sequential end state is "nnd = exact row minimum, nn =
    its unique argmin").  When any live row's minimum ties across columns,
    the sequential nn choice is history-dependent: this function rolls the
    fold back and returns False so the caller replays the run sequentially,
    preserving the pinned tie behavior bit for bit.
    """
    sources: dict[int, list[int]] = {}
    sizes0: dict[int, int] = {}
    for a, b, _h in entries:
        for s in (a, b):
            if s not in sizes0:
                sizes0[s] = int(forest.size[s])
        sub = sources.pop(b, [])
        sources.setdefault(a, []).append(b)
        sources[a].extend(sub)
    roots = list(sources)
    dropped = [s for srcs in sources.values() for s in srcs]

    n = dirty.count
    if n:
        DV = dirty.DV
        live = dirty.rep[:n] >= 0
        # one gather of every folded column, grouped contiguously by root,
        # then a single segmented reduction (reduceat) per linkage
        order: list[int] = []
        bounds = [0]
        for r in roots:
            order.append(r)
            order.extend(sources[r])
            bounds.append(len(order))
        touched_cols = np.asarray(order, dtype=np.int64)
        # advanced indexing: already a fresh copy, doubles as the rollback
        src_vals = DV[:n, touched_cols]
        seg = np.asarray(bounds[:-1], dtype=np.intp)
        if linkage == "single":
            newcols = np.minimum.reduceat(src_vals, seg, axis=1)
        elif linkage == "complete":
            newcols = np.maximum.reduceat(src_vals, seg, axis=1)
        else:
            w = np.asarray([sizes0[c] for c in order], dtype=np.float64)
            newcols = np.add.reduceat(src_vals * w, seg, axis=1)
            newcols /= np.add.reduceat(w, seg)
        # rows whose cached neighbor sits in a folded column must rescan;
        # any other live row's cache survives untouched under sequential
        # maintenance UNLESS a folded value lands exactly on its minimum
        # (clean folds never go below a row's minimum, and every
        # intermediate fold value that could hit it is a min/max/mean of
        # source-column values, so "some source or folded value == nnd" is
        # a conservative superset of all such sequences) — that ambiguity
        # falls back to the sequential path.
        col_mask = np.zeros(forest.K, dtype=bool)
        col_mask[touched_cols] = True
        touched = live & col_mask[dirty.nn[:n]]
        unt = np.where(live & ~touched)[0]
        if unt.size:
            nnd_u = dirty.nnd[unt, None]
            if (newcols[unt] <= nnd_u).any() or (src_vals[unt] <= nnd_u).any():
                return False
        DV[:n, dropped] = np.inf
        DV[:n, roots] = newcols
        t_rows = np.where(touched)[0]
        if t_rows.size:
            # rescan: with a unique row minimum this is exactly the
            # sequential end state; a tied minimum is history-dependent.
            sub = DV[t_rows]
            nn_t = sub.argmin(axis=1)
            m = np.take_along_axis(sub, nn_t[:, None], axis=1)[:, 0]
            fin = np.isfinite(m)
            if ((sub[fin] == m[fin, None]).sum(axis=1) > 1).any():
                DV[:n, touched_cols] = src_vals
                return False
            dirty.nn[t_rows] = nn_t
            dirty.nnd[t_rows] = m

    for a, b, _h in entries:
        forest.members[a].extend(forest.members[b])
        forest.size[a] += forest.size[b]
        forest.active[b] = False
    forest.n_active -= len(entries)
    for r in roots:
        forest.rep_of_leaf[np.asarray(forest.members[r], dtype=np.int64)] = r
    return True


def replay(
    store,
    script: list[Merge],
    dirty_members: list[list[int]],
    *,
    beta: Optional[float] = None,
    n_clusters: Optional[int] = None,
    linkage: str = "average",
) -> tuple[np.ndarray, list[Merge], ReplayStats]:
    """Re-derive the flat clustering after a membership change.

    ``store`` is the engine's :class:`CondensedDistances` over the *current*
    leaves (newcomer columns already appended / departed leaves already
    removed).  ``script`` is the cached merge sequence valid for the clean
    leaves (current numbering), possibly holding ``(rep, -1, h)`` tombstones
    from a departure rewrite; ``dirty_members`` the initially deviating
    clusters (newcomer singletons on admit, empty on depart).

    Returns ``(labels, new_script, stats)`` — canonical flat labels, the
    merge script of the new dendrogram (cache for the next operation), and
    replay telemetry.

    Parity guarantee: the labels equal a from-scratch
    :func:`~repro_torch.core.hc.merge_forest` run on the current store (oracle-exact
    up to the degenerate-tie caveats in the module docstring), bitwise
    independent of en-bloc folding and of the store's memory tier — replayed
    clean heights are bitwise the cached ones.
    """
    if (beta is None) == (n_clusters is None):
        raise ValueError("specify exactly one of beta / n_clusters")
    K = store.n
    stats = ReplayStats()
    if K == 0:
        return np.zeros(0, dtype=np.int64), [], stats
    forest = _Forest(K, dirty_members)
    dirty = _DirtyRows(K)

    # Leaf rows come through the store's memory policy (gather_rows): the
    # dense tier serves them from its cached read-only float32 view (built
    # adaptively once the cumulative gathered-row count crosses K/8 and
    # then kept warm across admissions by append_block), the banded tier
    # from the LRU hot-row window, condensed_only from strided gathers.
    # Every tier returns bitwise-identical float64 rows (float32 upcasts
    # are exact), so the replay's aggregation math — and the labels — are
    # tier-independent.
    store.memory.begin_op(store)

    def leaf_rows(idx: np.ndarray) -> np.ndarray:
        return store.gather_rows(idx)

    for g in dirty_members:
        rep = min(g)
        vec = forest.aggregate_from(leaf_rows, forest.members[rep], linkage)
        vec[rep] = np.inf
        dirty.add(rep, vec)

    # best-pair cache: dirty.best() only changes when a nearest-neighbor
    # cache does, so long clean-script runs reuse one lookup.
    best_cache: list = [None]

    def promote(rep: int) -> None:
        vec = forest.aggregate_from(leaf_rows, forest.members[rep], linkage)
        vec[rep] = np.inf
        forest.is_dirty[rep] = True
        dirty.add(rep, vec)
        best_cache[0] = None
        stats.promotions += 1

    out: list[Merge] = []
    target = 1 if n_clusters is None else max(int(n_clusters), 1)
    ptr, S = 0, len(script)
    # after a tie-hazard fallback, don't re-attempt en-bloc until the run
    # that triggered it has been consumed sequentially (avoids rescanning
    # the same run once per entry on degenerate inputs)
    skip_enbloc_until = 0

    while forest.n_active > target:
        # -- script front: drop entries broken by dirty merges, promoting
        # the surviving clean side (it no longer follows the script).
        if ptr < S:
            a, b, h_s = script[ptr]
            if b < 0:
                # tombstone from a departure: the old run merged this
                # cluster with departed clients at h_s — from here on it
                # deviates from the script.  (Promoting as the tombstone
                # reaches the front is exact: all its internal merges sit
                # earlier in the stream, and early promotion only adds
                # tracking, never changes merge order.)
                if forest.active[a] and not forest.is_dirty[a]:
                    promote(a)
                ptr += 1
                stats.script_dropped += 1
                continue
            ok_a = forest.active[a] and not forest.is_dirty[a]
            ok_b = forest.active[b] and not forest.is_dirty[b]
            if not (ok_a and ok_b):
                if ok_a:
                    promote(a)
                elif ok_b:
                    promote(b)
                ptr += 1
                stats.script_dropped += 1
                continue
        else:
            if n_clusters is not None:
                # The script was truncated at the OLD target, so beyond it
                # the minimum clean-clean distance is unknown — dirty pairs
                # may no longer be the global minimum.  Aggregate the small
                # remaining forest and finish with the generic loop (tail).
                break
            a = b = -1
            h_s = np.inf

        if best_cache[0] is None:
            best_cache[0] = dirty.best()
        r_best, d_d = best_cache[0]
        if beta is not None and min(h_s, d_d) > beta:
            break

        if r_best is not None and d_d == h_s:
            # Exact height tie between the script front (a, b) and the best
            # dirty pair: emulate the generic argmin — smaller first slot
            # wins, then the smaller partner within that row's candidates.
            dp = int(min(dirty.rep[r_best], dirty.nn[r_best]))
            dq = int(max(dirty.rep[r_best], dirty.nn[r_best]))
            take_dirty = (dp, dq) < (a, b)
        else:
            take_dirty = r_best is not None and d_d < h_s
        if not take_dirty:
            # -- cached merges apply verbatim (heights bitwise-cached).
            # Runs of consecutive clean entries fold en bloc: one vectorized
            # pass replaces per-entry numpy dispatch.
            L = 1
            if ptr < S and ptr >= skip_enbloc_until:
                L = _scan_clean_run(
                    script, ptr, forest, d_d, beta,
                    forest.n_active - target, linkage,
                )
            if L >= ENBLOC_MIN_RUN:
                run = script[ptr : ptr + L]
                if _apply_run_enbloc(forest, dirty, run, linkage):
                    out.extend(run)
                    ptr += L
                    stats.script_applied += L
                    stats.enbloc_runs += 1
                    stats.enbloc_entries += L
                    best_cache[0] = None
                    continue
                stats.enbloc_fallbacks += 1
                skip_enbloc_until = ptr + L
            sa, sb = int(forest.size[a]), int(forest.size[b])
            if dirty.combine_columns(a, b, sa, sb, linkage):
                best_cache[0] = None
            forest.fold(a, b)
            out.append((a, b, h_s))
            ptr += 1
            stats.script_applied += 1
            continue

        # -- dirty merge: Lance-Williams on insert.
        p = int(dirty.rep[r_best])
        q = int(dirty.nn[r_best])
        h = float(dirty.nnd[r_best])
        rq = dirty.row_of(q)
        if rq is None:  # absorbing a clean cluster: seed its vector
            vec_q = forest.aggregate_from(leaf_rows, forest.members[q], linkage)
            vec_q[q] = np.inf
        else:
            vec_q = dirty.DV[rq]
        sp, sq = int(forest.size[p]), int(forest.size[q])
        new_vec = lance_williams(dirty.DV[r_best], vec_q, sp, sq, linkage)
        keep, drop = (p, q) if p < q else (q, p)
        new_vec[keep] = new_vec[drop] = np.inf
        # other dirty rows fold their (p, q) slots first (consistent with the
        # symmetric column state), then the merged row takes the keep slot.
        dirty.combine_columns(keep, drop, sp if keep == p else sq,
                              sq if keep == p else sp, linkage)
        if rq is not None and rq != r_best:
            dirty.rep[rq] = -1
            dirty.nnd[rq] = np.inf
        dirty.DV[r_best] = new_vec
        dirty.rep[r_best] = keep
        dirty.rescan(r_best)
        forest.is_dirty[keep] = True
        forest.fold(keep, drop)
        out.append((keep, drop, h))
        best_cache[0] = None
        stats.dirty_merges += 1

    # -- n_clusters tail: script and tracked pairs exhausted but the target
    # needs more merges (possible after departure); aggregate the small
    # remaining forest and continue with the generic loop.
    if n_clusters is not None and forest.n_active > target:
        reps = sorted(np.where(forest.active)[0], key=lambda c: min(forest.members[c]))
        groups = [forest.members[r] for r in reps]
        # promote=False: this is a streaming full-forest scan — it must not
        # evict the banded tier's hot rows (and the blocked row arithmetic
        # is identical under every tier, keeping tail heights bitwise).
        Dc = cluster_distances_from_rows(
            lambda idx: store.gather_rows(idx, promote=False), groups, linkage
        )
        sizes = np.array([len(g) for g in groups], dtype=np.int64)
        active2, members2, merges2 = merge_forest(
            Dc, sizes, [list(g) for g in groups],
            n_clusters=target, linkage=linkage,
        )
        out.extend(merges2)
        stats.tail_merges = len(merges2)
        labels = labels_from_members(active2, members2, K)
        return labels, out, stats

    labels = labels_from_members(
        forest.active, forest.members, K
    )
    return labels, out, stats


def filter_script_for_depart(
    script: list[Merge], K: int, departing: np.ndarray
) -> list[Merge]:
    """Rewrite a cached script for a departure (old leaf numbering).

    Walks the script in application order with a union-find.  A merge whose
    subtree contains a departing leaf (or whose history was already broken)
    is dropped; if one side is an intact pure-remaining cluster, the drop
    leaves a *tombstone* entry ``(rep, -1, height)`` in the stream — the
    replay promotes that cluster to dirty when it reaches the tombstone,
    after all its internal (kept, lower-height) merges have applied.  Until
    that height the cluster behaved exactly per script in the old run, and
    the old run's global-minimum property guarantees it had no sub-height
    neighbor among unchanged clusters, so promoting at the tombstone is
    exact.  Kept merges touch only remaining leaves and stay exact after
    compaction.

    Returns the rewritten script in old leaf ids; the caller remaps reps
    onto the compacted numbering.
    """
    dep = np.zeros(K, dtype=bool)
    dep[np.asarray(departing, dtype=np.int64)] = True
    parent = np.arange(K, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return int(x)

    has_dep = dep.copy()
    broken = np.zeros(K, dtype=bool)
    kept: list[Merge] = []
    for a, b, h in script:
        ra, rb = find(a), find(b)
        bad_a = broken[ra] or has_dep[ra]
        bad_b = broken[rb] or has_dep[rb]
        root, other = (ra, rb) if ra < rb else (rb, ra)
        if not bad_a and not bad_b:
            kept.append((a, b, h))
        else:
            # at most one side is intact (pure-remaining with an unbroken
            # history); it deviates from the script from height h on
            if not bad_a:
                kept.append((a, -1, h))
            elif not bad_b:
                kept.append((b, -1, h))
            broken[root] = True
        parent[other] = root
        has_dep[root] = has_dep[ra] or has_dep[rb]
        broken[root] = broken[root] or broken[ra] or broken[rb]
    return kept
