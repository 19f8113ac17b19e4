"""The proximity kernel's any-rank route (p or q above 8) and PACFL at p = 16.

Above rank 8 the CUDA kernel runs on the same FP64 tensor-core tiles as at
small ranks: eq3 in chunks of 8 columns, each launch adding its angles into
the result in the reference's order, and eq2 in Gram pieces of at most
8 x 8 through a workspace that a runtime-rank reduce adds in split order and
diagonalizes (``eq2_plan``: pieces, splits of n, batches of tiles under a
workspace cap).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here, on the CPU:

* the plan covers every (pair, Gram entry r, s) and every row of n exactly
  once, square (upper-triangle tiles) and cross, at ragged K, and its tile
  batches cover every tile once within the workspace cap;
* ``proximity_eq2_schedule_ref`` / ``proximity_eq3_schedule_ref``, plain
  emulations of the kernel's schedules, agree with the reference's
  ``proximity_matrix(..., backend="jnp")`` / ``cross_proximity`` and its
  Pallas kernel (interpret mode, eq3) within ``TOL_DEG`` = 1e-3 degrees;
* the port's ``one_shot_clustering`` at p = 16 gives the reference's labels
  bitwise, and so does its clustering of the same float32 signatures.

Inputs are made with numpy from a seed and fed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import angles as ref_angles
from repro.core.pacfl import PACFLConfig as RefConfig
from repro.core.pacfl import cluster_clients as ref_cluster_clients
from repro.core.pacfl import one_shot_clustering as ref_one_shot
from repro.kernels.proximity.proximity import proximity_pallas
from repro_torch import convert
from repro_torch.core.angles import _hygiene
from repro_torch.core.pacfl import cluster_clients, one_shot_clustering
from repro_torch.kernels._build import H100_SMS
from repro_torch.kernels.proximity.proximity import (
    EQ2_K_STEP,
    EQ2_TILE,
    EQ2_WORKSPACE_BYTES,
    MAX_TC_RANK,
    REDUCE_ANY_JOBS,
    SMEM_BYTES,
    eq2_chunks,
    eq2_plan,
    proximity_plain,
    proximity_route,
    reduce_any_smem,
    triangle_tile,
)
from repro_torch.kernels.proximity.ref import (
    proximity_eq2_schedule_ref,
    proximity_eq3_schedule_ref,
)

TOL_DEG = 1e-3

# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    (K, p, q, n, form)
    for K in (1, 33, 97, 1000)
    for p, q in ((9, 9), (12, 12), (16, 16), (3, 12), (12, 3))
    for n in (200, 3072)
    for form in ("square", "cross")
    if form == "cross" or p == q
]


def _tile_of(plan, x, Kb):
    return triangle_tile(x) if plan.sym else divmod(x, -(-Kb // EQ2_TILE))


@pytest.mark.parametrize("K,p,q,n,form", PLAN_CASES)
def test_any_rank_plan_covers_every_pair_entry_and_row_once(K, p, q, n, form):
    """Batches x tiles x pieces x row groups x splits is the grid.  The
    square covers each unordered pair (a <= b) once, C[b, a] coming from
    the second epilogue; the cross (against 37 clients) each ordered pair.
    Every piece is at most 8 x 8 (a template instantiation), and together
    the pieces cover the p x q Gram once."""
    Ka, Kb = (K, K) if form == "square" else (K, 37)
    plan = eq2_plan(Ka, Kb, n, p, q, sym=form == "square")
    assert plan.any_rank and plan.workspace
    pairs = np.zeros((Ka, Kb), dtype=np.int64)
    tiles = [x for batch in plan.batches() for x in batch]
    assert tiles == list(range(plan.tiles))
    for x in tiles:
        bi, bj = _tile_of(plan, x, Kb)
        a = np.arange(bi * EQ2_TILE, min((bi + 1) * EQ2_TILE, Ka))
        b = np.arange(bj * EQ2_TILE, min((bj + 1) * EQ2_TILE, Kb))
        assert a.size and b.size, "a tile past the clients"
        done = np.ones((a.size, b.size), dtype=np.int64)
        if plan.sym and bi == bj:
            done = np.triu(done)   # the diagonal tile computes a <= b only
        pairs[a[0]:a[-1] + 1, b[0]:b[-1] + 1] += done
    want = np.triu(np.ones((Ka, Kb), dtype=np.int64)) if plan.sym else 1
    assert (pairs == want).all()
    entries = np.zeros((p, q), dtype=np.int64)
    for pc in plan.pieces():
        assert 1 <= pc.rows <= MAX_TC_RANK and 1 <= pc.cols <= MAX_TC_RANK
        assert pc.rows % pc.row_group == 0
        assert pc.blocks <= 65535   # the grid's z dimension
        for i in range(pc.row_chunks):
            for j in range(pc.col_chunks):
                r0, s0 = pc.r_base + i * pc.rows, pc.s_base + j * pc.cols
                for grp in range(pc.groups):
                    rows = slice(r0 + grp * pc.row_group, r0 + (grp + 1) * pc.row_group)
                    entries[rows, s0:s0 + pc.cols] += 1
    assert (entries == 1).all()
    rows = np.zeros(n, dtype=np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.split_rows, min((s + 1) * plan.split_rows, n)
        assert lo < n, "a split past n"
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert plan.split_rows % EQ2_K_STEP == 0
    blocks = plan.tiles * sum(pc.blocks for pc in plan.pieces())
    if plan.splits > 1:
        assert blocks * plan.splits <= H100_SMS   # one wave
    assert plan.workspace_doubles() * 8 <= max(
        EQ2_WORKSPACE_BYTES, plan.splits * plan.entries * EQ2_TILE ** 2 * 8)
    # a tile's rows hold its Gram, and (two floats a double) the reduce's
    # packed q x q matrices, one an epilogue
    epilogues = (2 if plan.sym else 1) * EQ2_TILE ** 2
    assert plan.entries >= p * q
    assert 2 * plan.entries * EQ2_TILE ** 2 >= q * (q + 1) // 2 * epilogues
    jobs = plan.reduce_jobs
    assert 1 <= jobs <= REDUCE_ANY_JOBS and (not plan.sym or jobs % 2 == 0)
    assert reduce_any_smem(p, q, jobs, plan.sym) <= SMEM_BYTES
    assert (EQ2_TILE ** 2) % (jobs // 2 if plan.sym else jobs) == 0


@pytest.mark.parametrize("cap", [1 << 20, 5 << 20, 64 << 20, EQ2_WORKSPACE_BYTES])
def test_tile_batches_cover_every_tile_once_under_the_cap(cap):
    """PACFL's square at p = 16 (528 tiles of 2 MiB) under several caps:
    equal batches, each tile in one of them, the workspace within the cap."""
    plan = eq2_plan(1024, 1024, 3072, 16, 16, sym=True, workspace_bytes=cap)
    per_tile = plan.splits * 16 * 16 * EQ2_TILE ** 2 * 8
    assert per_tile == 2 << 20
    assert plan.workspace_doubles() * 8 <= max(cap, per_tile)
    batches = plan.batches()
    assert [x for b in batches for x in b] == list(range(plan.tiles))
    assert len(batches) == -(-plan.tiles // max(1, cap // per_tile))
    assert max(map(len, batches)) - min(map(len, batches)) <= len(batches)


def test_any_rank_plan_at_the_smoke_shapes():
    """K = 1024, n = 3072: p = 16 and p = 12 squares and the 1024 x 256
    cross block at p = 3 x q = 12 fill the card without splitting n; the
    p = 16 square runs its 528 triangle tiles in 3 batches of 176 tiles
    (352 MiB of workspace); ranks up to 8 keep their single-piece plan, and
    at p = q = 8 (8 row groups, a 264 MiB workspace) one batch."""
    sq16 = eq2_plan(1024, 1024, 3072, 16, 16, sym=True)
    assert (sq16.tiles, sq16.splits, sq16.batch_tiles, len(sq16.batches())) == (528, 1, 176, 3)
    assert sq16.workspace_doubles() * 8 == 176 * 2 << 20
    assert (sq16.chunk_p, sq16.chunk_q) == eq2_chunks(16, 16) == (3, 4)
    assert sq16.reduce_jobs == REDUCE_ANY_JOBS
    sq12 = eq2_plan(1024, 1024, 3072, 12, 12, sym=True)
    assert (sq12.splits, len(sq12.pieces())) == (1, 1)
    cross = eq2_plan(1024, 256, 3072, 3, 12, sym=False)
    assert (cross.tiles, cross.splits, cross.chunk_p, len(cross.batches())) == (256, 1, 3, 1)
    small = eq2_plan(1024, 1024, 3072, 3, 3, sym=True)
    assert not small.any_rank and not small.workspace and small.batch_tiles == small.tiles
    assert small.reduce_jobs == 0
    eight = eq2_plan(1024, 1024, 3072, 8, 8, sym=True)
    assert (eight.groups, eight.batch_tiles, eight.any_rank) == (8, eight.tiles, False)
    for p in range(1, MAX_TC_RANK + 1):
        assert eq2_chunks(p, MAX_TC_RANK) == (p, MAX_TC_RANK)


def test_route_keys():
    assert proximity_route(3, 3, "eq3") == "eq3"
    assert proximity_route(8, 8, "eq2") == "eq2"
    assert proximity_route(16, 16, "eq3") == "eq3_any_rank"
    assert proximity_route(3, 12, "eq2") == "eq2_any_rank"


# ---------------------------------------------------------------------------
# the schedules against the reference
# ---------------------------------------------------------------------------


def _planted(K, n, p, seed, noise_seed=None, n_bases=3, spread=0.1, rank=None):
    """K orthonormal (n, p) bases, each a perturbed copy of the first p
    columns of one of n_bases planted (n, rank) subspaces: within-subspace
    angles of a few degrees."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(rng.normal(size=(n, rank or p)))[0][:, :p] for _ in range(n_bases)]
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    return np.stack([
        np.linalg.qr(bases[k % n_bases] + spread / np.sqrt(n) * rng.normal(size=(n, p)))[0]
        for k in range(K)
    ]).astype(np.float32)


# (K, n, p, sm_count, workspace cap): one split and one batch; n split into
# a wave (as at small K on the card); the tiles in batches
SQUARE_CASES = [(40, 96, 9, H100_SMS, EQ2_WORKSPACE_BYTES), (40, 96, 12, 528, EQ2_WORKSPACE_BYTES),
                (40, 96, 16, H100_SMS, 1 << 20), (20, 160, 16, H100_SMS, EQ2_WORKSPACE_BYTES)]


@pytest.mark.parametrize("K,n,p,sms,cap", SQUARE_CASES)
def test_eq2_schedule_square_matches_reference(K, n, p, sms, cap):
    U = _planted(K, n, p, seed=K + n + p)
    t = torch.from_numpy(U)
    raw = proximity_eq2_schedule_ref(t, t, sm_count=sms, workspace_bytes=cap)
    assert torch.isfinite(raw).all()
    got = _hygiene(raw).numpy()
    want = np.asarray(ref_angles.proximity_matrix(jnp.asarray(U), "eq2", backend="jnp"))
    np.testing.assert_allclose(got, want, atol=TOL_DEG)
    oracle = np.asarray(ref_angles.proximity_matrix(jnp.asarray(U), "eq2", backend="jnp",
                                                     eq2_solver="svd"))
    np.testing.assert_allclose(got, oracle, atol=TOL_DEG)
    within = np.array([[a != b and a % 3 == b % 3 for b in range(K)] for a in range(K)])
    assert got[within].max() < 12.0 < got[~within & ~np.eye(K, dtype=bool)].min()


@pytest.mark.parametrize("Ka,Kb,p,q", [(33, 9, 3, 12), (9, 33, 12, 3), (40, 7, 16, 9)])
def test_eq2_schedule_cross_matches_reference(Ka, Kb, p, q):
    """Both stacks perturb the same planted subspaces (ranks p and q of one
    rank-max(p, q) basis), with their own noise."""
    n, rank = 96, max(p, q)
    Ua = _planted(Ka, n, p, seed=Ka + n, noise_seed=1, rank=rank)
    Ub = _planted(Kb, n, q, seed=Ka + n, noise_seed=2, rank=rank)
    got = proximity_eq2_schedule_ref(torch.from_numpy(Ua), torch.from_numpy(Ub)).numpy()
    want = np.asarray(ref_angles.cross_proximity(jnp.asarray(Ua), jnp.asarray(Ub), "eq2",
                                                 backend="jnp"))
    assert got.shape == (Ka, Kb) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL_DEG)


@pytest.mark.parametrize("p", [9, 12, 16])
def test_eq3_schedule_matches_reference_kernel(p):
    """Chunks of 8 columns, the float32 sum continued across launches: the
    square against the reference's Pallas kernel (interpret mode) and its
    ``jnp`` backend, a cross block against ``cross_proximity``."""
    U = _planted(13, 64, p, seed=p)
    t = torch.from_numpy(U)
    got = _hygiene(proximity_eq3_schedule_ref(t, t)).numpy()
    pallas = np.asarray(proximity_pallas(jnp.asarray(U), measure="eq3"))
    dense = np.asarray(ref_angles.proximity_matrix(jnp.asarray(U), "eq3", backend="jnp"))
    np.testing.assert_allclose(got, pallas, atol=TOL_DEG)
    np.testing.assert_allclose(got, dense, atol=TOL_DEG)
    V = _planted(5, 64, p, seed=p, noise_seed=7)
    got_c = proximity_eq3_schedule_ref(t, torch.from_numpy(V)).numpy()
    want_c = np.asarray(ref_angles.cross_proximity(jnp.asarray(U), jnp.asarray(V), "eq3",
                                                   backend="jnp"))
    np.testing.assert_allclose(got_c, want_c, atol=TOL_DEG)


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_schedules_match_the_plain_twin(measure):
    """The emulated schedules and ``proximity_plain`` (the CPU path of the
    wrapper) compute one function: within the float32 floor of each other."""
    U = torch.from_numpy(_planted(37, 80, 16, seed=3))
    sched = proximity_eq3_schedule_ref if measure == "eq3" else proximity_eq2_schedule_ref
    got = _hygiene(sched(U, U))
    want = _hygiene(proximity_plain(U, U, measure))
    assert (got - want).abs().max().item() <= TOL_DEG


# ---------------------------------------------------------------------------
# PACFL at p = 16
# ---------------------------------------------------------------------------

N, P, K, N_BASES = 64, 16, 24, 4
SPECTRUM = np.geomspace(40.0, 1.0, P)


def _federation(seed):
    """Ragged clients on N_BASES planted rank-16 subspaces with a decaying
    16-value spectrum (distinct singular values keep eq3's identically
    ordered pairs stable)."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(np.random.default_rng(200 + b).normal(size=(N, P)))[0]
             for b in range(N_BASES)]
    data = []
    for k in range(K):
        M = int(rng.integers(150, 250))
        Bk = np.linalg.qr(bases[k % N_BASES] + 0.1 / np.sqrt(N) * rng.normal(size=(N, P)))[0]
        coef = SPECTRUM[:, None] * rng.normal(size=(P, M))
        data.append((Bk @ coef + 0.02 * rng.normal(size=(N, M))).astype(np.float32))
    return data


# planted: within-cluster eq3 ~230-420 deg and eq2 ~2.6-3.9, between > 1300 / 28
BETA = {"eq3": 800.0, "eq2": 15.0}


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_one_shot_clustering_at_p16_matches_reference(measure):
    data = _federation(0)
    ref_cfg = RefConfig(p=P, measure=measure, svd_method="exact", beta=BETA[measure],
                        proximity_backend="jnp")
    cfg = dataclasses.replace(convert.config_from_reference(dataclasses.asdict(ref_cfg)),
                              proximity_backend="kernel")
    ref = ref_one_shot([jnp.asarray(D) for D in data], ref_cfg)
    port = one_shot_clustering(data, cfg, device="cpu")
    assert port.U.shape == (K, N, P)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.n_clusters == N_BASES
    truth = np.arange(K) % N_BASES
    assert len(set(zip(port.labels.tolist(), truth.tolist()))) == N_BASES
    # the same float32 signatures, clustered by both packages (the two
    # packages' exact SVDs differ by rounding, which a sum of 16 angles of
    # ~85 degrees carries past 1e-3 between clusters)
    U = np.asarray(port.U)
    same_ref = ref_cluster_clients(jnp.asarray(U), ref_cfg)
    same_port = cluster_clients(torch.from_numpy(U), cfg, device="cpu")
    np.testing.assert_allclose(same_port.A, np.asarray(same_ref.A), atol=TOL_DEG)
    np.testing.assert_array_equal(same_port.labels, same_ref.labels)
    off = ~np.eye(K, dtype=bool)
    within = (truth[:, None] == truth[None, :]) & off
    A = np.asarray(same_port.A)
    assert A[within].max() < BETA[measure] < A[~(truth[:, None] == truth[None, :])].min()
