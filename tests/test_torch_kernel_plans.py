"""Host-side plans and the split-KV merge of the port's redesigned kernels.

The bfloat16 flash-attention kernel splits the keys of a decode-sized call
over several blocks and merges their partial softmax states; the tsgemm
kernel splits ``k`` of its short-m products.  Both plans are pure host
functions, tested here on the CPU: every key (or ``k``) index is covered
exactly once, no split is out of range, and at the main path's shapes the
split fills the card (H100: 132 SMs).

The WKV kernel's route plan (``wkv_plan``: the recurrent kernel for short
sequences and decode, chunks for prefill) must cover every time step
exactly once, and the proximity kernel's symmetric eq3 grid
(``triangle_tile``) every unordered pair of client tiles exactly once.

The eq2 proximity kernel's plan (``eq2_plan``: 32 x 32 pair tiles, the
upper triangle for a square, Gram rows in register-sized groups, n split
where the tiles cannot fill the card) must cover every (pair, Gram entry,
row of n) exactly once, for the square (unordered pairs) and the cross;
at the FL path's K = 97 it fills one wave of the card's 132 SMs (one
block an SM), at K = 1024 it takes no split.  ``proximity_eq2_schedule_ref`` follows the kernel's schedule in
plain PyTorch (FP64 partial Grams per split, added in split order, both
Jacobi epilogues on the triangle); on numpy-seeded signatures with planted
near-identical subspaces (angles of 5-9 degrees) it agrees with the
reference's Pallas kernel (interpret mode) and ``measure_pair`` within
``TOL_DEG`` = 1e-3 degrees.

``merge_partials`` is the formula of the kernel's combine step, in plain
PyTorch beside the twin.  Partial states from ``attention_partials`` over a
plan's key ranges, merged, must equal the reference's ``attention_ref``
(JAX, float32) within 2e-5, the flash tolerance of ``tests/test_kernels.py``,
on the cases of ``tests/test_torch_flash_attention.py`` and on decode cases
with an empty split, a fully masked split and rows with no valid key.
Inputs are numpy-seeded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.measures import measure_pair as ref_measure_pair
from repro.kernels.flash_attention import attention_ref as ref_attention_ref
from repro.kernels.proximity.proximity import proximity_pallas
from repro_torch.core.angles import _hygiene
from repro_torch.kernels._build import H100_SMS
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_SPLITS,
    TC_KEYS,
    split_plan,
    tc_rows_per_block,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    attention_partials,
    attention_ref,
    merge_partials,
)
from repro_torch.kernels.proximity.proximity import (
    EQ2_DOUBLES,
    EQ2_K_STEP,
    EQ2_MIN_SPLIT_ROWS,
    EQ2_TILE,
    EQ3_TILE,
    eq2_plan,
    eq2_row_group,
    triangle_tile,
    triangle_tiles,
)
from repro_torch.kernels.proximity.ref import proximity_eq2_schedule_ref
from repro_torch.kernels.tsgemm.tsgemm import SLABS, TS_K, TS_ROWS, split_k_plan
from repro_torch.kernels.wkv.wkv import CHUNK, CHUNKED_MIN_S, SUB_BLOCK, WkvPlan, wkv_plan

F32_TOL = 2e-5

# (B, Sq, Skv, Hq, Hkv, hd): the serving path's prefill and decode
# (tinyllama-1.1b, llama3.2-3b), the card tests' shapes, and edge cases.
FLASH_SHAPES = [
    (4, 1024, 1024, 32, 4, 64), (4, 1, 1056, 32, 4, 64), (4, 1024, 1024, 24, 8, 128),
    (4, 1, 1056, 24, 8, 128), (4, 1, 1000, 32, 4, 64), (1, 1, 1, 8, 1, 16),
    (1, 32, 128, 8, 8, 16), (2, 13, 77, 8, 2, 64), (1, 1, 100_000, 8, 1, 128),
    (64, 1, 4096, 32, 8, 128), (1, 5, 40, 4, 4, 128), (2, 64, 64, 4, 2, 32),
]


def _flash_blocks(B, Sq, Hq, Hkv, hd):
    rows = Sq * (Hq // Hkv)
    return -(-rows // tc_rows_per_block(hd, rows)) * Hkv * B


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd", FLASH_SHAPES)
def test_flash_split_plan_covers_every_key_once(B, Sq, Skv, Hq, Hkv, hd):
    nsplit, split_len = split_plan(B, Sq, Skv, Hq, Hkv, hd)
    assert 1 <= nsplit <= MAX_SPLITS
    covered = np.zeros(Skv, dtype=np.int64)
    for s in range(nsplit):
        lo, hi = s * split_len, min((s + 1) * split_len, Skv)
        assert lo < Skv, "a split past the keys"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if nsplit > 1:
        assert split_len % TC_KEYS == 0   # whole key tiles
        # only when the unsplit grid holds fewer than two blocks per SM
        assert _flash_blocks(B, Sq, Hq, Hkv, hd) < 2 * H100_SMS


def test_flash_split_plan_fills_the_card_at_decode():
    """tinyllama-1.1b decode (batch 4, one query, 1056-slot cache): 16 blocks
    unsplit; the plan reaches two blocks per SM with one tile per split."""
    B, Sq, Skv, Hq, Hkv, hd = 4, 1, 1056, 32, 4, 64
    nsplit, split_len = split_plan(B, Sq, Skv, Hq, Hkv, hd)
    blocks = _flash_blocks(B, Sq, Hq, Hkv, hd)
    assert blocks == 16
    assert nsplit * blocks >= 2 * H100_SMS
    assert (nsplit, split_len) == (17, TC_KEYS)
    # llama3.2-3b decode: 32 blocks unsplit
    assert split_plan(4, 1, 1056, 24, 8, 128)[0] * 32 >= 2 * H100_SMS


def test_flash_split_plan_leaves_prefill_whole():
    assert split_plan(4, 1024, 1024, 32, 4, 64) == (1, 1024)
    assert split_plan(4, 1024, 1024, 24, 8, 128) == (1, 1024)


def test_flash_split_plan_follows_the_sm_count():
    one = split_plan(4, 1, 1056, 32, 4, 64, sm_count=8)
    assert one == (1, 1056)   # 16 blocks already fill 8 SMs twice
    assert split_plan(4, 1, 1056, 32, 4, 64, sm_count=264)[0] == 17   # one tile each


TS_SHAPES = [
    # (Bt, m, k, p): the SVD's sketch products at both buckets (D @ Omega,
    # D^T @ Q; Q^T @ D runs transposed as D^T @ Q), a ragged chunk, the card
    # tests' shapes and edge cases
    (64, 3072, 512, 11), (64, 512, 3072, 11), (64, 3072, 1024, 11), (64, 1024, 3072, 11),
    (64, 512, 3000, 11), (5, 512, 3072, 11), (1, 128, 128, 8), (3, 512, 300, 10),
    (2, 1000, 768, 13), (4, 50, 40, 3), (2, 300, 700, 11), (5, 257, 33, 20),
    (1, 1, 1, 1), (1, 7, 100_000, 17), (2, 128, 129, 16),
]


@pytest.mark.parametrize("Bt,m,k,p", TS_SHAPES)
def test_tsgemm_plan_covers_every_k_once(Bt, m, k, p):
    slab, n_slabs, nsplit, split_len = split_k_plan(Bt, m, k, p)
    assert slab in SLABS and slab * n_slabs >= p
    assert slab - 4 < -(-p // n_slabs) <= slab   # the slab fits p: < 4 columns of padding
    assert nsplit >= 1
    covered = np.zeros(k, dtype=np.int64)
    for s in range(nsplit):
        lo, hi = s * split_len, min((s + 1) * split_len, k)
        assert lo < k, "a split past k"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if nsplit > 1:
        assert split_len % TS_K == 0 and split_len >= 4 * TS_K
        assert -(-m // TS_ROWS) * n_slabs * Bt < 4 * H100_SMS


def test_tsgemm_plan_at_the_main_path_shapes():
    # D^T @ Q, bucket 512: 256 blocks unsplit -> three splits of 1024
    slab, n_slabs, nsplit, split_len = split_k_plan(64, 512, 3072, 11)
    assert (slab, n_slabs, nsplit, split_len) == (12, 1, 3, 1024)
    assert (512 // TS_ROWS) * 64 * nsplit >= 4 * H100_SMS
    # D @ Omega: 1536 blocks, no split; p = 11 takes a 12-wide slab
    assert split_k_plan(64, 3072, 512, 11) == (12, 1, 1, 512)
    assert split_k_plan(64, 3072, 1024, 11) == (12, 1, 1, 1024)
    # bucket 1024: 512 blocks -> two splits
    assert split_k_plan(64, 1024, 3072, 11)[2:] == (2, 1536)
    # wide B tiles over slabs of at most 16
    assert split_k_plan(2, 300, 700, 20)[:2] == (12, 2)


@pytest.mark.parametrize("S", [1, 2, 15, CHUNKED_MIN_S - 1, CHUNKED_MIN_S, 63, 64, 65, 100,
                               1024, 1056, 4097])
def test_wkv_plan_covers_every_step_once(S):
    plan = wkv_plan(S)
    assert plan.route == ("recurrent" if S < CHUNKED_MIN_S else "chunked")
    covered = np.zeros(S, dtype=np.int64)
    for c in range(plan.n_chunks):
        lo, hi = c * plan.chunk, min((c + 1) * plan.chunk, S)
        assert lo < S, "a chunk past the sequence"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if plan.route == "chunked":
        assert plan.chunk % SUB_BLOCK == 0


def test_wkv_plan_routes():
    assert wkv_plan(1) == WkvPlan("recurrent", 1, 1)            # decode
    assert wkv_plan(1024) == WkvPlan("chunked", CHUNK, 1024 // CHUNK)   # rwkv6 prefill
    assert wkv_plan(CHUNKED_MIN_S - 1).route == "recurrent"
    assert CHUNK % SUB_BLOCK == 0
    with pytest.raises(ValueError):
        wkv_plan(0)


@pytest.mark.parametrize("K", [1, 2, 31, 32, 33, 37, 63, 64, 65, 100, 513, 1000, 1023, 1024,
                               2048, 8192])
def test_triangle_tiles_cover_every_unordered_pair_once(K):
    nt = -(-K // EQ3_TILE)
    seen = np.zeros((nt, nt), dtype=np.int64)
    for x in range(triangle_tiles(K)):
        bi, bj = triangle_tile(x)
        assert 0 <= bi <= bj < nt
        seen[bi, bj] += 1
    assert (np.triu(seen) == np.triu(np.ones_like(seen))).all()
    assert (np.tril(seen, -1) == 0).all()


def test_triangle_tile_at_large_indices():
    """The square-root guess is corrected exactly where float rounding
    could put it one column off."""
    for j in (1000, 46340, 10**6, 3 * 10**7):
        first = j * (j + 1) // 2
        assert triangle_tile(first) == (0, j)
        assert triangle_tile(first - 1) == (j - 1, j - 1)
        assert triangle_tile(first + j) == (j, j)


# ---------------------------------------------------------------------------
# eq2 proximity plan and schedule
# ---------------------------------------------------------------------------

TOL_DEG = 1e-3
EQ2_PLAN_CASES = [
    (K, p, q, n, form)
    for K in (1, 31, 32, 97, 1024)
    for p, q in ((1, 1), (3, 3), (3, 5), (8, 8))
    for n in (16, 3072)
    for form in ("square", "cross")
    if form == "cross" or p == q
]


def _eq2_tile_of(plan, x, Kb):
    return triangle_tile(x) if plan.sym else divmod(x, -(-Kb // EQ2_TILE))


@pytest.mark.parametrize("K,p,q,n,form", EQ2_PLAN_CASES)
def test_eq2_plan_covers_every_pair_entry_and_row_once(K, p, q, n, form):
    """Tiles x groups x splits is the grid; each block covers its tile's
    pairs, its group's Gram rows and its split's rows of n.  The square
    covers each unordered pair (a <= b) once, C[b, a] coming from the
    second epilogue; the cross (against 37 clients) each ordered pair."""
    Ka, Kb = (K, K) if form == "square" else (K, 37)
    plan = eq2_plan(Ka, Kb, n, p, q, sym=form == "square")
    pairs = np.zeros((Ka, Kb), dtype=np.int64)
    for x in range(plan.tiles):
        bi, bj = _eq2_tile_of(plan, x, Kb)
        a = np.arange(bi * EQ2_TILE, min((bi + 1) * EQ2_TILE, Ka))
        b = np.arange(bj * EQ2_TILE, min((bj + 1) * EQ2_TILE, Kb))
        assert a.size and b.size, "a tile past the clients"
        done = np.ones((a.size, b.size), dtype=np.int64)
        if plan.sym and bi == bj:
            done = np.triu(done)   # the diagonal tile computes a <= b only
        pairs[a[0]:a[-1] + 1, b[0]:b[-1] + 1] += done
    want = np.triu(np.ones((Ka, Kb), dtype=np.int64)) if plan.sym else 1
    assert (pairs == want).all()
    entries = np.zeros(p, dtype=np.int64)
    for grp in range(plan.groups):
        entries[grp * plan.row_group:(grp + 1) * plan.row_group] += 1
    assert (entries == 1).all()
    rows = np.zeros(n, dtype=np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.split_rows, min((s + 1) * plan.split_rows, n)
        assert lo < n, "a split past n"
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert plan.split_rows % EQ2_K_STEP == 0
    if plan.splits > 1:
        # one wave of blocks (one per SM), as full as the rows allow
        wave = H100_SMS // (plan.tiles * plan.groups)
        assert plan.split_rows >= EQ2_MIN_SPLIT_ROWS
        assert plan.splits <= wave
        assert plan.split_rows == EQ2_MIN_SPLIT_ROWS or (
            plan.split_rows - EQ2_K_STEP) * wave < n   # one step fewer would need more splits
    assert plan.workspace == (plan.splits > 1 or plan.groups > 1)
    assert plan.workspace_doubles() == (
        plan.splits * plan.batch_tiles * p * q * EQ2_TILE ** 2 if plan.workspace else 0)


def test_eq2_plan_at_the_fl_path_shapes():
    """mix4's square (K = 97): 10 triangle tiles, split 13 ways over n =
    3072 into one wave of 130 blocks on the 132 SMs; the churn admission's
    93 x 8 cross block and 8 x 8 square split too (the square down to the
    fewest rows a split takes); PACFL's K = 1024 square takes one kernel,
    no workspace."""
    sq97 = eq2_plan(97, 97, 3072, 3, 3, sym=True)
    assert (sq97.tiles, sq97.groups, sq97.splits, sq97.split_rows) == (10, 1, 13, 240)
    assert H100_SMS - 10 < sq97.tiles * sq97.splits <= H100_SMS
    cross = eq2_plan(93, 8, 3072, 3, 3, sym=False)
    assert (cross.tiles, cross.splits, cross.split_rows) == (3, 39, 80)
    square8 = eq2_plan(8, 8, 3072, 3, 3, sym=True)   # one tile: splits of the fewest rows
    assert (square8.tiles, square8.splits, square8.split_rows) == (1, 48, EQ2_MIN_SPLIT_ROWS)
    big = eq2_plan(1024, 1024, 3072, 3, 3, sym=True)
    assert (big.tiles, big.splits, big.workspace) == (528, 1, False)
    assert eq2_plan(97, 97, 3072, 3, 3, sym=True, sm_count=8).splits == 1
    with pytest.raises(ValueError):
        eq2_plan(97, 96, 3072, 3, 3, sym=True)


@pytest.mark.parametrize("p", range(1, 9))
def test_eq2_row_group_fits_the_register_budget(p):
    for q in range(1, 9):
        rg = eq2_row_group(p, q)
        assert p % rg == 0
        assert rg == 1 or 4 * rg * q + 4 * q + 8 <= EQ2_DOUBLES
        # no larger divisor of p would fit
        assert all(4 * d * q + 4 * q + 8 > EQ2_DOUBLES
                   for d in range(rg + 1, p + 1) if p % d == 0)
    assert eq2_row_group(3, 3) == 3   # the FL path's rank: one group, in registers


def _planted_signatures(K, n, p, seed, noise_seed=None, n_bases=3, spread=0.1, rank=None):
    """K orthonormal (n, p) bases, each a perturbed copy of the first p
    columns of one of n_bases planted (n, rank) subspaces (from ``seed``;
    the perturbation from ``noise_seed``): angles within a planted subspace
    of 5-9 degrees."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(rng.normal(size=(n, rank or p)))[0][:, :p] for _ in range(n_bases)]
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    return np.stack([
        np.linalg.qr(bases[k % n_bases] + spread / np.sqrt(n) * rng.normal(size=(n, p)))[0]
        for k in range(K)
    ]).astype(np.float32)


@pytest.mark.parametrize("K,n,p", [(40, 512, 3), (13, 500, 3), (33, 300, 5), (9, 256, 1)])
def test_eq2_schedule_square_matches_reference(K, n, p):
    U = _planted_signatures(K, n, p, seed=K + n + p)
    plan = eq2_plan(K, K, n, p, p, sym=True)
    assert plan.splits > 1   # the schedule under test splits n
    t = torch.from_numpy(U)
    raw = proximity_eq2_schedule_ref(t, t)
    got = _hygiene(raw).numpy()
    pallas = np.asarray(proximity_pallas(jnp.asarray(U), measure="eq2"))
    pair = np.array(ref_measure_pair(jnp.asarray(U), jnp.asarray(U), "eq2"))
    off = ~np.eye(K, dtype=bool)
    np.testing.assert_allclose(got, pallas, atol=TOL_DEG)
    np.testing.assert_allclose(got[off], pair[off], atol=TOL_DEG)
    # the two epilogues of a pair are two Jacobis, not one mirrored value
    assert np.isfinite(raw.numpy()).all()
    within = np.array([[a != b and a % 3 == b % 3 for b in range(K)] for a in range(K)])
    if p > 1:
        assert 3.0 < got[within].min() and got[within].max() < 12.0


@pytest.mark.parametrize("Ka,Kb,n,p,q", [(40, 7, 512, 3, 3), (9, 33, 300, 3, 5),
                                          (30, 2, 700, 2, 3)])
def test_eq2_schedule_cross_matches_reference(Ka, Kb, n, p, q):
    """Both stacks perturb the same planted subspaces (ranks p and q of one
    rank-max(p, q) basis), with their own noise."""
    rank = max(p, q)
    Ua = _planted_signatures(Ka, n, p, seed=Ka + n, noise_seed=1, rank=rank)
    Ub = _planted_signatures(Kb, n, q, seed=Ka + n, noise_seed=2, rank=rank)
    plan = eq2_plan(Ka, Kb, n, p, q, sym=False)
    assert plan.splits > 1
    got = proximity_eq2_schedule_ref(torch.from_numpy(Ua), torch.from_numpy(Ub)).numpy()
    want = np.asarray(ref_measure_pair(jnp.asarray(Ua), jnp.asarray(Ub), "eq2"))
    np.testing.assert_allclose(got, want, atol=TOL_DEG)


# ---------------------------------------------------------------------------
# split-KV merge
# ---------------------------------------------------------------------------

MERGE_CASES = [
    # the cases of tests/test_torch_flash_attention.py
    (2, 64, 64, 4, 2, 32, True, None, 0),
    (1, 32, 128, 8, 8, 16, False, None, 0),
    (2, 64, 64, 4, 1, 32, True, 16, 0),
    (1, 16, 64, 4, 2, 32, True, None, 48),
    (1, 128, 128, 2, 2, 64, True, None, 0),
    (3, 32, 32, 6, 3, 32, True, 8, 0),
    (2, 13, 77, 8, 2, 16, True, 20, 60),
    (2, 7, 29, 8, 2, 16, True, None, 22),
    (2, 5, 40, 4, 2, 16, False, 7, 50),      # every row past the window
    (2, 3, 11, 4, 2, 16, True, 4, 30),       # causal rows with no key in the window
    # decode against a cache, as the bfloat16 kernel splits it
    (2, 1, 300, 8, 2, 16, True, None, 299),
    (2, 1, 300, 8, 2, 16, True, None, 40),   # trailing splits empty / masked
    (2, 1, 300, 8, 2, 16, True, 50, 299),    # early splits masked
    (2, 1, 300, 8, 2, 16, True, 20, 400),    # no valid key in any split
]


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in [(B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)])


def _merged(q, k, v, nsplit, split_len, **kw):
    parts = [attention_partials(q, k, v, s * split_len, (s + 1) * split_len, **kw)
             for s in range(nsplit)]
    return merge_partials(*(torch.stack(x) for x in zip(*parts)))


@pytest.mark.parametrize("split", ["plan", "tiles_of_16", "one_extra_empty"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,causal,window,qoff", MERGE_CASES)
def test_merge_of_partials_matches_reference(B, Sq, Skv, Hq, Hkv, hd, causal, window, qoff,
                                             split):
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=Sq * 31 + Skv)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    want = np.asarray(ref_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    if split == "plan":
        nsplit, split_len = split_plan(B, Sq, Skv, Hq, Hkv, hd)
    else:
        split_len = 16
        nsplit = -(-Skv // split_len) + (split == "one_extra_empty")
    got = _merged(*(torch.from_numpy(a) for a in (q, k, v)), nsplit, split_len, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


def test_empty_split_weighs_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 40, 4, 2, 16, seed=1))
    m, l, acc = attention_partials(q, k, v, 40, 60, q_offset=39)
    assert torch.isinf(m).all() and (m < 0).all() and (l == 0).all() and (acc == 0).all()
    full = attention_partials(q, k, v, 0, 40, q_offset=39)
    got = merge_partials(*(torch.stack([a, b]) for a, b in zip(full, (m, l, acc))))
    np.testing.assert_allclose(got.numpy(), attention_ref(q, k, v, q_offset=39).numpy(),
                               atol=F32_TOL)


def test_fully_masked_split_weighs_nothing_beside_a_valid_key():
    """Keys 16..31 lie past the query at position 10: that split's state is
    all -1e30 (max m = -1e30, l = 16) and must not move the output."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 32, 4, 2, 16, seed=2))
    valid = attention_partials(q, k, v, 0, 16, q_offset=10)
    masked = attention_partials(q, k, v, 16, 32, q_offset=10)
    assert (masked[0] == NEG_INF).all() and (masked[1] == 16).all()
    got = merge_partials(*(torch.stack([a, b]) for a, b in zip(valid, masked)))
    np.testing.assert_allclose(got.numpy(), attention_ref(q, k, v, q_offset=10).numpy(),
                               atol=F32_TOL)
    alone = merge_partials(*(x[None] for x in valid))
    np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=F32_TOL)


def test_no_valid_key_in_any_split_is_the_uniform_average():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 48, 4, 2, 16, seed=3))
    got = _merged(q, k, v, 4, 16, window=5, q_offset=100)
    uniform = v.mean(dim=1).repeat_interleave(2, dim=1)[:, None]
    np.testing.assert_allclose(got.numpy(), uniform.numpy(), atol=F32_TOL)
