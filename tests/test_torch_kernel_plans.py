"""Host-side plans and the split-KV merge of the port's redesigned kernels.

The bfloat16 flash-attention kernel splits the keys of a decode-sized call
over several blocks and merges their partial softmax states; the tsgemm
kernel splits ``k`` of its short-m products.  Both plans are pure host
functions, tested here on the CPU: every key (or ``k``) index is covered
exactly once, no split is out of range, and at the main path's shapes the
split fills the card (H100: 132 SMs).

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

from repro.kernels.flash_attention import attention_ref as ref_attention_ref
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
from repro_torch.kernels.tsgemm.tsgemm import SLABS, TS_K, TS_ROWS, split_k_plan

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
