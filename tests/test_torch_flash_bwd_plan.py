"""The bfloat16 flash-attention backward kernels' launch plan and arithmetic,
on the CPU.

``csrc/flash_attention_bwd.cu`` runs two tensor-core kernels under one
launch: ``flash_bwd_dkdv_tc`` by key tile (dK, dV) and ``flash_bwd_dq_tc``
by row tile (dQ), rows being the flattened ``i * G + g`` of one KV head.
Their tiles, block order and walks are mirrored in
``kernels/flash_attention/flash_attention_bwd.py`` (``bwd_tiles``,
``dkdv_order``, ``dq_order``, ``dkdv_walk``, ``dq_walk``).  These tests hold
the mirror to the function: every valid (row, key) pair is visited exactly
once by each kernel, the tiles on which the kernel skips the mask hold only
valid pairs, every block is launched once with the tile index outermost and
the longest causal walks first, and each configuration fits a block's
shared memory.  Forms: causal, windowed (a window crossing tile edges),
non-causal, ragged S one below and above a tile, q_offset > 0, G in {1, 6,
8}, head dims 16-256.

A test-only model of the kernels' arithmetic (``kernel_model``: float32
scores and softmax from bf16 operands, P and dS rounded to bf16 as the
operands of the second products, float32 sums, outputs rounded to bf16) is
held to ``jax.vjp`` of the reference's chunked attention within the card
check's bfloat16 limit, 2e-2 of max|reference| (``chip_smoke.py``
``FLASH_BWD_TOL``), at the training forms the card checks
(``chip_smoke.py::trained_flash_calls``) cut to small S; unrounded, the
model matches the port's twin ``attention_bwd_ref`` within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_ref
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    bwd_tiles,
    dkdv_order,
    dkdv_walk,
    dq_order,
    dq_walk,
)

BF16_TOL = 2e-2     # chip_smoke.py FLASH_BWD_TOL["bfloat16"]
SMEM_BYTES = 232448  # a block's shared memory on an H100
HEAD_DIMS = (16, 32, 64, 112, 128, 256)

# (Sq, Skv, G, hd, causal, window, q_offset)
PLAN_FORMS = [
    (200, 200, 8, 64, True, None, 0),       # tinyllama's G
    (63, 63, 8, 64, True, None, 0),         # S one below a key tile
    (65, 65, 8, 64, True, None, 0),         # ... and one above
    (129, 129, 1, 112, True, None, 0),      # G = 1 (zamba2), hd 112
    (150, 300, 1, 64, False, None, 0),      # non-causal, Sq != Skv (cross)
    (75, 75, 1, 64, False, None, 0),        # non-causal square (encoder)
    (130, 130, 6, 128, True, None, 0),      # G = 6 (internvl2)
    (200, 200, 2, 256, True, 70, 0),        # a window crossing tile edges, hd 256
    (161, 161, 2, 256, True, 64, 0),        # a window of one tile, ragged
    (97, 97, 2, 256, True, None, 0),        # hd 256 global, ragged
    (90, 90, 6, 32, True, 17, 0),           # G = 6, windowed
    (50, 70, 6, 16, True, None, 20),        # q_offset > 0
    (33, 129, 8, 64, True, 40, 96),         # offset and window
    (20, 33, 1, 64, True, None, 13),        # a short suffix, G = 1
]


def _valid(Sq, Skv, G, causal, window, q_offset):
    """(rows, keys) validity of the flattened rows ``i * G + g``."""
    pos = q_offset + np.arange(Sq * G) // G
    key = np.arange(Skv)
    ok = np.ones((Sq * G, Skv), dtype=bool)
    if causal:
        ok &= key[None, :] <= pos[:, None]
    if window:
        ok &= key[None, :] > pos[:, None] - window
    return ok


@pytest.mark.parametrize("form", PLAN_FORMS, ids=[str(f) for f in PLAN_FORMS])
def test_walks_visit_every_valid_pair_once(form):
    Sq, Skv, G, hd, causal, window, q_offset = form
    tiles = bwd_tiles(hd)
    valid = _valid(Sq, Skv, G, causal, window, q_offset)
    R = Sq * G

    seen = np.zeros_like(valid, dtype=np.int32)
    for kt in range(-(-Skv // tiles.keys)):
        k0, key_end, steps = dkdv_walk(kt, tiles, Sq, Skv, G, causal, window, q_offset)
        assert (k0, key_end) == (kt * tiles.keys, min(Skv, (kt + 1) * tiles.keys))
        for r0, r1, need in steps:
            assert 0 <= r0 < r1 <= R and r1 - r0 <= tiles.rows
            if not need:   # the kernel skips the mask: a whole tile of valid pairs
                assert r1 - r0 == tiles.rows and key_end - k0 == tiles.keys
                assert valid[r0:r1, k0:key_end].all(), (kt, r0)
            seen[r0:r1, k0:key_end] += 1
    assert (seen[valid] == 1).all() and seen.max() <= 1

    seen[:] = 0
    for qt in range(-(-R // tiles.q_rows)):
        r0, row_end, steps = dq_walk(qt, tiles, Sq, Skv, G, causal, window, q_offset)
        assert (r0, row_end) == (qt * tiles.q_rows, min(R, (qt + 1) * tiles.q_rows))
        for t0, t1, need in steps:
            assert 0 <= t0 < t1 <= Skv and t1 - t0 <= tiles.q_keys
            if not need:
                assert t1 - t0 == tiles.q_keys and row_end - r0 == tiles.q_rows
                assert valid[r0:row_end, t0:t1].all(), (qt, t0)
            seen[r0:row_end, t0:t1] += 1
    assert (seen[valid] == 1).all() and seen.max() <= 1


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_tiles_fit_and_cover_the_head_dim(hd):
    """Whole k16 chunks and n8 pairs, the column splits cover hd, 16 keys or
    rows a warp of 4, and both kernels' shared memory (bf16 rows padded by 8,
    3-stage rings) fits a block."""
    t = bwd_tiles(hd)
    assert hd % 16 == 0 and t.dacc % 16 == 0 and t.dacc * t.nsplit == hd
    assert t.keys == 4 * 16 and t.q_rows == 4 * 16
    assert t.rows % 16 == 0 and t.q_keys % 16 == 0
    ld = hd + 8
    smem_kv = 2 * t.keys * ld * 2 + 3 * (2 * t.rows * ld * 2 + 2 * t.rows * 4)
    smem_q = 2 * t.q_rows * ld * 2 + 3 * (2 * t.q_keys * ld * 2)
    assert smem_kv <= SMEM_BYTES and smem_q <= SMEM_BYTES
    # ldmatrix reads 8 rows at once: their 16-byte segments fall in distinct banks
    assert len({(r * ld * 2) % 128 for r in range(8)}) == 8
    # registers: dK and dV accumulators a thread stay at most 128 floats
    assert 2 * 16 * t.dacc // 32 <= 128 and 16 * hd // 32 <= 128


@pytest.mark.parametrize("B,Hkv,G,causal", [(2, 4, 8, True), (3, 32, 1, True),
                                            (1, 8, 6, False), (4, 4, 2, True)])
def test_block_order_is_complete_and_heaviest_first(B, Hkv, G, causal):
    Sq = Skv = 300
    for hd in (64, 256):
        tiles = bwd_tiles(hd)
        nkt, nqt = -(-Skv // tiles.keys), -(-(Sq * G) // tiles.q_rows)
        order = dkdv_order(nkt, B, Hkv, tiles.nsplit)
        assert len(order) == len(set(order)) == nkt * B * Hkv * tiles.nsplit
        for x, (kt, split, hk, b) in enumerate(order):   # the kernel's decode of blockIdx.x
            assert x == ((kt * B + b) * Hkv + hk) * tiles.nsplit + split
        walks = [len(dkdv_walk(kt, tiles, Sq, Skv, G, causal, None, 0)[2]) for kt, *_ in order]
        assert walks == sorted(walks, reverse=True) or not causal
        order = dq_order(nqt, B, Hkv, causal)
        assert sorted(order) == sorted((qt, hk, b) for qt in range(nqt) for hk in range(Hkv)
                                       for b in range(B))
        rank = {qt: i for i, qt in enumerate(dict.fromkeys(o[0] for o in order))}
        for x, (qt, hk, b) in enumerate(order):
            assert x == (rank[qt] * B + b) * Hkv + hk
        walks = [len(dq_walk(qt, tiles, Sq, Skv, G, causal, None, 0)[2]) for qt, *_ in order]
        assert walks == sorted(walks, reverse=True) or not causal


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def kernel_model(q, k, v, o, do, lse, *, causal, window, q_offset, round_ops=True):
    """dq, dk, dv as the bfloat16 kernels compute them, from float32 tensors
    holding bf16 values: scores and exp2 of ``s * scale * log2 e - lse *
    log2 e`` in float32, delta = rowsum(dO O), P and dS rounded to bf16 for
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K (``round_ops``), float32
    sums, each output rounded to bf16 (when ``round_ops``)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    dog = do.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bchd->bqhgc", qg, k)
    pos = torch.arange(Sq) + q_offset
    key = torch.arange(Skv)
    valid = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        valid &= key[None, :] <= pos[:, None]
    if window:
        valid &= key[None, :] > pos[:, None] - window
    l2 = lse.permute(0, 2, 1).reshape(B, Sq, Hkv, G)[..., None] * log2e
    p = torch.where(valid[None, :, None, None, :], torch.exp2(s * (scale * log2e) - l2), 0.0)
    delta = (dog * o.reshape(B, Sq, Hkv, G, hd)).sum(-1, keepdim=True)
    dp = torch.einsum("bqhgd,bchd->bqhgc", dog, v)
    ds = p * (dp - delta)
    rnd = _bf16 if round_ops else (lambda x: x)
    dv = torch.einsum("bqhgc,bqhgd->bchd", rnd(p), dog)
    dk = torch.einsum("bqhgc,bqhgd->bchd", rnd(ds), qg) * scale
    dq = (torch.einsum("bqhgc,bchd->bqhgd", rnd(ds), k) * scale).reshape(B, Sq, Hq, hd)
    return rnd(dq), rnd(dk), rnd(dv)


# chip_smoke.py's trained_flash_calls (B, Sq, Skv, Hq, Hkv, hd), causal,
# window, with S (and windows) cut small: B 1, S <= 111.
TRAINED_SMALL = [
    ("tinyllama", (1, 80, 80, 32, 4, 64), True, None),
    ("llama3.2-3b heads", (1, 70, 70, 24, 8, 128), True, None),
    ("gemma3 local", (1, 80, 80, 8, 4, 256), True, 40),
    ("gemma3 global", (1, 80, 80, 8, 4, 256), True, None),
    ("zamba2 shared attention", (1, 48, 48, 32, 32, 112), True, None),
    ("whisper encoder", (1, 75, 75, 16, 16, 64), False, None),
    ("whisper decoder", (1, 22, 22, 16, 16, 64), True, None),
    ("whisper cross", (1, 22, 75, 16, 16, 64), False, None),
    ("internvl2 (G = 6)", (1, 51, 51, 48, 8, 128), True, None),
    ("ragged S", (1, 111, 111, 32, 4, 64), True, None),
    ("ragged S, windowed, hd 256", (1, 99, 99, 8, 4, 256), True, 30),
]


@pytest.mark.parametrize("label,dims,causal,window", TRAINED_SMALL,
                         ids=[f[0] for f in TRAINED_SMALL])
def test_kernel_arithmetic_matches_reference_vjp(label, dims, causal, window):
    B, Sq, Skv, Hq, Hkv, hd = dims
    rng = np.random.default_rng(Sq * 7 + hd)

    def bf16_values(*shape):
        return _bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))

    q, do = bf16_values(B, Sq, Hq, hd), bf16_values(B, Sq, Hq, hd)
    k, v = bf16_values(B, Skv, Hkv, hd), bf16_values(B, Skv, Hkv, hd)
    o, lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    o = _bf16(o)   # the forward's bf16 output

    q_pos, kv_pos = jnp.arange(Sq, dtype=jnp.int32), jnp.arange(Skv, dtype=jnp.int32)

    def f(q, k, v):
        return ref_attention.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                               window=window, chunk=32)

    _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    got = kernel_model(q, k, v, o, do, lse, causal=causal, window=window, q_offset=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = np.abs(b).max()
        err = np.abs(a.numpy() - b).max()
        assert a.shape == b.shape and err <= BF16_TOL * scale, (label, name, err / scale)
    # unrounded, the model is the port's twin of the reference's _flash_bwd
    exact = kernel_model(q, k, v, o, do, lse, causal=causal, window=window, q_offset=0,
                         round_ops=False)
    twin = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    for a, b in zip(exact, twin):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
