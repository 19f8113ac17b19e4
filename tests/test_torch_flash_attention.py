"""Port parity: the flash-attention kernel's plain twin and the model's attention.

The twin (``flash_attention_plain``, which the kernel wrapper takes for CPU
tensors) is held against the reference's Pallas kernel (interpret mode on
the CPU, as the reference's own tests run it) and its oracle
``attention_ref`` on the cases of ``tests/test_kernels.py`` and at head dims
112 and 256: atol 2e-5 in float32, 3e-2 in bfloat16.  The port's ``chunked_attention`` is held against
the reference's in prefill and decode forms at 2e-5, and against the twin in
the implicit-position form the CUDA path uses.  Inputs are numpy-seeded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as ref_attention_ref
from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.models import attention

F32_TOL, BF16_TOL = 2e-5, 3e-2

CASES = [
    (2, 64, 64, 4, 2, 32, True, None, 0),
    (1, 32, 128, 8, 8, 16, False, None, 0),
    (2, 64, 64, 4, 1, 32, True, 16, 0),
    (1, 16, 64, 4, 2, 32, True, None, 48),   # decode-suffix offset
    (1, 128, 128, 2, 2, 64, True, None, 0),
    (3, 32, 32, 6, 3, 32, True, 8, 0),
    # the head dims of zamba2 (3584 / 32 = 112) and gemma3 (256)
    (1, 32, 64, 4, 2, 112, True, None, 0),
    (1, 16, 48, 2, 1, 112, True, 16, 32),
    (2, 32, 32, 4, 2, 256, True, 16, 0),
    (1, 16, 64, 2, 2, 256, False, None, 0),
]


def _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 [(B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)])


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,causal,window,qoff", CASES)
def test_plain_matches_pallas_and_oracle(B, Sq, Skv, Hq, Hkv, hd, causal, window, qoff):
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, seed=Sq + Skv)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(ref_flash_attention(jq, jk, jv, causal=causal, window=window,
                                            q_offset=qoff, bq=16, bk=16))
    oracle = np.asarray(ref_attention_ref(jq, jk, jv, causal=causal, window=window,
                                          q_offset=qoff))
    got = flash_attention(*_t(q, k, v), causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), pallas, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=F32_TOL)
    port_oracle = attention_ref(*_t(q, k, v), causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes(dtype):
    q, k, v = _qkv(1, 32, 32, 4, 2, 32, seed=1)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    pallas = np.asarray(ref_flash_attention(jq, jk, jv, bq=16, bk=16), dtype=np.float32)
    oracle = np.asarray(ref_attention_ref(jq, jk, jv), dtype=np.float32)
    got = flash_attention(*_t(q, k, v, dtype=tdt))
    assert got.dtype == tdt
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=tol)


@pytest.mark.parametrize("Sq,Skv,window,qoff,causal", [
    (13, 77, 20, 60, True),      # ragged, windowed, offset
    (7, 29, None, 22, True),     # ragged decode suffix
    (5, 40, 7, 50, False),       # every row past the window: uniform average
    (3, 11, 4, 30, True),        # causal rows with no key in the window
])
def test_ragged_and_fully_masked_rows_match_oracle(Sq, Skv, window, qoff, causal):
    """Shapes the Pallas kernel asserts away: against its oracle."""
    q, k, v = _qkv(2, Sq, Skv, 4, 2, 16, seed=Sq)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = np.asarray(ref_attention_ref(jq, jk, jv, causal=causal, window=window,
                                          q_offset=qoff))
    got = flash_attention(*_t(q, k, v), causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), oracle, atol=F32_TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_chunked_attention_prefill_matches_reference(window):
    q, k, v = _qkv(2, 64, 64, 8, 4, 32, seed=3)
    pos = np.arange(64, dtype=np.int32)
    want = np.asarray(ref_attn.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos), jnp.asarray(pos),
        causal=True, window=window, chunk=16))
    tpos = torch.from_numpy(pos).long()
    got = attention.chunked_attention(*_t(q, k, v), tpos, tpos, causal=True, window=window,
                                      chunk=16, q_offset=0)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
    # the kernel's implicit-position form computes the same function
    twin = flash_attention(*_t(q, k, v), causal=True, window=window, q_offset=0)
    np.testing.assert_allclose(twin.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("pos", [0, 9, 39])
def test_chunked_attention_decode_matches_reference(pos):
    """One query against a 40-slot cache whose slots above ``pos`` are stale."""
    q, k, v = _qkv(3, 1, 40, 8, 2, 32, seed=pos)
    kv_pos = np.asarray(ref_attn.cache_positions(40, jnp.int32(pos), ring=False))
    q_pos = np.array([pos], dtype=np.int32)
    want = np.asarray(ref_attn.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(q_pos), jnp.asarray(kv_pos),
        causal=True, chunk=16))
    port_kv_pos = attention.cache_positions(40, pos, ring=False)
    np.testing.assert_array_equal(port_kv_pos.numpy(), kv_pos)
    got = attention.chunked_attention(*_t(q, k, v), torch.from_numpy(q_pos).long(),
                                      port_kv_pos, causal=True, chunk=16, q_offset=pos)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
    twin = flash_attention(*_t(q, k, v), causal=True, q_offset=pos)
    np.testing.assert_allclose(twin.numpy(), want, atol=F32_TOL)


def test_ring_cache_positions_match_reference():
    for pos in (3, 17, 40):
        want = np.asarray(ref_attn.cache_positions(8, jnp.int32(pos), ring=True))
        np.testing.assert_array_equal(attention.cache_positions(8, pos, ring=True).numpy(), want)


def test_rope_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 12, 4, 32)).astype(np.float32)
    pos = np.arange(3, 15, dtype=np.int32)
    want = np.asarray(ref_attn.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = attention.rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_operand_checks():
    q, k, v = _t(*_qkv(1, 4, 4, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k[:, :, :1].expand(1, 4, 3, 16), v[:, :, :1].expand(1, 4, 3, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)
    np.testing.assert_allclose(
        flash_attention_plain(q, k, v).numpy(), flash_attention(q, k, v).numpy())


def test_kv_operands_keep_cache_views():
    """The kernel reads the first Skv slots of a longer cache in place (its
    batch stride); other layouts are made contiguous first."""
    from repro_torch.kernels.flash_attention.flash_attention import kv_operands

    cache = torch.zeros((3, 1536, 4, 64), dtype=torch.bfloat16)
    k, v, stride = kv_operands(cache[:, :1500], cache[:, :1500])
    assert k.data_ptr() == cache.data_ptr() and stride == 1536 * 4 * 64
    k, v, stride = kv_operands(cache[:1, :1500], cache[:1, :1500])
    assert k.data_ptr() == cache.data_ptr() and stride == 1500 * 4 * 64
    heads = cache[:, :100, :2]                      # rows not contiguous: copied
    k, v, stride = kv_operands(heads, heads)
    assert k.is_contiguous() and k.data_ptr() != cache.data_ptr() and stride == 100 * 2 * 64
    odd = torch.zeros((2, 1501 * 4 * 64 + 3), dtype=torch.bfloat16)[:, 3:].reshape(2, 1501, 4, 64)
    k, v, stride = kv_operands(odd[:, :1500], odd[:, :1500])   # batch rows misaligned
    assert k.is_contiguous() and stride == 1500 * 4 * 64
