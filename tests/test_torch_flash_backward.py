"""Port parity: flash attention under autograd (the ``FlashAttention``
Function and its plain twins) against the reference's custom VJP.

The same numpy-seeded q, k, v and output cotangent go through
``jax.vjp`` of the reference's ``chunked_attention`` (its ``_flash_bwd``,
chunk 16 so several chunks are walked) and through the port's
``flash_attention`` with inputs that require grad, which on the CPU runs
``FlashAttention``: the forward's plain twin with its log-sum-exp saved,
then the backward's twin (``attention_bwd_ref``, a port of ``_flash_bwd``).
Forms: causal, causal with a window, non-causal with Sq != Skv (whisper's
encoder and cross attention), a query offset, GQA groups G of 1, 4 and 6,
head dims 32, 64, 112 and 256, ragged lengths.  Output and dq, dk, dv
within 1e-5 of the largest |value| of each (float32 on both sides; the
twins sum in another order than the reference's scan).  The same forms go
through ``models.attention.chunked_attention`` (which the train-mode
forward calls), with ``kv_len`` cutting a longer K/V.  The CUDA kernels'
counterparts are in ``tests/test_torch_cuda.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    attention_bwd_ref,
    attention_ref,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.wkv import wkv
from repro_torch.models.attention import chunked_attention

REL_TOL = 1e-5
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset)
CASES = [
    (2, 20, 20, 4, 4, 32, True, None, 0),      # G = 1
    (1, 37, 37, 8, 2, 64, True, None, 0),      # G = 4, ragged
    (2, 23, 23, 6, 1, 32, True, 7, 0),         # G = 6, windowed
    (1, 30, 45, 4, 4, 64, False, None, 0),     # non-causal, Sq != Skv (cross)
    (1, 45, 45, 4, 4, 32, False, None, 0),     # non-causal square (encoder)
    (1, 19, 19, 4, 4, 112, True, None, 0),     # zamba2's head dim
    (1, 21, 21, 8, 4, 256, True, 8, 0),        # gemma3's, local
    (1, 18, 18, 8, 4, 256, True, None, 0),     # gemma3's, global
    (1, 11, 29, 4, 2, 32, True, None, 18),     # a query offset (suffix)
    (1, 13, 33, 6, 1, 64, True, 9, 20),        # offset and window, G = 6
]


def _inputs(case, seed=0):
    B, Sq, Skv, Hq, Hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd), (B, Sq, Hq, hd))]


def _reference(case, q, k, v, do):
    """Output and (dq, dk, dv) of the reference's chunked attention."""
    _, Sq, Skv, _, _, _, causal, window, q_off = case
    q_pos = jnp.arange(Sq, dtype=jnp.int32) + q_off
    kv_pos = jnp.arange(Skv, dtype=jnp.int32)

    def f(q, k, v):
        return ref_attention.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                               window=window, chunk=16)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * scale, (np.abs(got - want).max(), scale)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_function_matches_reference_vjp(case):
    q, k, v, do = _inputs(case)
    want_out, want_grads = _reference(case, q, k, v, do)
    causal, window, q_off = case[6:]
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    before = dict(_build.LAUNCHES)
    out = flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=q_off)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert dict(_build.LAUNCHES) == before      # the CPU runs the twins, never a kernel
    _close(out.detach().numpy(), want_out)
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        _close(got.numpy(), want)


@pytest.mark.parametrize("case", CASES[:4] + CASES[8:], ids=[str(c) for c in CASES[:4] + CASES[8:]])
def test_chunked_attention_under_grad_matches_reference(case):
    """The train-mode call: chunked_attention with the kernel's implicit
    positions, here with K and V cut by ``kv_len`` from longer tensors."""
    q, k, v, do = _inputs(case, seed=1)
    want_out, want_grads = _reference(case, q, k, v, do)
    causal, window, q_off = case[6:]
    pad = np.zeros((k.shape[0], 5) + k.shape[2:], dtype=np.float32)
    tq, tk, tv = _leaf(q), _leaf(np.concatenate([k, pad], 1)), _leaf(np.concatenate([v, pad], 1))
    Sq, Skv = q.shape[1], k.shape[1]
    out = chunked_attention(tq, tk, tv, torch.arange(Sq) + q_off, torch.arange(Skv + 5),
                            causal=causal, window=window, chunk=16, q_offset=q_off,
                            kv_len=Skv)
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), want_out)
    _close(tq.grad.numpy(), want_grads[0])
    _close(tk.grad[:, :Skv].numpy(), want_grads[1])
    _close(tv.grad[:, :Skv].numpy(), want_grads[2])
    assert float(tk.grad[:, Skv:].abs().max()) == 0.0


def test_lse_is_the_rows_log_sum_exp():
    case = CASES[2]
    q, k, v, _ = _inputs(case)
    B, Sq, Skv, Hq, Hkv, hd, causal, window, _ = case
    _, lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal, window=window, return_lse=True)
    G = Hq // Hkv
    s = np.einsum("bqhgd,bchd->bhgqc", q.reshape(B, Sq, Hkv, G, hd) / math.sqrt(hd), k)
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    s = np.where((j <= i) & (j > i - window), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), want.reshape(B, Hq, Sq), rtol=1e-6, atol=1e-6)


def test_function_keeps_dtypes_and_matches_autograd_of_the_twin():
    """bfloat16 operands get bfloat16 gradients; in float32 the Function's
    backward (a key chunk of 3, so the chunk loop is walked) agrees with
    autograd through the dense forward twin."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(torch.bfloat16).requires_grad_()
               for s in ((1, 9, 4, 32), (1, 9, 2, 32), (1, 9, 2, 32)))
    out = FlashAttention.apply(q, k, v, True, None, 0)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((1, 7, 6, 16), (1, 7, 2, 16), (1, 7, 2, 16)))
    do = torch.from_numpy(rng.normal(size=(1, 7, 6, 16)).astype(np.float32))
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True, window=3), (q, k, v), do)
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, True, 3, 0), (q, k, v), do)
    o, lse = attention_ref(q, k, v, causal=True, window=3, return_lse=True)
    chunked = attention_bwd_ref(q, k, v, o, do, lse, causal=True, window=3, chunk=3)
    for a, b, c in zip(got, chunked, want):
        _close(a.numpy(), c.numpy())
        _close(b.detach().numpy(), c.numpy())


def test_no_graph_without_grad():
    q, k, v, _ = _inputs(CASES[0])
    with torch.no_grad():
        out = flash_attention(_leaf(q), _leaf(k), _leaf(v))
    assert out.grad_fn is None


class _CardStandIn:
    """Stands in for a CUDA tensor that autograd records (shape (1, 5, 2,
    16); ``u`` (2, 16))."""

    device = torch.device("cuda")
    requires_grad = True
    ndim = 4
    shape = (1, 5, 2, 16)


class _CardU(_CardStandIn):
    shape = (2, 16)


def test_wkv_on_the_card_trains_through_the_function(monkeypatch):
    """On the card, where autograd records, the WKV wrapper hands its
    operands to the WKV Function (forward and backward kernels) instead of
    refusing them; on the CPU the same Function trains through the twins."""
    from repro_torch.kernels.wkv import ops as wkv_ops

    x, u_card = _CardStandIn(), _CardU()
    calls = []
    monkeypatch.setattr(wkv_ops.WKV, "apply", lambda *a: calls.append(a) or "recorded")
    assert wkv(x, x, x, x, u_card) == "recorded"
    assert calls == [(x, x, x, x, u_card, None)]
    monkeypatch.undo()
    # on the CPU the twin trains, through the Function
    rng = np.random.default_rng(0)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, 5, 2, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    w = torch.full((1, 5, 2, 16), 0.9)
    u = torch.zeros((2, 16))
    out, _ = wkv(r, k, v, w, u)
    assert out.grad_fn is not None and "WKVBackward" in out.grad_fn.name()
    out.sum().backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()
