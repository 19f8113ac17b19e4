"""Port parity: the attention forms of the remaining LM families against the
reference's ``attend`` (``repro.models.attention``), in float32 within 1e-5.

* Ring caches of sliding-window layers (gemma3's local layers): a prefill
  longer than the ring keeps the tail at slot ``pos % s_cache``, and decode
  steps write at ``decode_pos % s_cache`` before and after the ring fills.
* Cross-attention (whisper's decoder): the prefill over the encoder output
  (no RoPE, non-causal) and its cache padded to a multiple of 128, then
  decode against the first ``encoder_seq`` slots of that cache.
* The encoder's non-causal self-attention (with RoPE).

Each form's CUDA call is the kernel's implicit-position form
(``decode_form``; ``kv_len`` for the padded cache): here its plain twin,
called with exactly those arguments, is held to the reference's masked
attention too, so the kernel computes the reference's function wherever it
matches its twin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention

TOL = 1e-5
D, HQ, HKV = 64, 4, 2
THETA = 10_000.0


def _params(hd, seed=0):
    tree = jax.tree.map(np.asarray, ref_attn.init_attn(jax.random.PRNGKey(seed), D, HQ, HKV, hd))
    port = attention.Attn(**{k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    return tree, port


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


def _kw(hd):
    return dict(n_heads=HQ, n_kv=HKV, hd=hd, theta=THETA)


def _cache(ref_cache):
    return attention.AttnCache(torch.from_numpy(np.array(ref_cache.k)),
                               torch.from_numpy(np.array(ref_cache.v)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("hd", [32, 16])
@pytest.mark.parametrize("S,window,s_cache", [
    (20, 8, 8),     # prompt longer than the ring: the tail rolls in
    (13, 8, 8),     # roll by 13 - 8 = 5
    (5, 8, 8),      # prompt shorter than the ring: decode fills it, then wraps
    (7, 8, 8),      # the ring fills on the first decode step
])
def test_ring_prefill_and_decode_match_reference(hd, S, window, s_cache):
    tree, port = _params(hd, seed=S)
    B = 2
    x = _x(B, S, seed=S)
    pos = np.arange(S, dtype=np.int32)
    ref_cache = ref_attn.init_attn_cache(B, s_cache, HKV, hd)
    want, ref_cache = ref_attn.attend(tree, jnp.asarray(x), **_kw(hd), q_pos=jnp.asarray(pos),
                                      window=window, chunk=16, cache=ref_cache)
    cache = attention.init_attn_cache(B, s_cache, HKV, hd, dtype=torch.float32, device="cpu")
    got, cache = attention.attend(port, torch.from_numpy(x), **_kw(hd),
                                  q_pos=torch.from_numpy(pos).long(), window=window,
                                  chunk=16, cache=cache)
    _close(got.numpy(), want)
    _close(cache.k.numpy(), ref_cache.k)
    _close(cache.v.numpy(), ref_cache.v)

    steps = _x(B, 12, seed=S + 1)
    for t in range(steps.shape[1]):
        p = S + t
        xt = steps[:, t:t + 1]
        want, ref_cache = ref_attn.attend(
            tree, jnp.asarray(xt), **_kw(hd), q_pos=jnp.asarray([p], jnp.int32),
            window=window, chunk=16, cache=ref_cache, decode_pos=jnp.int32(p))
        got, cache = attention.attend(
            port, torch.from_numpy(xt), **_kw(hd), q_pos=torch.tensor([p]), window=window,
            chunk=16, cache=cache, decode_pos=p)
        _close(got.numpy(), want)
        _close(cache.k.numpy(), ref_cache.k)

        # the CUDA call's form (the kernel's implicit positions) on its twin
        form = attention.decode_form(s_cache, p, window)
        assert form.ring and form.slot == p % s_cache
        q = attention.rope(attention.mm(torch.from_numpy(xt), port.q, torch.float32)
                           .reshape(B, 1, HQ, hd), torch.tensor([p]), THETA)
        kv_pos = ref_attn.cache_positions(s_cache, jnp.int32(p), ring=True)
        ref_out = ref_attn.chunked_attention(
            jnp.asarray(q.numpy()), ref_cache.k, ref_cache.v, jnp.asarray([p], jnp.int32),
            kv_pos, causal=True, window=window, chunk=16)
        twin = flash_attention_plain(q, cache.k, cache.v, causal=form.causal,
                                     window=form.window, q_offset=form.q_offset)
        _close(twin.numpy(), ref_out)


def test_decode_form_by_cache():
    # a plain cache: causal at decode_pos, with the layer's window
    assert attention.decode_form(64, 40, None) == (False, 40, True, None, 40)
    assert attention.decode_form(64, 40, 16) == (False, 40, True, 16, 40)
    # a ring: causal until full, then every slot, non-causal
    assert attention.decode_form(8, 3, 8) == (True, 3, True, None, 3)
    assert attention.decode_form(8, 7, 8) == (True, 7, False, None, 0)
    assert attention.decode_form(8, 21, 8) == (True, 5, False, None, 0)
    assert attention.decode_form(6, 21, 8) == (True, 3, False, None, 0)


@pytest.mark.parametrize("hd", [32, 16])
def test_cross_attention_prefill_and_padded_decode_match_reference(hd):
    tree, port = _params(hd, seed=3)
    B, S, n_enc = 2, 9, 20
    slots = n_enc + (-n_enc) % 128
    x, enc = _x(B, S, seed=4), _x(B, n_enc, seed=5)
    pos = np.arange(S, dtype=np.int32)
    want, _ = ref_attn.attend(tree, jnp.asarray(x), **_kw(hd), q_pos=jnp.asarray(pos),
                              chunk=16, kv_x=jnp.asarray(enc))
    cache = attention.init_attn_cache(B, slots, HKV, hd, dtype=torch.float32, device="cpu")
    cache.k.fill_(7.0)   # stale values in the padding must be cleared
    got = attention.cross_prefill(port, torch.from_numpy(x), torch.from_numpy(enc),
                                  n_heads=HQ, n_kv=HKV, hd=hd,
                                  q_pos=torch.from_numpy(pos).long(), chunk=16, cache=cache)
    _close(got.numpy(), want)
    # the reference lm's cross cache: projected K, V padded with zeros
    ref_k = np.pad((enc @ tree["k"]).reshape(B, n_enc, HKV, hd),
                   ((0, 0), (0, slots - n_enc), (0, 0), (0, 0)))
    ref_v = np.pad((enc @ tree["v"]).reshape(B, n_enc, HKV, hd),
                   ((0, 0), (0, slots - n_enc), (0, 0), (0, 0)))
    _close(cache.k.numpy(), ref_k)
    _close(cache.v.numpy(), ref_v)

    ref_cache = ref_attn.AttnCache(jnp.asarray(ref_k), jnp.asarray(ref_v))
    idx = np.arange(slots)
    pad_pos = jnp.asarray(np.where(idx < n_enc, idx, -1).astype(np.int32))
    steps = _x(B, 3, seed=6)
    for t in range(3):
        p = S + t
        xt = steps[:, t:t + 1]
        want, _ = ref_attn.attend(tree, jnp.asarray(xt), **_kw(hd),
                                  q_pos=jnp.asarray([p], jnp.int32), chunk=16,
                                  cache=ref_cache, kv_x=jnp.asarray(xt),
                                  cached_kv_valid=pad_pos)
        got, same = attention.attend(port, torch.from_numpy(xt), **_kw(hd),
                                     q_pos=torch.tensor([p]), chunk=16, cache=cache,
                                     cross_len=n_enc)
        assert same is cache
        _close(got.numpy(), want)
    # the CUDA call's form: the twin over the first n_enc slots, non-causal
    q = attention.mm(torch.from_numpy(xt), port.q, torch.float32).reshape(B, 1, HQ, hd)
    ref_out = ref_attn.chunked_attention(jnp.asarray(q.numpy()), ref_cache.k, ref_cache.v,
                                         jnp.asarray([p], jnp.int32), pad_pos, causal=False,
                                         chunk=16)
    twin = flash_attention_plain(q, cache.k[:, :n_enc], cache.v[:, :n_enc], causal=False)
    _close(twin.numpy(), ref_out)


@pytest.mark.parametrize("S", [17, 40])
def test_encoder_self_attention_matches_reference(S):
    hd = 32
    tree, port = _params(hd, seed=S)
    x = _x(2, S, seed=S)
    pos = np.arange(S, dtype=np.int32)
    want, _ = ref_attn.attend(tree, jnp.asarray(x), **_kw(hd), q_pos=jnp.asarray(pos),
                              causal=False, chunk=16)
    got, _ = attention.attend(port, torch.from_numpy(x), **_kw(hd),
                              q_pos=torch.from_numpy(pos).long(), causal=False, chunk=16)
    _close(got.numpy(), want)
