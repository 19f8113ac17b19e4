"""GQA attention with RoPE, KV caches (ring buffers for sliding-window
layers, padded cross-attention caches) and chunked (flash-style) computation.

Port of ``repro.models.attention``.  :func:`chunked_attention` is the hot
spot.  On the CPU, serving runs the reference's pure online-softmax scan
over KV chunks (dense softmax for a single decode query).  On CUDA it
launches the hand-written flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), which computes the same
function with implicit positions: query ``i`` at ``q_offset + i``, key
``j`` at ``j``, over the first ``kv_len`` slots.  Every call of the
serving and training paths has that form, some after rewriting the
reference's mask into an equal one (:func:`decode_form`):

* prefill, causal, with or without a window, and the whisper encoder's
  non-causal self-attention;
* decode against a plain cache: causal at ``q_offset = decode_pos``;
* decode against a ring (``s_cache <= window``): every slot a ring holds is
  inside the window, so until the ring is full it is the causal call at
  ``q_offset = decode_pos``, and from then on a non-causal call over all
  ``s_cache`` slots, in slot order rather than position order;
* cross-attention: non-causal, without RoPE, over the encoder's frames; at
  decode over the first ``encoder_seq`` slots of the cache padded to a
  multiple of 128 (``kv_len``; the kernel reads the view in place).

Training (the train-mode forward: no cache, ``q_offset = 0``; whisper's
cross-attention non-causal over the encoder's frames) runs every call
through :class:`repro_torch.kernels.flash_attention.FlashAttention`, the
counterpart of the reference's custom VJP: on CUDA the forward and
backward kernels, on the CPU their plain twins (the backward a port of the
reference's ``_flash_bwd``).  KV caches are updated in place.

Sharded over a model axis (``axis``, :mod:`repro_torch.sharding`), q, k and
v hold the rank's contiguous heads (``n_heads`` and ``n_kv`` are the
rank's counts, ``sharding.attn_heads``), the KV cache the rank's KV heads,
and ``o`` its rows: its float32 partial is summed over the axis
(``MeshAxis.reduce``).  Where the KV heads divide over the axis, each rank
holds Hkv / m of them with all their query heads.  Where they are fewer
than the ranks, a group of R ranks holds one KV head whole (its k and v
columns and its cache, the same on each) and splits its query heads; a
rank may hold none, and then launches no kernel and its partial is zero
(:func:`chunked_attention` returns the empty heads, :func:`out_proj`
their zero product), while it joins every collective as the others do.
The input enters the rank's heads through ``MeshAxis.copy``, so in
training its gradient's partials are summed over the axis; a shared KV
head's ``dK Wk^T`` and ``dV Wv^T`` on each rank of its group come from
that rank's query heads alone, so that sum adds each query head's part
once, as the unsharded model does.  The k and v weights' gradients are
partial in the same way: :func:`repro_torch.models.lm.value_and_grad`
sums them over the replica group.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    Keep, MeshAxis, dense_init, keep_all, mm, mm_f32, param, reduce_sum)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (S,) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]                   # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked flash-style attention
# ---------------------------------------------------------------------------


def _mask_for(p_c: torch.Tensor, q_pos: torch.Tensor, causal: bool, window: Optional[int]):
    """(Sq, c) validity mask from absolute positions (-1 = invalid slot)."""
    valid = p_c[None, :] >= 0
    if causal:
        valid = valid & (p_c[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (p_c[None, :] > q_pos[:, None] - window)
    return valid


def _flash_forward(qg, ks, vs, ps, q_pos, causal, window, dtype):
    """Online-softmax scan over KV chunks -> out (B, Sq, Hkv, G, hd) float32."""
    B, Sq, Hkv, G, hd = qg.shape
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Sq, Hkv, G, hd), dtype=torch.float32, device=qg.device)
    for k_c, v_c, p_c in zip(ks, vs, ps):
        s = torch.einsum("bqhgd,bchd->bqhgc", qg.float(), k_c.float())
        valid = _mask_for(p_c, q_pos, causal, window)
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgc,bchd->bqhgd", p.to(dtype).float(), v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-30)


def chunked_attention(
    q: torch.Tensor,                 # (B, Sq, Hq, hd)
    k: torch.Tensor,                 # (B, Skv, Hkv, hd)
    v: torch.Tensor,                 # (B, Skv, Hkv, hd)
    q_pos: torch.Tensor,             # (Sq,) absolute positions
    kv_pos: torch.Tensor,            # (Skv,); -1 marks invalid slots
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: Optional[int] = None,
    kv_len: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Flash-style attention over KV chunks. Returns (B, Sq, Hq, hd) in ``dtype``.

    ``q_offset`` says that the positions are the kernel's implicit form
    (``q_pos = q_offset + arange(Sq)``, ``kv_pos = arange(Skv)`` with the
    slots above the last query masked by causality, and with ``kv_len``
    every slot from ``kv_len`` on invalid); CUDA tensors need it and launch
    the flash kernel on the first ``kv_len`` slots (default all), as do
    ``meta`` tensors (a dry run: the kernel's launch counted) and CPU
    tensors that autograd records (the kernel's twins, forward and
    backward).  Other CPU tensors run the reference's scan on ``q_pos`` /
    ``kv_pos``.  With no query head (a rank of a replica group that holds
    none) it returns ``q``'s empty heads in ``dtype`` and launches nothing.
    """
    if q.shape[2] == 0:
        return q.to(dtype)
    recorded = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
    if q.device.type in ("cuda", "meta") or (recorded and q_offset is not None):
        if q_offset is None:
            raise ValueError("CUDA attention needs the kernel's implicit positions (q_offset)")
        if kv_len is not None:
            k, v = k[:, :kv_len], v[:, :kv_len]
        out = flash_attention(
            q.to(dtype), k.to(dtype), v.to(dtype),
            causal=causal, window=window, q_offset=q_offset,
        )
        return out.to(dtype)

    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    if Sq == 1:
        # Decode: the (B, 1, H, Skv) score tensor is small; dense attention.
        qg = (q.float() * scale).reshape(B, Sq, Hkv, G, hd)
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, k.float())
        valid = _mask_for(kv_pos, q_pos, causal, window)
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgc,bchd->bqhgd", p, v.float())
        return out.reshape(B, Sq, Hq, hd).to(dtype)

    # Pad KV to a multiple of `chunk`; padded slots get kv_pos = -1 (masked).
    pad = (-Skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    nk = k.shape[1] // chunk

    qg = (q.to(dtype) * scale).reshape(B, Sq, Hkv, G, hd)
    ks = k.to(dtype).reshape(B, nk, chunk, Hkv, hd).transpose(0, 1)
    vs = v.to(dtype).reshape(B, nk, chunk, Hkv, hd).transpose(0, 1)
    ps = kv_pos.reshape(nk, chunk)

    out = _flash_forward(qg, ks, vs, ps, q_pos, causal, window, dtype)
    return out.reshape(B, Sq, Hq, hd).to(dtype)


# ---------------------------------------------------------------------------
# Attention module (projections + cache handling)
# ---------------------------------------------------------------------------


class Attn(nn.Module):
    """Projection weights ``q``, ``k``, ``v``, ``o`` (the reference's keys)."""

    def __init__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor):
        super().__init__()
        self.q, self.k, self.v, self.o = param(q), param(k), param(v), param(o)


def init_attn(gen, d: int, n_heads: int, n_kv: int, hd: int, device,
              keep: Keep = keep_all) -> Attn:
    q = keep("q", dense_init(gen, d, n_heads * hd, device))
    k = keep("k", dense_init(gen, d, n_kv * hd, device))
    v = keep("v", dense_init(gen, d, n_kv * hd, device))
    o = keep("o", dense_init(gen, n_heads * hd, d, device, scale=(n_heads * hd) ** -0.5))
    return Attn(q, k, v, o)


def out_proj(out: torch.Tensor, o: torch.Tensor, dtype: torch.dtype,
             axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """The o projection of the heads' outputs (B, Sq, H, hd)."""
    B, Sq, H, hd = out.shape
    out = out.reshape(B, Sq, H * hd)
    if axis is None:
        return mm(out, o, dtype)
    # row-parallel o: the rank's heads give a partial sum; reduction over
    # the model axis.  A rank with no query head adds zeros (the product
    # over no heads, which keeps its input's gradient on the graph)
    partial = torch.matmul(out.float(), o.float()) if H == 0 else mm_f32(out, o, dtype)
    return reduce_sum(partial, axis, dtype)


class AttnCache(NamedTuple):
    """KV cache for one attention layer."""

    k: torch.Tensor        # (B, S_cache, Hkv, hd)
    v: torch.Tensor        # (B, S_cache, Hkv, hd)


def init_attn_cache(batch: int, s_cache: int, n_kv: int, hd: int, *, dtype, device) -> AttnCache:
    shape = (batch, s_cache, n_kv, hd)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def cache_positions(s_cache: int, pos: int, *, ring: bool, device=None) -> torch.Tensor:
    """Absolute token position stored in each cache slot at decode step
    ``pos`` (the slot for token ``pos`` itself has just been written).
    Invalid slots get -1.  ``ring=True`` for sliding-window ring buffers."""
    idx = torch.arange(s_cache, dtype=torch.int64, device=device)
    if not ring:
        return torch.where(idx <= pos, idx, -1)
    # slot j holds the latest token t <= pos with t % s_cache == j
    t = pos - torch.remainder(pos - idx, s_cache)
    return torch.where(t >= 0, t, -1)


def cross_prefill(
    params: Attn,
    x: torch.Tensor,                  # (B, Sq, D) decoder queries (normed)
    enc_out: torch.Tensor,            # (B, S_enc, D) encoder output
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    q_pos: torch.Tensor,
    chunk: int = 1024,
    cache: Optional[AttnCache] = None,
    dtype: torch.dtype = torch.float32,
    axis: Optional[MeshAxis] = None,
) -> torch.Tensor:
    """Cross-attention over the encoder output at prefill: no RoPE, not
    causal.  Fills ``cache`` (padded past ``S_enc`` slots) in place with the
    projected keys and values, zeros in the padding, for decode
    (:func:`attend` with ``cross_len``)."""
    B, Sq, _ = x.shape
    n_enc = enc_out.shape[1]
    if axis is not None:
        x, enc_out = axis.copy(x), axis.copy(enc_out)
    k = mm(enc_out, params.k, dtype).reshape(B, n_enc, n_kv, hd)
    v = mm(enc_out, params.v, dtype).reshape(B, n_enc, n_kv, hd)
    q = mm(x, params.q, dtype).reshape(B, Sq, n_heads, hd)
    kv_pos = torch.arange(n_enc, device=x.device)
    out = chunked_attention(q, k, v, q_pos, kv_pos, causal=False, chunk=chunk,
                            q_offset=0, dtype=dtype)
    if cache is not None:
        cache.k[:, n_enc:] = 0
        cache.v[:, n_enc:] = 0
        cache.k[:, :n_enc] = k.to(cache.k.dtype)
        cache.v[:, :n_enc] = v.to(cache.v.dtype)
    return out_proj(out, params.o, dtype, axis)


class DecodeForm(NamedTuple):
    """How one decode query meets its self-attention cache."""

    ring: bool                 # the cache is a sliding-window ring buffer
    slot: int                  # where the new token's K and V are written
    causal: bool               # the mask the call applies ...
    window: Optional[int]
    q_offset: int              # ... with the query at this implicit position


def decode_form(s_cache: int, decode_pos: int, window: Optional[int]) -> DecodeForm:
    """The reference's decode mask (``cache_positions`` with causality and
    the window) rewritten as the kernel's implicit-position form.

    A cache no longer than the window is a ring (the reference's rule): slot
    ``pos % s_cache`` takes the new token, and every token it holds lies
    inside the window.  Until the ring is full (``decode_pos < s_cache - 1``)
    the slots above ``decode_pos`` are empty and the call is the causal one
    at ``q_offset = decode_pos``; from then on every slot is valid and the
    call is non-causal, without a window.  A longer cache is written at
    ``decode_pos`` and read causally with the window.
    """
    if window is not None and s_cache <= window:
        if decode_pos >= s_cache - 1:
            return DecodeForm(True, decode_pos % s_cache, False, None, 0)
        return DecodeForm(True, decode_pos, True, None, decode_pos)
    return DecodeForm(False, decode_pos, True, window, decode_pos)


def attend(
    params: Attn,
    x: torch.Tensor,                  # (B, Sq, D)
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    theta: float,
    q_pos: torch.Tensor,              # (Sq,)
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    cache: Optional[AttnCache] = None,
    decode_pos: Optional[int] = None,  # position of the one new token when decoding
    cross_len: Optional[int] = None,   # cross-attention: valid slots of ``cache``
    dtype: torch.dtype = torch.float32,
    axis: Optional[MeshAxis] = None,
) -> tuple[torch.Tensor, Optional[AttnCache]]:
    """Self-attention for prefill (``decode_pos`` None; fills ``cache`` in
    place when given, a ring shorter than the prompt with its tail at slot
    ``pos % s_cache``) and decode (one token against ``cache``, written in
    place at its slot, :func:`decode_form`), and cross-attention decode
    (``cross_len`` given: queries without RoPE against the projected cache,
    whose first ``cross_len`` slots are valid).  Prefill queries sit at
    ``arange(Sq)``; ``causal=False`` is the encoder's self-attention."""
    B, Sq, _ = x.shape
    if axis is not None:   # the rank's heads of q, k, v (column-parallel)
        x = axis.copy(x)
    q = mm(x, params.q, dtype).reshape(B, Sq, n_heads, hd)

    if cross_len is not None:
        # Cross attention against a precomputed (already projected) cache.
        if cache is None:
            raise ValueError("cross-attention decode needs the projected cache")
        s_cache = cache.k.shape[1]
        idx = torch.arange(s_cache, device=x.device)
        kv_pos = torch.where(idx < cross_len, idx, -1)
        out = chunked_attention(
            q, cache.k, cache.v, q_pos, kv_pos, causal=False, chunk=chunk,
            q_offset=0, kv_len=cross_len, dtype=dtype,
        )
        return out_proj(out, params.o, dtype, axis), cache

    q = rope(q, q_pos, theta)
    k = mm(x, params.k, dtype).reshape(B, Sq, n_kv, hd)
    v = mm(x, params.v, dtype).reshape(B, Sq, n_kv, hd)

    if decode_pos is None:
        k = rope(k, q_pos, theta)
        out = chunked_attention(
            q, k, v, q_pos, q_pos, causal=causal, window=window, chunk=chunk,
            q_offset=0, dtype=dtype,
        )
        if cache is not None:
            s_cache = cache.k.shape[1]
            if s_cache >= Sq:
                cache.k[:, :Sq] = k.to(cache.k.dtype)
                cache.v[:, :Sq] = v.to(cache.v.dtype)
            else:
                # a ring shorter than the prompt keeps the tail, token t at
                # slot t % s_cache (ring addressing)
                roll = (Sq - s_cache) % s_cache
                cache.k.copy_(torch.roll(k[:, -s_cache:], roll, dims=1))
                cache.v.copy_(torch.roll(v[:, -s_cache:], roll, dims=1))
        return out_proj(out, params.o, dtype, axis), cache

    # ----- decode: single new token against the cache -----------------------
    if cache is None:
        raise ValueError("decoding needs a KV cache")
    s_cache = cache.k.shape[1]
    form = decode_form(s_cache, decode_pos, window)
    k = rope(k, q_pos, theta)
    cache.k[:, form.slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, form.slot] = v[:, 0].to(cache.v.dtype)
    kv_pos = cache_positions(s_cache, decode_pos, ring=form.ring, device=x.device)
    out = chunked_attention(
        q, cache.k, cache.v, q_pos, kv_pos, causal=form.causal, window=form.window,
        chunk=chunk, q_offset=form.q_offset, dtype=dtype,
    )
    return out_proj(out, params.o, dtype, axis), cache
