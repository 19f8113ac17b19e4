"""GQA attention with RoPE, KV caches and chunked (flash-style) computation.

Port of ``repro.models.attention``.  :func:`chunked_attention` is the hot
spot.  On the CPU it is the reference's pure online-softmax scan over KV
chunks (dense softmax for a single decode query).  On CUDA it launches the
hand-written flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`),
which computes the same function; there the positions are implicit — query
``i`` at ``q_offset + i``, key ``j`` at ``j`` — which is the form of every
call the ported serving path makes (prefill, and decode against a cache that
is not a ring buffer).  Forms the kernel cannot express (ring caches for
sliding-window layers, padded cross-attention caches) raise on CUDA.

The reference's custom VJP (the flash backward) belongs to the training
slice and is not ported; KV caches are updated in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import dense_init, mm, param

NEG_INF = -1e30

NOT_PORTED = "ROADMAP Queue 1, the rest of the LM zoo"


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
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Flash-style attention over KV chunks. Returns (B, Sq, Hq, hd) in ``dtype``.

    ``q_offset`` says that the positions are the kernel's implicit form
    (``q_pos = q_offset + arange(Sq)``, ``kv_pos = arange(Skv)`` with the
    slots above the last query masked by causality); CUDA tensors need it
    and launch the flash kernel.  CPU tensors run the reference's scan on
    ``q_pos`` / ``kv_pos``.
    """
    if q.device.type == "cuda":
        if q_offset is None:
            raise NotImplementedError(
                "attention positions the flash kernel cannot express (ring "
                f"or padded caches) are not ported to CUDA: {NOT_PORTED}"
            )
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


def init_attn(gen, d: int, n_heads: int, n_kv: int, hd: int, device) -> Attn:
    q = dense_init(gen, d, n_heads * hd, device)
    k = dense_init(gen, d, n_kv * hd, device)
    v = dense_init(gen, d, n_kv * hd, device)
    o = dense_init(gen, n_heads * hd, d, device, scale=(n_heads * hd) ** -0.5)
    return Attn(q, k, v, o)


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
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, Optional[AttnCache]]:
    """Self-attention for prefill (``decode_pos`` None; fills ``cache`` in
    place when given) and decode (one token against ``cache``, written in
    place at slot ``decode_pos``).  Prefill queries sit at ``arange(Sq)``."""
    B, Sq, _ = x.shape
    q = mm(x, params.q, dtype).reshape(B, Sq, n_heads, hd)
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
            if cache.k.shape[1] < Sq:
                raise NotImplementedError(
                    f"a ring cache shorter than the prefill is not ported: {NOT_PORTED}"
                )
            cache.k[:, :Sq] = k.to(cache.k.dtype)
            cache.v[:, :Sq] = v.to(cache.v.dtype)
        return mm(out.reshape(B, Sq, n_heads * hd), params.o, dtype), cache

    # ----- decode: single new token against the cache -----------------------
    if cache is None:
        raise ValueError("decoding needs a KV cache")
    s_cache = cache.k.shape[1]
    if window is not None and s_cache <= window:
        raise NotImplementedError(f"ring-buffer KV caches are not ported: {NOT_PORTED}")
    k = rope(k, q_pos, theta)
    cache.k[:, decode_pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, decode_pos] = v[:, 0].to(cache.v.dtype)
    kv_pos = cache_positions(s_cache, decode_pos, ring=False, device=x.device)
    out = chunked_attention(
        q, cache.k, cache.v, q_pos, kv_pos, causal=True, window=window, chunk=chunk,
        q_offset=decode_pos, dtype=dtype,
    )
    return mm(out.reshape(B, Sq, n_heads * hd), params.o, dtype), cache
