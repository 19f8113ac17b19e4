"""Plain oracle for the flash-attention kernel (GQA, causal, windowed).

Ports ``repro.kernels.flash_attention.ref``: dense float32 scores, masked
entries at -1e30, one softmax.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,      # (B, Sq, Hq, hd)
    k: torch.Tensor,      # (B, Skv, Hkv, hd)
    v: torch.Tensor,      # (B, Skv, Hkv, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention with query ``i`` at position ``q_offset + i`` and key ``j``
    at ``j``; returns float32 (B, Sq, Hq, hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qs = q.float().reshape(B, Sq, Hkv, G, hd) / math.sqrt(hd)
    s = torch.einsum("bqhgd,bchd->bqhgc", qs, k.float())
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    kv_pos = torch.arange(Skv, device=q.device)
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgc,bchd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, hd)


def attention_partials(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lo: int,
    hi: int,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The softmax state of one key range ``[lo, hi)``, as a split of the
    bfloat16 kernel leaves it: ``m`` (B, Sq, Hq), the max score (-1e30 if
    every key is masked, -inf if the range is empty), ``l`` the sum of
    ``exp(s - m)`` and ``acc`` (B, Sq, Hq, hd) the unnormalised sum of
    ``exp(s - m) v``, all float32."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    lo, hi = max(lo, 0), min(hi, Skv)
    if hi <= lo:
        m = torch.full((B, Sq, Hq), float("-inf"), device=q.device)
        return m, torch.zeros_like(m), torch.zeros((B, Sq, Hq, hd), device=q.device)
    qs = q.float().reshape(B, Sq, Hkv, G, hd) / math.sqrt(hd)
    s = torch.einsum("bqhgd,bchd->bqhgc", qs, k[:, lo:hi].float())
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    kv_pos = torch.arange(lo, hi, device=q.device)
    valid = torch.ones((Sq, hi - lo), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bqhgc,bchd->bqhgd", p, v[:, lo:hi].float())
    return m.reshape(B, Sq, Hq), p.sum(-1).reshape(B, Sq, Hq), acc.reshape(B, Sq, Hq, hd)


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Merge per-split softmax states, stacked on dim 0 in split order, into
    the attention output, as the kernel's combine step does: with ``M`` the
    max of ``m`` over splits that hold keys, split ``s`` weighs
    ``exp(m_s - M)`` (0 for an empty split, never ``exp(-inf - -inf)``), and
    the output is ``sum w acc / max(sum w l, 1e-30)``."""
    has_keys = l > 0
    M = torch.where(has_keys, m, float("-inf")).amax(0)
    w = torch.where(has_keys, torch.exp(torch.where(has_keys, m - M, 0.0)), 0.0)
    L = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0)
    return out / torch.clamp(L, min=1e-30)[..., None]
