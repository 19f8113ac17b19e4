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
