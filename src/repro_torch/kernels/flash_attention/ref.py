"""Plain oracles for the flash-attention kernels (GQA, causal, windowed).

:func:`attention_ref` ports ``repro.kernels.flash_attention.ref``: dense
float32 scores, masked entries at -1e30, one softmax.
:func:`attention_bwd_ref` ports the reference's flash backward
(``repro.models.attention._flash_bwd``): dq, dk, dv from the forward's
output and log-sum-exp, scores recomputed per KV chunk.
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
    return_lse: bool = False,
):
    """Attention with query ``i`` at position ``q_offset + i`` and key ``j``
    at ``j``; returns float32 (B, Sq, Hq, hd), and with ``return_lse`` also
    each row's log-sum-exp of its masked scores (B, Hq, Sq), float32."""
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
    o = torch.einsum("bqhgc,bchd->bqhgd", p, v.float()).reshape(B, Sq, Hq, hd)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).reshape(B, Sq, Hq).permute(0, 2, 1)
    return o, lse.contiguous()


def attention_bwd_ref(
    q: torch.Tensor,      # (B, Sq, Hq, hd)
    k: torch.Tensor,      # (B, Skv, Hkv, hd)
    v: torch.Tensor,      # (B, Skv, Hkv, hd)
    o: torch.Tensor,      # (B, Sq, Hq, hd) the forward's output
    do: torch.Tensor,     # (B, Sq, Hq, hd) its cotangent
    lse: torch.Tensor,    # (B, Hq, Sq) the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (float32, the operands' shapes) of :func:`attention_ref`,
    as the reference's ``_flash_bwd`` computes them: ``delta = sum(dO O)``,
    then per chunk of ``chunk`` keys the scores again, ``p = exp(s - lse)``
    on valid pairs and 0 elsewhere, ``dv = p^T dO``, ``dp = dO v^T``,
    ``ds = p (dp - delta)``, ``dq += ds k`` and ``dk = ds^T q``, with ``s``
    the scores of ``q / sqrt(hd)``."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, Hkv, G, hd) * scale
    dog = do.float().reshape(B, Sq, Hkv, G, hd)
    lse_g = lse.float().permute(0, 2, 1).reshape(B, Sq, Hkv, G)
    delta = (dog * o.float().reshape(B, Sq, Hkv, G, hd)).sum(-1)          # (B, Sq, Hkv, G)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for lo in range(0, Skv, chunk):
        k_c, v_c = k[:, lo:lo + chunk].float(), v[:, lo:lo + chunk].float()
        kv_pos = torch.arange(lo, lo + k_c.shape[1], device=q.device)
        valid = torch.ones((Sq, k_c.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, k_c)
        p = torch.where(valid[None, :, None, None, :], torch.exp(s - lse_g[..., None]), 0.0)
        dvs.append(torch.einsum("bqhgc,bqhgd->bchd", p, dog))
        dp = torch.einsum("bqhgd,bchd->bqhgc", dog, v_c)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqhgc,bchd->bqhgd", ds, k_c)
        dks.append(torch.einsum("bqhgc,bqhgd->bchd", ds, qg))
    return (dq.reshape(B, Sq, Hq, hd) * scale, torch.cat(dks, dim=1), torch.cat(dvs, dim=1))


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
