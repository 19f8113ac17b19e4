"""Mixture-of-Experts FFN: top-k router, capacity-bounded einsum dispatch.

Port of ``repro.models.moe``: GShard / Switch-style dense dispatch, chunked
over the sequence (``cfg.moe_chunk``) so the (B, cs, E, C) one-hot tensors
stay small.  Per chunk: softmax gates, top-k choices with their weights
renormalised, each (token, choice)'s place in its expert's queue from a
cumulative sum over the chunk's flattened ``cs * top_k`` choices per batch
row, choices past the capacity dropped (padded tokens get none), then the
dispatch, expert and combine einsums.  Shared experts (Qwen-MoE: 4,
Llama-4: 1) run as one wide gated MLP on every token.  The Switch
load-balancing loss comes back beside the output; serving ignores it.

The reference computes all of this outside any Pallas kernel, so the port
keeps it in plain PyTorch (``torch.einsum`` / cuBLAS on the card).

Sharded over a model axis (``axis``; the reference's rules,
:mod:`repro_torch.sharding`): the router is replicated, so every rank
routes every token over all E experts identically (capacity and queue
positions included) and the tokens are already on every rank: no
all-to-all.  With the experts over the axis (llama4: E % 16 == 0) a rank
computes its E / model experts in full from its slice of the dispatch and
combine tensors (the combine a partial over E); otherwise (qwen2: 60
experts) every expert on its slice of F, its float32 partial ``y``
combined as it is (the unsharded block rounds ``y`` first; summing ``y``
before the combine would reduce ~5x the bytes at prefill, ~250x at
decode).  The shared expert is split by F.  Each rank's float32 partials of
a block, every chunk's and the shared expert's, are summed over the axis
in one all-reduce; the experts' sum and the shared expert's are each
rounded to the compute dtype and then added, as the unsharded block
rounds and adds them.

In training the tokens enter the rank's experts (the dispatch and the
shared expert) and the top-k weights enter the combine through
``MeshAxis.copy``, so their gradients' partials are summed over the model
axis; the router, whose logits every rank forms alike, gets the whole
gradient on every rank.  Rows split over data axes (``rows``) form the
Switch loss's ``me`` and ``ce`` over the whole batch, as the reference's
GSPMD step does: each is summed over those axes (``MeshAxis.sum``) and
divided by their ranks.  Routing itself is per batch row (capacity and
queue positions count along the row), so splitting rows moves no choice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    MLP, Keep, MeshAxis, act_fn, dense_init, init_mlp, keep_all, mlp_apply, mlp_hidden, mm,
    mm_f32, param, scoped)


class MoE(nn.Module):
    """``router`` (D, E), ``w_in`` / ``w_gate`` (E, D, F), ``w_out`` (E, F, D)
    and, with shared experts, ``shared`` (one MLP of width n_shared * F)."""

    def __init__(self, router: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
                 w_out: torch.Tensor, shared: Optional[MLP] = None):
        super().__init__()
        self.router, self.w_in = param(router), param(w_in)
        self.w_gate, self.w_out = param(w_gate), param(w_out)
        self.shared = shared


def init_moe(gen, cfg: ArchConfig, device, keep: Keep = keep_all) -> MoE:
    """Each expert's weights drawn one expert at a time and kept (or
    dropped) as drawn, so a sharded init never holds every expert."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff

    def experts(name, d_in, d_out, scale=None):
        kept = (keep(name, dense_init(gen, d_in, d_out, device, scale=scale), j)
                for j in range(e))
        return torch.stack([t for t in kept if t is not None])

    router = keep("router", dense_init(gen, d, e, device))
    w_in = experts("w_in", d, f)
    w_gate = experts("w_gate", d, f)
    w_out = experts("w_out", f, d, scale=f ** -0.5)
    shared = (init_mlp(gen, d, cfg.n_shared_experts * f, device, keep=scoped(keep, "shared."))
              if cfg.n_shared_experts else None)
    return MoE(router, w_in, w_gate, w_out, shared)


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert and batch row for a chunk of ``tokens`` tokens."""
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` of operands rounded to ``dtype`` with float32 accumulation,
    the result rounded to ``dtype`` (the reference's ``preferred_element_type``
    float32 then ``astype``)."""
    return torch.einsum(eq, a.to(dtype), b.to(dtype)).to(dtype)


def route(params: MoE, x: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype):
    """Softmax gates (B, S, E) over the router's logits, the top-k weights
    renormalised to sum to 1 and the chosen experts (B, S, K).  Equal gates
    go to the lower expert first, as ``jax.lax.top_k`` orders them (a padded
    token's gates are all equal, and its first choice enters the loss)."""
    logits = mm(x, params.router, dtype).float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :cfg.top_k], top_i[..., :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return gates, top_w, top_i


def moe_apply(params: MoE, x: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype,
              axis: Optional[MeshAxis] = None, rows: tuple = ()
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN.  x: (B, S, D) -> (out in ``dtype``, float32 aux loss).
    With ``axis`` the weights are the rank's shard; with ``rows`` (the
    :class:`MeshAxis` es the batch's rows split over) the aux loss is the
    whole batch's (module docstring)."""
    B, S0, D = x.shape
    cs = min(cfg.moe_chunk, S0)
    pad = (-S0) % cs
    S = S0 + pad
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    nc = S // cs
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cs, cfg)
    act = act_fn(cfg.act)

    local_experts = params.w_in.shape[0]
    if local_experts < E and (axis is None or local_experts * axis.size != E):
        raise ValueError(f"{local_experts} of {E} experts on this rank: not an even split "
                         f"over the model axis")
    valid = (torch.arange(S, device=x.device) < S0).float()   # padded tokens: no capacity
    x_tp = x if axis is None else axis.copy(x)   # the tokens the rank's experts see
    n_rows = math.prod(a.size for a in rows)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    partials = []   # float32 partials over the model axis
    for c in range(nc):
        x_c = x[:, c * cs:(c + 1) * cs]                            # (B, cs, D)
        v_c = valid[c * cs:(c + 1) * cs]                           # (cs,)
        gates, top_w, top_i = route(params, x_c, cfg, dtype)

        # Position of each (token, choice) in its expert queue.  One-hot
        # rows by comparison (no device sync, so a decode step can be
        # captured in a CUDA graph).
        oh = (top_i[..., None] == torch.arange(E, device=x.device)).float()   # (B, cs, K, E)
        ohf = oh.reshape(B, cs * K, E)
        pos = torch.cumsum(ohf, dim=1) - ohf
        pos_in_e = (pos * ohf).sum(-1).reshape(B, cs, K)           # (B, cs, K)
        keep = (pos_in_e < C).float() * v_c[None, :, None]

        # a dropped choice (slot >= C) has no slot: an all-zero row, as
        # jax.nn.one_hot gives for an index past the classes
        slot_oh = (pos_in_e[..., None] == torch.arange(C, device=x.device)).float()
        dis = torch.einsum("bske,bskc->bsec", oh * keep[..., None], slot_oh)
        if axis is not None:
            top_w = axis.copy(top_w)
        com = torch.einsum("bske,bskc->bsec", oh * (keep * top_w)[..., None], slot_oh)

        if local_experts < E:   # this rank's experts of the dispatch and combine
            e0 = axis.rank * local_experts
            dis, com = dis[:, :, e0:e0 + local_experts], com[:, :, e0:e0 + local_experts]
        xd = _einsum("bsec,bsd->becd", dis, x_tp[:, c * cs:(c + 1) * cs], dtype)   # (B, E, C, D)
        h = _einsum("becd,edf->becf", xd, params.w_in, dtype)
        g = _einsum("becd,edf->becf", xd, params.w_gate, dtype)
        h = act(g) * h
        if axis is None:
            y = _einsum("becf,efd->becd", h, params.w_out, dtype)
            outs.append(_einsum("bsec,becd->bsd", com, y, dtype))
        elif local_experts < E:   # whole experts: the combine is a partial over E
            y = _einsum("becf,efd->becd", h, params.w_out, dtype)
            partials.append(mm_f32(com.reshape(B, cs, -1), y.reshape(B, -1, D), dtype))
        else:                     # every expert on a slice of F: y is a partial over F,
            El, Fl = h.shape[1], h.shape[-1]   # combined as it is (a partial over F too)
            y = mm_f32(h.transpose(0, 1).reshape(El, -1, Fl), params.w_out, dtype)  # (E, B C, D)
            y = y.reshape(El, B, -1, D).transpose(0, 1).reshape(B, -1, D)
            partials.append(torch.bmm(com.to(dtype).float().reshape(B, cs, -1), y))

        # Switch-style load-balancing aux loss for this chunk.
        me = gates.mean(dim=(0, 1))                                # (E,)
        ce = oh[:, :, 0, :].mean(dim=(0, 1))                       # top-1 assignment
        if rows:   # the means over every row of the batch
            stats = torch.stack([me, ce])
            for a in rows:
                stats = a.sum(stats)
            me, ce = stats / n_rows
        aux = aux + E * (me * ce).sum()

    x = x[:, :S0]
    if axis is None:
        out = torch.cat(outs, dim=1)[:, :S0]
        if params.shared is not None:
            out = out + mlp_apply(params.shared, x, cfg.act, dtype)
        return out, aux / nc
    if params.shared is not None:   # the shared expert's partial over its slice of F
        partials.append(mm_f32(mlp_hidden(params.shared, x_tp[:, :S0], cfg.act, dtype),
                               params.shared.w_out, dtype))
    # every partial of the block (each chunk's experts and the shared
    # expert's) in one reduction over the model axis; each sum is then
    # rounded to the compute dtype and the two added, as unsharded
    flat = axis.reduce(torch.cat([t.reshape(-1) for t in partials]))
    sums = [t.view(shape).to(dtype) for t, shape in zip(
        torch.split(flat, [t.numel() for t in partials]), [t.shape for t in partials])]
    out = torch.cat(sums[:nc], dim=1)[:, :S0]
    if params.shared is not None:
        out = out + sums[nc]
    return out, aux / nc
