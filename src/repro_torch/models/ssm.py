"""State-space / linear-recurrence blocks: the RWKV6 half of ``repro.models.ssm``.

RWKV6 ("Finch") keeps the paper's data-dependent decay.  The WKV recurrence
runs through :func:`repro_torch.kernels.wkv.wkv`: on CUDA the hand-written
kernel runs the prefill (the prompt) in parallel chunks and decode (one step)
with each (batch, head) state on chip, in place of the reference's two-level
``lax.scan``; on the CPU its plain twin steps the same recurrence.

The Mamba2 half (``MambaState``, ``mamba_ssd``, ``mamba_decode``) is not
ported yet: ROADMAP Queue 1, the rest of the LM zoo.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv import wkv
from repro_torch.models.layers import dense_init, mm, param, randn


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, hd, hd) float32
    x_tm: torch.Tensor     # (B, D) last input to time-mix
    x_cm: torch.Tensor     # (B, D) last input to channel-mix


def rwkv_dims(cfg: ArchConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return H, hd


class RWKV(nn.Module):
    """One RWKV6 layer's parameters, named as the reference's pytree keys."""

    NAMES = ("ln1", "ln2", "mu", "Wr", "Wk", "Wv", "Wg", "Wo", "w_base", "w_A",
             "w_B", "u", "ln_x", "mu_c", "Wck", "Wcv", "Wcr")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"RWKV takes exactly {self.NAMES}, got {sorted(tensors)}")
        for name in self.NAMES:
            setattr(self, name, param(tensors[name]))


def init_rwkv(gen, cfg: ArchConfig, device) -> RWKV:
    d, f = cfg.d_model, cfg.d_ff
    H, hd = rwkv_dims(cfg)
    lora = 64

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return RWKV(
        ln1=full((d,), 0.0),
        ln2=full((d,), 0.0),
        mu=full((5, d), 0.5),                       # r,k,v,g,w token-shift mix
        Wr=dense_init(gen, d, d, device),
        Wk=dense_init(gen, d, d, device),
        Wv=dense_init(gen, d, d, device),
        Wg=dense_init(gen, d, d, device),
        Wo=dense_init(gen, d, d, device),
        w_base=full((d,), -6.0),                    # decay ~ exp(-exp(-6)): slow
        w_A=0.01 * randn(gen, (d, lora), device),
        w_B=0.01 * randn(gen, (lora, d), device),
        u=0.1 * randn(gen, (H, hd), device),
        ln_x=full((d,), 0.0),
        mu_c=full((2, d), 0.5),                     # channel-mix k,r
        Wck=dense_init(gen, d, f, device),
        Wcv=dense_init(gen, f, d, device),
        Wcr=dense_init(gen, d, d, device),
    )


def _rwkv_projections(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                      x_prev: torch.Tensor, dtype: torch.dtype):
    """x, x_prev: (B, S, D) -> r, k, v (B, S, H, hd), g (B, S, D), w float32."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    mu = params.mu

    def mixed(i):
        return x + mu[i][None, None] * (x_prev - x)

    r = mm(mixed(0), params.Wr, dtype).reshape(B, S, H, hd)
    k = mm(mixed(1), params.Wk, dtype).reshape(B, S, H, hd)
    v = mm(mixed(2), params.Wv, dtype).reshape(B, S, H, hd)
    g = mm(mixed(3), params.Wg, dtype)
    # data-dependent decay (the RWKV6 contribution)
    ww = params.w_base[None, None] + mm(
        torch.tanh(mm(mixed(4), params.w_A, dtype)), params.w_B, dtype
    ).float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, hd)   # in (0, 1)
    return r, k, v, g, w


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one step later in time; position 0 gets ``last`` (or zeros)."""
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if last is not None:
        x_prev[:, 0] = last.to(x.dtype)
    return x_prev


def rwkv_time_mix(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[RWKVState], dtype: torch.dtype
                  ) -> tuple[torch.Tensor, Optional[RWKVState]]:
    """Time-mix over a sequence (prefill, or decode with S = 1). x: (B, S, D)."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    x_prev = _token_shift(x, None if state is None else state.x_tm)
    r, k, v, g, w = _rwkv_projections(params, cfg, x, x_prev, dtype)

    # r, k, v in the compute dtype: the kernel converts bfloat16 on load
    outs, wkv_state = wkv(r, k, v, w, params.u, None if state is None else state.wkv)
    y = outs.reshape(B, S, D)                              # float32

    # per-head group norm
    yh = y.reshape(B, S, H, hd)
    mu_ = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu_) * torch.rsqrt(var + 1e-5)
    y = yh.reshape(B, S, D) * (1.0 + params.ln_x)
    y = y.to(dtype) * F.silu(g)
    out = mm(y, params.Wo, dtype)
    new_state = None
    if state is not None:
        new_state = RWKVState(wkv_state, x[:, -1].float(), state.x_cm)
    return out, new_state


def rwkv_channel_mix(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                     state: Optional[RWKVState], dtype: torch.dtype
                     ) -> tuple[torch.Tensor, Optional[RWKVState]]:
    x_prev = _token_shift(x, None if state is None else state.x_cm)
    mu = params.mu_c
    xk = x + mu[0][None, None] * (x_prev - x)
    xr = x + mu[1][None, None] * (x_prev - x)
    kk = torch.square(F.relu(mm(xk, params.Wck, dtype)))
    out = torch.sigmoid(mm(xr, params.Wcr, dtype).float()).to(dtype) * mm(kk, params.Wcv, dtype)
    new_state = None
    if state is not None:
        new_state = RWKVState(state.wkv, state.x_tm, x[:, -1].float())
    return out, new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, device) -> RWKVState:
    H, hd = rwkv_dims(cfg)
    return RWKVState(
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
    )
