"""Shared layers and initializers for the model zoo.

Port of ``repro.models.layers``.  The reference fixes its compute dtype when
it is imported (``REPRO_COMPUTE_DTYPE``); here every function that rounds
takes ``dtype`` explicitly and the model carries it
(:attr:`repro_torch.models.lm.LM.compute_dtype`).  The card's policy is the
reference's TPU policy: bfloat16 weights and activations with float32
accumulation (:func:`mm`), float32 norms and recurrent state.  The CPU tests
run float32, as the reference's tests do.

The reference's sharding hints (``set_sharding_hints``, ``constrain``) place
tensors on a device mesh for GSPMD; on one card they have no meaning and are
not ported.

Parameters are ``nn.Parameter``s named as the reference's pytree keys (so
:mod:`repro_torch.convert` can carry a reference pytree across), created
without gradients, so serving records no graph; the train step
(:func:`repro_torch.models.lm.make_train_step`) turns them on.  Weights are
cast to the compute dtype where they are used (:func:`mm`, the MoE and SSM
einsums), so float32 masters train in bfloat16 as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """A gradient-free parameter holding ``t``."""
    return nn.Parameter(t, requires_grad=False)


def randn(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` (``None`` only on ``meta``)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Matmul in ``dtype`` with float32 accumulation (the last dim of x
    contracts); the result is in ``dtype``."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def dense_init(gen, d_in: int, d_out: int, device, scale: Optional[float] = None) -> torch.Tensor:
    if scale is None:
        scale = d_in ** -0.5
    return scale * randn(gen, (d_in, d_out), device)


def embed_init(gen, vocab: int, d: int, device) -> torch.Tensor:
    return 0.02 * randn(gen, (vocab, d), device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
              dtype: torch.dtype) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(dtype)


def act_fn(name: str):
    """The reference's activations (``jax.nn.gelu`` is the tanh form)."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# Gated MLP (llama-style); used by every attention block.
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor):
        super().__init__()
        self.w_in, self.w_gate, self.w_out = param(w_in), param(w_gate), param(w_out)


def init_mlp(gen, d: int, f: int, device) -> MLP:
    w_in = dense_init(gen, d, f, device)
    w_gate = dense_init(gen, d, f, device)
    w_out = dense_init(gen, f, d, device)
    return MLP(w_in, w_gate, w_out)


def mlp_apply(params: MLP, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    h = act_fn(act)(mm(x, params.w_gate, dtype)) * mm(x, params.w_in, dtype)
    return mm(h, params.w_out, dtype)
