"""Shared layers and initializers for the model zoo.

Port of ``repro.models.layers``.  The reference fixes its compute dtype when
it is imported (``REPRO_COMPUTE_DTYPE``); here every function that rounds
takes ``dtype`` explicitly and the model carries it
(:attr:`repro_torch.models.lm.LM.compute_dtype`).  The card's policy is the
reference's TPU policy: bfloat16 weights and activations with float32
accumulation (:func:`mm`), float32 norms and recurrent state.  The CPU tests
run float32, as the reference's tests do.

The reference's sharding hints (``set_sharding_hints``, ``constrain``) place
tensors on a device mesh for GSPMD, which inserts the collectives.  The port
shards explicitly (:mod:`repro_torch.sharding`): a model whose weights are
one rank's slices carries a :class:`ModelAxis`, and each row-parallel
product (:func:`mm_f32`) is summed over it by :func:`reduce_sum` where the
apply function forms it, in float32 before the one rounding to the compute
dtype, as GSPMD all-reduces the reference's float32 accumulator before its
``astype``.

The initializers take ``keep`` (:data:`Keep`), called on every drawn weight
with its parameter name right after the draw; it returns the part to keep
(the whole weight by default, one rank's slice in a sharded init), so the
draws stay the same whatever is kept.

Parameters are ``nn.Parameter``s named as the reference's pytree keys (so
:mod:`repro_torch.convert` can carry a reference pytree across), created
without gradients, so serving records no graph; the train step
(:func:`repro_torch.models.lm.make_train_step`) turns them on.  Weights are
cast to the compute dtype where they are used (:func:`mm`, the MoE and SSM
einsums), so float32 masters train in bfloat16 as the reference's do.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# keep(parameter name, drawn float32 weight, expert index or None) -> the
# part to keep, or None for an expert this rank does not hold
Keep = Callable[..., Optional[torch.Tensor]]


def keep_all(name: str, t: torch.Tensor, expert: Optional[int] = None) -> torch.Tensor:
    """The default :data:`Keep`: the whole weight."""
    return t


def scoped(keep: Keep, prefix: str) -> Keep:
    """``keep`` for the parameters of a submodule named ``prefix``."""
    if keep is keep_all:
        return keep_all
    return lambda name, t, expert=None: keep(prefix + name, t, expert)


class ModelAxis:
    """The model axis of a device mesh as the apply functions see it: its
    process group, its size and this rank's index along it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis in place (every rank gets the sum)."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t


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


def mm_f32(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`mm` before its rounding: operands rounded to ``dtype``, the
    product accumulated and returned in float32 (a row-parallel partial).
    ``w`` is a matrix, or a batch of them against a 3-D ``x``."""
    x, w = x.to(dtype), w.to(dtype)
    if dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":   # the GEMM writes its float32 accumulator
        if w.ndim == 3:
            return torch.bmm(x, w, out_dtype=torch.float32)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())   # bfloat16 products are exact in float32


def reduce_sum(partial: torch.Tensor, axis: ModelAxis, dtype: torch.dtype) -> torch.Tensor:
    """A float32 partial summed over the model axis, then rounded to ``dtype``."""
    return axis.all_reduce(partial.float()).to(dtype)


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


def init_mlp(gen, d: int, f: int, device, keep: Keep = keep_all) -> MLP:
    w_in = keep("w_in", dense_init(gen, d, f, device))
    w_gate = keep("w_gate", dense_init(gen, d, f, device))
    w_out = keep("w_out", dense_init(gen, f, d, device))
    return MLP(w_in, w_gate, w_out)


def mlp_hidden(params: MLP, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    """The gated hidden activations (column-parallel: a rank's slice of F)."""
    return act_fn(act)(mm(x, params.w_gate, dtype)) * mm(x, params.w_in, dtype)


def mlp_apply(params: MLP, x: torch.Tensor, act: str, dtype: torch.dtype,
              axis: Optional[ModelAxis] = None) -> torch.Tensor:
    h = mlp_hidden(params, x, act, dtype)
    if axis is None:
        return mm(h, params.w_out, dtype)
    # row-parallel w_out: each rank's slice of F gives a partial sum;
    # reduction over the model axis
    return reduce_sum(mm_f32(h, params.w_out, dtype), axis, dtype)
