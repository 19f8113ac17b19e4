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
one rank's slices carries its model axis (a :class:`MeshAxis`), and each
row-parallel product (:func:`mm_f32`) is summed over it by
:func:`reduce_sum` where the apply function forms it, in float32 before the
one rounding to the compute dtype, as GSPMD all-reduces the reference's
float32 accumulator before its ``astype``.  The collectives are autograd
Functions (Megatron's f and g): :meth:`MeshAxis.copy` where a replicated
activation meets a rank's slice of a weight (identity forward, its
gradient's partials summed over the axis), :meth:`MeshAxis.reduce` where
the partials are summed (identity backward).  With that rule every
replicated activation's gradient, and every replicated weight's, is whole
and the same on every rank of the axis.  Where a product needs a
replicated activation's channels rank by rank (RWKV6's channel mix),
:meth:`MeshAxis.scatter_sum` sums partials into the rank's channels and
:meth:`MeshAxis.concat` puts the ranks' channels together again.  A weight
held as the rank's piece over the data axis (FSDP, :class:`Fsdp`) is
gathered just before use, its gradient reduce-scattered back.

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

import contextlib
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


class MeshAxis:
    """One axis of a device mesh as the apply functions see it: its process
    group, its size, this rank's index along it and its name on the mesh.
    Its collectives are autograd Functions (module docstring)."""

    def __init__(self, group, size: int, rank: int, name: Optional[str] = None):
        self.group, self.size, self.rank, self.name = group, size, rank, name

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it is; in the backward its gradient summed over the
        axis (in float32)."""
        return _Copy.apply(t, self)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis (every rank gets the sum; ``t`` is
        overwritten); the backward passes the gradient through."""
        return _Reduce.apply(t, self)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis, and the gradient summed over it in the
        backward: the sum's own gradient when every rank's loss depends on
        the sum."""
        return _Sum.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces of ``t`` along ``dim`` put together in rank
        order; the backward sums the gradient over the axis and keeps the
        rank's piece (a reduce-scatter)."""
        return _Gather.apply(t, self, dim)

    def scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` summed over the axis, and only the rank's piece along
        ``dim`` kept (a reduce-scatter of partials); the backward gathers the
        gradient's pieces: every rank's ``t`` reaches every piece."""
        return _ScatterSum.apply(t, self, dim)

    def concat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces of a replicated activation along ``dim`` put
        together in rank order; the backward keeps the rank's piece of the
        gradient, which every rank holds whole (Megatron's gather)."""
        return _Concat.apply(t, self, dim)

    # -- the collectives themselves, out of place where they return a new
    # tensor; the same calls over NCCL and over gloo (which takes CUDA
    # tensors through the host)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        t = t.movedim(dim, 0).contiguous()
        full = t.new_empty((t.shape[0] * self.size, *t.shape[1:]))
        dist.all_gather_into_tensor(full, t, group=self.group)
        return full.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out.movedim(0, dim).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.to(torch.float32, copy=True)).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.mark_dirty(t)
        return axis.all_reduce_(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g, ctx.dim), None, None


class Fsdp:
    """A model's weights held as the rank's piece over the data axis
    (``dims``: parameter name -> the dimension split), gathered just before
    use: :meth:`gathered` puts each weight of a module gathered in the
    place of its piece for the length of the block (the apply functions
    read the module's attributes), an autograd Function whose backward
    reduce-scatters the gradient into the piece's."""

    def __init__(self, axis: MeshAxis, dims: dict, model: nn.Module):
        self.axis, self.dims = axis, dict(dims)
        self._held = {}   # id(module) -> [(attribute, dim)]
        for mname, module in model.named_modules():
            for pname in module._parameters:
                dim = self.dims.get(f"{mname}.{pname}" if mname else pname)
                if dim is not None:
                    self._held.setdefault(id(module), []).append((pname, dim))

    @contextlib.contextmanager
    def gathered(self, module: nn.Module, recurse: bool = True):
        """Within the block, every weight of ``module`` (only its own with
        ``recurse=False``) that the rank holds a piece of is the whole
        weight (over the data axis), recorded by autograd."""
        swapped = []
        try:
            for m in (module.modules() if recurse else (module,)):
                for pname, dim in self._held.get(id(m), ()):
                    piece = m._parameters[pname]
                    swapped.append((m, pname, piece))
                    m._parameters[pname] = self.axis.gather(piece, dim)
            yield
        finally:
            for m, pname, piece in swapped:
                m._parameters[pname] = piece


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g, ctx.dim), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None


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
    if x.device.type in ("cuda", "meta"):   # the GEMM writes its float32 accumulator
        if w.ndim == 3:
            return _MmF32.apply(x, w)
        out = _MmF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())   # bfloat16 products are exact in float32


class _MmF32(torch.autograd.Function):
    """The CUDA GEMM of :func:`mm_f32` (``out_dtype=torch.float32``, which
    autograd cannot differentiate) of a matrix, or of a batch of them; its
    backward is the one of the GEMM rounded to ``x``'s dtype: the gradient
    rounded to it, then its GEMMs.  Its output is no view (the reduction
    over the model axis writes it in place)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        mm = torch.bmm if w.ndim == 3 else torch.mm
        return mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.transpose(-1, -2), x.transpose(-1, -2) @ g


def reduce_sum(partial: torch.Tensor, axis: MeshAxis, dtype: torch.dtype) -> torch.Tensor:
    """A float32 partial summed over the model axis, then rounded to ``dtype``."""
    return axis.reduce(partial.float()).to(dtype)


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
              axis: Optional[MeshAxis] = None) -> torch.Tensor:
    if axis is None:
        return mm(mlp_hidden(params, x, act, dtype), params.w_out, dtype)
    h = mlp_hidden(params, axis.copy(x), act, dtype)   # column-parallel w_in, w_gate
    # row-parallel w_out: each rank's slice of F gives a partial sum;
    # reduction over the model axis
    return reduce_sum(mm_f32(h, params.w_out, dtype), axis, dtype)
