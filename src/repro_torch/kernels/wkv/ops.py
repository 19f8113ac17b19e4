"""Public wrapper for the WKV6 recurrence kernels, forward and backward."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv.wkv import (
    check_operands,
    wkv_bwd_cuda,
    wkv_bwd_meta,
    wkv_bwd_plain,
    wkv_cuda,
    wkv_meta,
    wkv_plain,
)


def _kernel_operands(r, k, v, w, u, state0):
    """The operands as the kernels take them: bfloat16 r, k, v as they are
    (converted on load, exactly), other types cast to float32, as are w, u
    and state0."""
    if not (r.dtype == k.dtype == v.dtype == torch.bfloat16):
        r, k, v = (a.float() for a in (r, k, v))
    return r, k, v, w.float(), u.float(), None if state0 is None else state0.float()


class WKV(torch.autograd.Function):
    """The WKV6 recurrence under autograd, in place of the reference's
    autodiff of its scan (``repro.models.ssm.rwkv_time_mix``).

    On CUDA the forward launches the forward kernel and keeps the state at
    the start of each of the backward's chunks; the backward launches the
    backward kernel, which recomputes the states inside each chunk.  On the
    CPU both call the plain twins (:func:`wkv_plain`, :func:`wkv_bwd_plain`),
    so the CPU tests run this Function's own wiring; on ``meta`` the
    kernels' meta branches count the launches.  An unused output's
    gradient may be None (the final state's, usually).  Each gradient comes
    back in its operand's dtype.
    """

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.set_materialize_grads(False)
        ctx.dtypes = tuple(None if a is None else a.dtype for a in (r, k, v, w, u, state0))
        if r.device.type == "cpu":
            out, stateT = wkv_plain(r, k, v, w, u, state0)
            ctx.save_for_backward(r, k, v, w, u, state0)
        else:   # the kernel on CUDA, a launch counted on meta
            ops = _kernel_operands(r, k, v, w, u, state0)
            fwd = wkv_meta if r.device.type == "meta" else wkv_cuda
            out, stateT, starts = fwd(*ops, return_starts=True)
            ctx.save_for_backward(*ops[:5], starts)
        return out, stateT

    @staticmethod
    def backward(ctx, dout, dstateT):
        saved = ctx.saved_tensors   # r, k, v, w, u, then state0 (CPU) or the chunk starts
        r = saved[0]
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dout = dout.float()
        dstateT = None if dstateT is None else dstateT.float()
        if r.device.type == "cpu":
            grads = wkv_bwd_plain(*saved[:5], dout, saved[5], dstateT)
        else:
            bwd = wkv_bwd_meta if r.device.type == "meta" else wkv_bwd_cuda
            grads = bwd(*saved[:5], dout, saved[5], dstateT)
        return tuple(None if dtype is None or not needed else g.to(dtype)
                     for g, dtype, needed in zip(grads, ctx.dtypes, ctx.needs_input_grad))


def wkv(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """WKV6 recurrence -> (out (B, S, H, hd), final state (B, H, hd, hd)),
    both float32, computed in float32 as the TPU kernel does.

    Where autograd records (grad enabled and an operand requiring grad) the
    call runs through :class:`WKV`, on either device.  Otherwise CPU tensors
    take :func:`wkv_plain` and CUDA tensors launch the kernel (and raise if
    it cannot), never the twin; ``meta`` tensors (a dry run) take
    :func:`wkv_meta`, which counts a launch and runs nothing.  The kernel
    reads bfloat16 r, k, v as they are (converted on load, exactly); other
    types are cast to float32 here, as are w, u and state0.
    """
    check_operands(r, k, v, w, u, state0)
    operands = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return WKV.apply(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, state0)
    fwd = wkv_meta if r.device.type == "meta" else wkv_cuda
    return fwd(*_kernel_operands(r, k, v, w, u, state0))
