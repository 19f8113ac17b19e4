"""Public wrapper for the flash-attention kernels, forward and backward."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_operands,
    flash_attention_cuda,
    flash_attention_meta,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_meta,
    flash_attention_bwd_plain,
)

# the forward and backward by the operands' device type: the plain twins on
# the CPU, the kernels on CUDA, a launch counted without running on meta
_FORWARD = {"cpu": flash_attention_plain, "meta": flash_attention_meta}
_BACKWARD = {"cpu": flash_attention_bwd_plain, "meta": flash_attention_bwd_meta}


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd, the counterpart of the reference's
    ``jax.custom_vjp`` around its chunked attention.

    The forward keeps its output and each row's log-sum-exp (B, Hq, Sq) for
    the backward.  On CUDA the forward launches the forward kernel and the
    backward the backward kernel; on the CPU both call the plain twins
    (:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`), so
    the CPU tests run this Function's own wiring; on ``meta`` the
    kernels' meta branches count the launches.  Query heads fold onto
    their KV heads inside the kernels and twins (dk, dv sum over the G heads
    of a group); each gradient comes back in its operand's dtype.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fwd = _FORWARD.get(q.device.type, flash_attention_cuda)
        o, lse = fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.form = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _BACKWARD.get(q.device.type, flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, o, do.to(o.dtype), lse, **ctx.form)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """(B, Sq, Hq, hd) x (B, Skv, Hkv, hd)^2 -> (B, Sq, Hq, hd) in q's dtype;
    GQA aware, query ``i`` at position ``q_offset + i``.

    Where autograd records (grad enabled and an operand requiring grad) the
    call runs through :class:`FlashAttention`.  Otherwise CPU tensors take
    :func:`flash_attention_plain` and CUDA tensors launch the kernel (and
    raise if it cannot), never the twin; ``meta`` tensors (a dry run) take
    :func:`flash_attention_meta`, which counts a launch and runs nothing.
    """
    check_operands(q, k, v, window=window, q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    fwd = _FORWARD.get(q.device.type, flash_attention_cuda)
    return fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
