"""Public wrapper for the WKV6 recurrence kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv.wkv import check_operands, wkv_cuda, wkv_plain


def wkv(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """WKV6 recurrence -> (out (B, S, H, hd), final state (B, H, hd, hd)),
    both float32, computed in float32 as the TPU kernel does.

    CPU tensors take :func:`wkv_plain`; CUDA tensors launch the kernel (and
    raise if it cannot), never the twin.  The kernel reads bfloat16 r, k, v
    as they are (converted on load, exactly); other types are cast to
    float32 here, as are w, u and state0.

    The kernel has no backward yet: on CUDA, where autograd records (grad
    enabled and an operand requiring grad), the call raises
    ``NotImplementedError`` rather than return an output cut from the graph.
    On the CPU the twin is plain PyTorch, and autograd runs through it.
    """
    operands = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if (r.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in operands)):
        raise NotImplementedError(
            "the WKV kernel has no backward on the card yet (ROADMAP Queue 1, the WKV "
            "backward); rwkv6 trains on the CPU only")
    check_operands(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, state0)
    if not (r.dtype == k.dtype == v.dtype == torch.bfloat16):
        r, k, v = (a.float() for a in (r, k, v))
    return wkv_cuda(r, k, v, w.float(), u.float(),
                    None if state0 is None else state0.float())
