"""Public wrapper for the WKV6 recurrence kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv.wkv import check_operands, wkv_cuda, wkv_plain


def wkv(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """WKV6 recurrence -> (out (B, S, H, hd), final state (B, H, hd, hd)),
    both float32; operands are taken as float32, as the TPU kernel casts them.

    CPU tensors take :func:`wkv_plain`; CUDA tensors launch the kernel (and
    raise if it cannot), never the twin.
    """
    check_operands(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, state0)
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    return wkv_cuda(r, k, v, w, u, None if state0 is None else state0.float())
