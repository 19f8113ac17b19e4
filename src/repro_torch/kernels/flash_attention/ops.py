"""Public wrapper for the flash-attention kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_operands,
    flash_attention_cuda,
    flash_attention_plain,
)


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

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (and raise if it cannot), never the twin.
    """
    check_operands(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
