"""Public wrapper for the tall-skinny GEMM kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.tsgemm.tsgemm import check_operands, tsgemm_cuda, tsgemm_plain


def tsgemm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Tall-skinny GEMM (randomized-SVD sketch hot spot): ``(m, k) @ (k, p)``
    or ``(Bt, m, k) @ (Bt, k, p)`` -> float32.

    CPU tensors take :func:`tsgemm_plain`; CUDA tensors launch the kernel
    (and raise if it cannot), never the twin.
    """
    check_operands(A, B)
    if A.device.type == "cpu":
        return tsgemm_plain(A, B)
    return tsgemm_cuda(A, B)
