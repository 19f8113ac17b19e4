"""Plain oracle for the tall-skinny GEMM kernel."""
from __future__ import annotations

import torch


def tsgemm_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` in float32 (batched over leading dims)."""
    return A.float() @ B.float()
