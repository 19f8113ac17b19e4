"""Public wrapper for the proximity kernel's square matrix (with hygiene)."""
from __future__ import annotations

import torch

from repro_torch.core.angles import _hygiene
from repro_torch.kernels.proximity.proximity import proximity_cross


def proximity(U: torch.Tensor, *, measure: str = "eq3") -> torch.Tensor:
    """(K, n, p) signatures -> (K, K) proximity matrix (degrees).

    The cross kernel on ``(U, U)``, then exact symmetry and a zero
    diagonal.  CUDA tensors launch the kernel; CPU tensors take its twin.
    """
    return _hygiene(proximity_cross(U, U, measure))
