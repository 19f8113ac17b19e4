"""Plain oracle for the proximity kernel (Eq. 2 / Eq. 3, degrees).

Ports ``repro.kernels.proximity.ref``: reduces through the shared measure
core with the LAPACK ``svd`` eq2 solver, so the kernel's in-thread Jacobi
is always tested against an independent factorization.
"""
from __future__ import annotations

import torch

from repro_torch.core.angles import _hygiene
from repro_torch.core.measures import measure_from_gram


def proximity_ref(U: torch.Tensor, measure: str = "eq3") -> torch.Tensor:
    """U: (K, n, p) orthonormal signatures -> (K, K) angle matrix, degrees."""
    U = U.float()
    G = torch.einsum("inp,jnq->ijpq", U, U)
    return _hygiene(measure_from_gram(G, measure, eq2_solver="svd"))
