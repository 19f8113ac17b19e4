"""Plain oracles for the proximity kernel (Eq. 2 / Eq. 3, degrees).

Ports ``repro.kernels.proximity.ref``: :func:`proximity_ref` reduces through
the shared measure core with the LAPACK ``svd`` eq2 solver, so the kernel's
in-thread Jacobi is always tested against an independent factorization.
:func:`proximity_eq2_schedule_ref` follows the CUDA eq2 kernel's schedule
step by step in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.core.angles import _hygiene
from repro_torch.core.measures import measure_from_gram
from repro_torch.kernels.proximity.proximity import eq2_plan


def proximity_ref(U: torch.Tensor, measure: str = "eq3") -> torch.Tensor:
    """U: (K, n, p) orthonormal signatures -> (K, K) angle matrix, degrees."""
    U = U.float()
    G = torch.einsum("inp,jnq->ijpq", U, U)
    return _hygiene(measure_from_gram(G, measure, eq2_solver="svd"))


def proximity_eq2_schedule_ref(Ua: torch.Tensor, Ub: torch.Tensor) -> torch.Tensor:
    """The eq2 kernel's schedule: (Ka, n, p) x (Kb, n, q) -> (Ka, Kb) degrees.

    For :func:`~repro_torch.kernels.proximity.proximity.eq2_plan`'s splits
    of n, each split's FP64 partial Grams (products of the float32 inputs,
    exact in FP64), added in split order and rounded to float32; then the
    packed Jacobi of ``G^T G`` for ``C[a, b]``.  When ``Ua is Ub`` (the
    kernel's symmetric grid) each unordered pair a < b also runs the Jacobi
    of ``G G^T`` for ``C[b, a]``, as the kernel does, instead of computing
    the Gram of (b, a) again.  No hygiene: that is the caller's.
    """
    sym = Ua is Ub
    Ka, n, p = Ua.shape
    Kb, _, q = Ub.shape
    plan = eq2_plan(Ka, Kb, n, p, q, sym)
    A, B = Ua.float().double(), Ub.float().double()
    G = None
    for s in range(plan.splits):
        rows = slice(s * plan.split_rows, min(n, (s + 1) * plan.split_rows))
        part = torch.einsum("anp,bnq->abpq", A[:, rows], B[:, rows])
        G = part if G is None else G + part
    G = G.float()
    C = measure_from_gram(G, "eq2", eq2_solver="jacobi")
    if sym:
        lower = torch.tril(torch.ones((Ka, Ka), dtype=torch.bool, device=C.device), -1)
        # [a, b] = the Jacobi of G_ab G_ab^T, the value of C[b, a]
        mirror = measure_from_gram(G.transpose(-1, -2), "eq2", eq2_solver="jacobi")
        C = torch.where(lower, mirror.T, C)
    return C
