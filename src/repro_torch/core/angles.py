"""Principal angles between client data subspaces and the proximity matrix.

Port of ``repro.core.angles`` (Eq. 1-3 of the paper, angles in degrees).

Backends
--------
:func:`proximity_matrix` and :func:`cross_proximity` dispatch across:

* ``"torch"`` — the einsum reference.  Materializes the (K, K, p, p) Gram
  tensor for eq2; its eq2 defaults to the ``svd`` solver so it stays the
  independent oracle the fast paths are tested against.
* ``"torch_blocked"`` — (bk, bk) client tiles (upper-triangular only for
  the square matrix), peak intermediate memory O(bk^2 p^2).
* ``"kernel"`` — the hand-written CUDA proximity kernel
  (:mod:`repro_torch.kernels.proximity`), square and cross alike.  On CPU
  tensors it runs the kernel's plain twin, as the reference's ``pallas``
  backend runs in interpret mode off the TPU.

``"auto"`` resolves by the tensor's device: the kernel on CUDA; on the CPU
the dense path for small K and the blocked path from ``_AUTO_BLOCKED_MIN_K``
clients.  The reference's ``jnp_sharded`` backend has no counterpart on one
card.
"""
from __future__ import annotations

import torch

from repro_torch.core.measures import EQ2_SOLVERS, measure_pair

PROXIMITY_BACKENDS = ("auto", "torch", "torch_blocked", "kernel")

# "auto" on the CPU switches from the dense einsum to the blocked path here.
_AUTO_BLOCKED_MIN_K = 512

_DEFAULT_BLOCK = {"eq3": 64, "eq2": 96}

# The dense reference keeps the svd solver so it stays an independent
# oracle; the blocked path and the kernel run the Jacobi eigensolve.
_DEFAULT_EQ2_SOLVER = {"torch": "svd", "torch_blocked": "jacobi", "kernel": "jacobi"}


def principal_angles(U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """All principal angles (radians, ascending) between span(U), span(W)."""
    G = U.float().T @ W.float()
    s = torch.linalg.svdvals(G)
    s = torch.clamp(s, -1.0, 1.0)
    return torch.sort(torch.arccos(s)).values


def smallest_principal_angle_deg(U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Eq. 2 entry: smallest principal angle, in degrees."""
    return torch.rad2deg(principal_angles(U, W)[0])


def trace_angle_deg(U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Eq. 3 entry: sum of arccos of the diagonal of U^T W, in degrees."""
    G = U.float().T @ W.float()
    d = torch.clamp(torch.diagonal(G), -1.0, 1.0)
    return torch.rad2deg(torch.sum(torch.arccos(torch.abs(d))))


def _hygiene(A: torch.Tensor) -> torch.Tensor:
    """Exact symmetry and exact zeros on the diagonal."""
    A = 0.5 * (A + A.T)
    return A * (1.0 - torch.eye(A.shape[0], dtype=A.dtype, device=A.device))


def _proximity_blocked(
    U: torch.Tensor, measure: str, bk: int, eq2_solver: str
) -> torch.Tensor:
    """Tiled square path: upper-triangular (bk, bk) tiles, each mirrored."""
    U = U.float()
    K = U.shape[0]
    A = torch.zeros((K, K), dtype=torch.float32, device=U.device)
    for i in range(0, K, bk):
        for j in range(i, K, bk):
            tile = measure_pair(
                U[i : i + bk], U[j : j + bk], measure, eq2_solver=eq2_solver
            )
            A[i : i + bk, j : j + bk] = tile
            A[j : j + bk, i : i + bk] = tile.T
    return _hygiene(A)


def _cross_blocked(
    U_a: torch.Tensor, U_b: torch.Tensor, measure: str, bk: int, eq2_solver: str
) -> torch.Tensor:
    """Both operands tiled: peak intermediate is one (bk, bk, p, q) block."""
    U_a, U_b = U_a.float(), U_b.float()
    Ka, Kb = U_a.shape[0], U_b.shape[0]
    C = torch.empty((Ka, Kb), dtype=torch.float32, device=U_a.device)
    for i in range(0, Ka, bk):
        for j in range(0, Kb, bk):
            C[i : i + bk, j : j + bk] = measure_pair(
                U_a[i : i + bk], U_b[j : j + bk], measure, eq2_solver=eq2_solver
            )
    return C


def _resolve_backend(backend: str, K: int, device: torch.device) -> str:
    if backend not in PROXIMITY_BACKENDS:
        raise ValueError(
            f"unknown proximity backend: {backend!r} (want one of {PROXIMITY_BACKENDS})"
        )
    if backend != "auto":
        return backend
    if device.type == "cuda":
        return "kernel"
    return "torch" if K < _AUTO_BLOCKED_MIN_K else "torch_blocked"


def _resolve_eq2_solver(eq2_solver: str, resolved_backend: str) -> str:
    if eq2_solver == "auto":
        return _DEFAULT_EQ2_SOLVER[resolved_backend]
    if eq2_solver not in EQ2_SOLVERS:
        raise ValueError(
            f"unknown eq2 solver: {eq2_solver!r} (want 'auto' or one of {EQ2_SOLVERS})"
        )
    if resolved_backend == "kernel" and eq2_solver != "jacobi":
        raise ValueError("the proximity kernel runs only the 'jacobi' eq2 solver")
    return eq2_solver


def proximity_matrix(
    U_stack: torch.Tensor,
    measure: str = "eq3",
    *,
    backend: str = "auto",
    block_size: int | None = None,
    eq2_solver: str = "auto",
) -> torch.Tensor:
    """Proximity matrix A (K x K, **degrees**) from stacked signatures.

    Parameters
    ----------
    U_stack: (K, n, p) stacked orthonormal client signatures (a tensor; the
        result lives on its device).
    measure: "eq3" (default) or "eq2".
    backend: "auto" | "torch" | "torch_blocked" | "kernel" — see the module
        docstring.
    block_size: tile edge of the blocked path (default 64 eq3 / 96 eq2);
        the kernel's tile is fixed in its source.
    eq2_solver: "auto" | "jacobi" | "eigh" | "svd".

    Parity guarantee: every backend agrees with the reference's
    ``proximity_matrix`` to <= 1e-3 degrees on orthonormal float32 inputs,
    and the result is exactly symmetric with a zero diagonal.
    """
    if measure not in ("eq2", "eq3"):
        raise ValueError(f"unknown measure: {measure!r}")
    resolved = _resolve_backend(backend, int(U_stack.shape[0]), U_stack.device)
    solver = _resolve_eq2_solver(eq2_solver, resolved)
    if resolved == "torch":
        return _hygiene(measure_pair(U_stack, U_stack, measure, eq2_solver=solver))
    if resolved == "torch_blocked":
        bk = block_size if block_size is not None else _DEFAULT_BLOCK[measure]
        return _proximity_blocked(U_stack, measure, bk, solver)
    from repro_torch.kernels.proximity import ops as pops

    return pops.proximity(U_stack, measure=measure)


def cross_proximity(
    U_a: torch.Tensor,
    U_b: torch.Tensor,
    measure: str = "eq3",
    *,
    backend: str = "auto",
    block_size: int | None = None,
    eq2_solver: str = "auto",
) -> torch.Tensor:
    """Rectangular angle block: (Ka, n, p) x (Kb, n, p) -> (Ka, Kb) degrees.

    The PME workhorse (Algorithm 2).  The ``kernel`` backend runs the cross
    kernel itself (the reference's square-only Pallas kernel falls back to
    its blocked path here).

    Parity guarantee: within 1e-3 degrees of the matching off-diagonal
    block of :func:`proximity_matrix` over the concatenated stack.
    """
    if measure not in ("eq2", "eq3"):
        raise ValueError(f"unknown measure: {measure!r}")
    resolved = _resolve_backend(
        backend, max(int(U_a.shape[0]), int(U_b.shape[0])), U_a.device
    )
    solver = _resolve_eq2_solver(eq2_solver, resolved)
    if resolved == "torch":
        return measure_pair(U_a, U_b, measure, eq2_solver=solver)
    if resolved == "torch_blocked":
        bk = block_size if block_size is not None else _DEFAULT_BLOCK[measure]
        return _cross_blocked(U_a, U_b, measure, bk, solver)
    from repro_torch.kernels.proximity import proximity_cross

    return proximity_cross(U_a, U_b, measure)
