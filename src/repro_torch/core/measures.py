"""Shared measure core: Eq. 2 / Eq. 3 reductions over pairwise Gram blocks.

Port of ``repro.core.measures``.  Every proximity path of the port — the
dense and blocked torch backends in :mod:`repro_torch.core.angles` and the
plain twin of the CUDA proximity kernel — reduces its ``(..., p, p)`` Gram
blocks through :func:`measure_from_gram` (or its eq3 diagonal shortcut in
:func:`measure_pair`), so the paths cannot drift apart numerically.  The
CUDA kernel (``repro_torch/csrc/proximity.cu``) repeats the same reduction
in-thread, rotation for rotation.

Eq. 3 is a diagonal gather.  Eq. 2 needs the largest singular value of each
``p x p`` block ``G = U_i^T U_j`` and dispatches across three solvers:

* ``"jacobi"`` — fixed-sweep cyclic Jacobi on ``B = G^T G`` in a packed
  symmetric representation (the ``p (p + 1) / 2`` unique entries as
  separate batch vectors, static plane indices).
* ``"eigh"`` — batched ``torch.linalg.eigvalsh`` on ``G^T G``.
* ``"svd"`` — batched ``torch.linalg.svdvals``; the parity oracle.
"""
from __future__ import annotations

import functools

import torch

EQ2_SOLVERS = ("jacobi", "eigh", "svd")

# Cyclic Jacobi sweeps: four sit on the f32 roundoff floor for p <= 5;
# larger p gets two more of margin (same counts as the reference).
_JACOBI_SWEEPS_SMALL_P = 4
_JACOBI_SWEEPS_LARGE_P = 6


def jacobi_sweeps(p: int) -> int:
    """Default sweep count for a ``p x p`` eigensolve."""
    return _JACOBI_SWEEPS_SMALL_P if p <= 5 else _JACOBI_SWEEPS_LARGE_P


def _key(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a <= b else (b, a)


# Keeps the rotation-tangent denominator away from the 0/0 of an
# already-diagonal plane (d = e = 0 gives t = 0/TINY = 0, a no-op rotation).
_TINY = 1e-30


def _jacobi_rotate(b: dict, p: int, i: int, j: int) -> None:
    """One batched plane rotation zeroing ``B[i, j]``, in packed form.

    The tangent is the small root of ``t^2 + 2 tau t - 1 = 0`` in the
    cancellation-free form ``t = sign(d) * e / (|d| + sqrt(d^2 + e^2))``
    (``d = b_jj - b_ii``, ``e = 2 b_ij``, ``sign(0) = +1``), guarded by
    ``_TINY`` so the already-diagonal plane is a no-op.
    """
    bii, bjj, bij = b[(i, i)], b[(j, j)], b[(i, j)]
    d = bjj - bii
    e = bij + bij
    den = torch.abs(d) + torch.sqrt(d * d + e * e) + _TINY
    sgn = torch.where(d >= 0.0, 1.0, -1.0).to(d.dtype)
    t = sgn * e / den
    c = torch.rsqrt(1.0 + t * t)
    s = t * c
    tb = t * bij
    b[(i, i)] = bii - tb
    b[(j, j)] = bjj + tb
    b[(i, j)] = torch.zeros_like(bij)
    for k in range(p):
        if k == i or k == j:
            continue
        bik, bjk = b[_key(i, k)], b[_key(j, k)]
        b[_key(i, k)] = c * bik - s * bjk
        b[_key(j, k)] = s * bik + c * bjk


def jacobi_max_eig_packed(b: dict, p: int, sweeps: int | None = None) -> torch.Tensor:
    """Largest eigenvalue of packed symmetric PSD batches.

    ``b`` maps ``(i, j)`` with ``i <= j < p`` to the batch tensor of that
    entry; it is consumed (mutated) by the sweeps.
    """
    if p == 1:
        return b[(0, 0)]
    if sweeps is None:
        sweeps = jacobi_sweeps(p)
    for _ in range(sweeps):
        for i in range(p - 1):
            for j in range(i + 1, p):
                _jacobi_rotate(b, p, i, j)
    return functools.reduce(torch.maximum, [b[(i, i)] for i in range(p)])


def jacobi_max_eig(B: torch.Tensor, p: int, sweeps: int | None = None) -> torch.Tensor:
    """Largest eigenvalue of symmetric PSD ``B`` with shape ``(..., p, p)``."""
    b = {(i, j): B[..., i, j] for i in range(p) for j in range(i, p)}
    return jacobi_max_eig_packed(b, p, sweeps)


def _eq2_jacobi(G: torch.Tensor) -> torch.Tensor:
    """Largest singular value of ``(..., p, q)`` blocks via packed Jacobi on
    the ``q x q`` matrix ``G^T G``, formed entry-wise."""
    q = G.shape[-1]
    cols = [G[..., :, c] for c in range(q)]
    b = {}
    for c in range(q):
        for r in range(c, q):
            b[(c, r)] = torch.sum(cols[c] * cols[r], dim=-1)
    lam = jacobi_max_eig_packed(b, q)
    return torch.sqrt(torch.clamp(lam, min=0.0))


def eq3_from_diag(d: torch.Tensor) -> torch.Tensor:
    """Eq. 3 reduction from ``(..., p)`` Gram *diagonal* entries, degrees."""
    d = torch.clamp(torch.abs(d), 0.0, 1.0)
    return torch.sum(torch.rad2deg(torch.arccos(d)), dim=-1)


def measure_pair(
    Ui: torch.Tensor, Uj: torch.Tensor, measure: str, *, eq2_solver: str = "jacobi"
) -> torch.Tensor:
    """Pairwise measure block straight from signature stacks:
    ``(a, n, p) x (b, n, q) -> (a, b)`` degrees.

    eq3 contracts only the ``p`` Gram diagonal entries
    (``einsum("anr,bnr->abr")``, needs ``p == q``); eq2 forms the full
    ``(a, b, p, q)`` Gram block and reduces it through
    :func:`measure_from_gram`.

    Parity guarantee: deterministic for fixed inputs on one device, and
    within 1e-3 degrees of ``repro.core.measures.measure_pair`` on
    orthonormal float32 inputs (the float sums run in another order).
    """
    Ui = Ui.float()
    Uj = Uj.float()
    if measure == "eq3":
        return eq3_from_diag(torch.einsum("anr,bnr->abr", Ui, Uj))
    G = torch.einsum("anp,bnq->abpq", Ui, Uj)
    return measure_from_gram(G, measure, eq2_solver=eq2_solver)


def measure_from_gram(
    G: torch.Tensor, measure: str, *, eq2_solver: str = "jacobi"
) -> torch.Tensor:
    """(..., p, q) pairwise Gram blocks -> (...,) angles in degrees.

    ``measure`` is ``"eq2"`` (smallest principal angle) or ``"eq3"`` (trace
    of arccos over identically ordered pairs).  ``eq2_solver`` picks the
    largest-singular-value solver; ``"jacobi"`` is the one the CUDA kernel
    runs in-thread.

    Parity guarantee: deterministic for fixed ``(G, measure, eq2_solver)``
    on one device; every port path reduces through this function or its
    eq3 diagonal shortcut.
    """
    if measure == "eq3":
        return eq3_from_diag(torch.diagonal(G, dim1=-2, dim2=-1))
    if measure != "eq2":
        raise ValueError(f"unknown measure: {measure!r}")
    if eq2_solver == "jacobi":
        smax = _eq2_jacobi(G)
    elif eq2_solver == "eigh":
        B = G.transpose(-1, -2) @ G
        smax = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(B)[..., -1], min=0.0))
    elif eq2_solver == "svd":
        smax = torch.linalg.svdvals(G)[..., 0]
    else:
        raise ValueError(
            f"unknown eq2 solver: {eq2_solver!r} (want one of {EQ2_SOLVERS})"
        )
    return torch.rad2deg(torch.arccos(torch.clamp(smax, 0.0, 1.0)))


def measure_tile(
    Ui: torch.Tensor, Uj: torch.Tensor, measure: str, *, eq2_solver: str = "jacobi"
) -> torch.Tensor:
    """Pairwise tile: (bi, n, p) x (bj, n, p) signatures -> (bi, bj) degrees.

    The TPU kernel's tile: one flat matmul ``(bi*p, n) @ (n, bj*p)`` forms
    every pairwise Gram block at once, and both measures reduce static
    slices of the flat ``(bi, p, bj, p)`` layout directly.
    """
    bi, n, p = Ui.shape
    bj = Uj.shape[0]
    uif = Ui.float().transpose(1, 2).reshape(bi * p, n)
    ujf = Uj.float().transpose(1, 2).reshape(bj * p, n)
    M4 = (uif @ ujf.T).reshape(bi, p, bj, p)  # [a, r, b, q] = G_ab[r, q]
    if measure == "eq3":
        total = None
        for r in range(p):
            drr = torch.clamp(torch.abs(M4[:, r, :, r]), 0.0, 1.0)
            ang = torch.rad2deg(torch.arccos(drr))
            total = ang if total is None else total + ang
        return total
    if measure != "eq2":
        raise ValueError(f"unknown measure: {measure!r}")
    if eq2_solver != "jacobi":
        return measure_from_gram(
            M4.permute(0, 2, 1, 3), measure, eq2_solver=eq2_solver
        )
    S = [[M4[:, k, :, q] for q in range(p)] for k in range(p)]
    b = {}
    for q in range(p):
        for r in range(q, p):
            acc = S[0][q] * S[0][r]
            for k in range(1, p):
                acc = acc + S[k][q] * S[k][r]
            b[(q, r)] = acc
    lam = jacobi_max_eig_packed(b, p)
    smax = torch.sqrt(torch.clamp(lam, min=0.0))
    return torch.rad2deg(torch.arccos(torch.clamp(smax, 0.0, 1.0)))
