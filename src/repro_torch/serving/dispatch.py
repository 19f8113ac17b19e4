"""Batched assignment dispatch — the serving hot path.

Port of ``repro.serving.dispatch``.  :func:`serve_assign` scores a
(B, n, p) query stack against the (C, n, q) representative stack and
returns each query's nearest representative index and distance.  On CUDA
the scores come from the cross proximity kernel
(:mod:`repro_torch.kernels.proximity`); on the CPU from its plain twin.
Both compute the function the reference's dispatch computes through
``measure_pair``.  The non-Jacobi eq2 solvers
(``eigh``/``svd``), which the kernel does not run, go to ``measure_pair``
on either device.

Both the query batch and the representative count are zero-padded to the
next power of two, as in the reference (there: one compile per bucket).
A zero-padded signature reads 90 degrees per principal angle, padded
representative columns are masked to ``+inf`` before the argmin, and
padded query rows are sliced off, so padding never wins an assignment.
No host sync happens here; the caller owns the single readback.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.measures import EQ2_SOLVERS, measure_pair
from repro_torch.kernels.proximity import proximity_cross


def pow2_bucket(x: int) -> int:
    """Smallest power of two >= ``x`` (>= 1) — the pad bucket edge."""
    return 1 << max(int(x) - 1, 0).bit_length()


def _assign_scores(Uq, R, c_real: int, measure: str, eq2_solver: str):
    """(B, n, p) queries x (C_pad, n, q) reps -> (argmin idx, min distance).

    Padded representative columns (index >= ``c_real``) are masked to +inf;
    argmin ties break to the lowest index.
    """
    if measure == "eq3" or eq2_solver == "jacobi":
        D = proximity_cross(Uq, R, measure)
    else:
        D = measure_pair(Uq, R, measure, eq2_solver=eq2_solver)
    live = torch.arange(D.shape[1], device=D.device) < c_real
    D = torch.where(live[None, :], D, torch.inf)
    dmin, idx = torch.min(D, dim=1)
    return idx, dmin


def serve_assign(U_queries, reps, measure, *, eq2_solver: str = "jacobi"):
    """Score a query batch against the representative stack, device-side.

    Parameters
    ----------
    U_queries: (B, n, p) stacked query signatures.
    reps: (C, n, q) representative stack (``RepresentativeCache.rep_stack``);
        queries move to its device.  eq2 accepts ``p != q``; eq3 requires
        ``p == q``.
    measure / eq2_solver: forwarded to the measure core / the kernel.

    Returns ``(idx, dmin)`` — two (B,) tensors on the representatives'
    device: each query's nearest representative row index and its distance
    in degrees.

    Parity guarantee: deterministic for fixed inputs on one device, and
    independent of the pad buckets (each score depends only on its own
    pair); scores agree with the reference's to <= 1e-3 degrees.
    """
    R = torch.as_tensor(reps, dtype=torch.float32)
    Uq = torch.as_tensor(U_queries, dtype=torch.float32, device=R.device)
    if Uq.ndim != 3 or R.ndim != 3:
        raise ValueError(
            f"expected (B, n, p) queries and (C, n, q) reps, got "
            f"{tuple(Uq.shape)} and {tuple(R.shape)}"
        )
    if Uq.shape[1] != R.shape[1]:
        raise ValueError(
            f"query ambient dim n={Uq.shape[1]} != representative "
            f"n={R.shape[1]}"
        )
    if measure == "eq3" and Uq.shape[2] != R.shape[2]:
        raise ValueError(
            f"eq3 pairs identically ordered angles and needs equal basis "
            f"ranks: query p={Uq.shape[2]} vs representative p={R.shape[2]} "
            f"(use eq2 for rectangular pairs)"
        )
    if eq2_solver not in EQ2_SOLVERS:
        raise ValueError(
            f"unknown eq2 solver: {eq2_solver!r} (want one of {EQ2_SOLVERS})"
        )
    B, C = int(Uq.shape[0]), int(R.shape[0])
    Bp, Cp = pow2_bucket(B), pow2_bucket(C)
    if Bp > B:
        Uq = F.pad(Uq, (0, 0, 0, 0, 0, Bp - B))
    if Cp > C:
        R = F.pad(R, (0, 0, 0, 0, 0, Cp - C))
    idx, dmin = _assign_scores(Uq, R, C, measure, eq2_solver)
    return idx[:B], dmin[:B]
