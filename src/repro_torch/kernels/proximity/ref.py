"""Plain oracles for the proximity kernel (Eq. 2 / Eq. 3, degrees).

Ports ``repro.kernels.proximity.ref``: :func:`proximity_ref` reduces through
the shared measure core with the LAPACK ``svd`` eq2 solver, so the kernel's
in-thread Jacobi is always tested against an independent factorization.
:func:`proximity_eq2_schedule_ref` and :func:`proximity_eq3_schedule_ref`
follow the CUDA kernel's schedules step by step in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.angles import _hygiene
from repro_torch.core.measures import measure_from_gram
from repro_torch.kernels._build import H100_SMS
from repro_torch.kernels.proximity.proximity import (
    EQ2_TILE,
    EQ2_WORKSPACE_BYTES,
    MAX_TC_RANK,
    eq2_plan,
    triangle_tile,
)


def proximity_ref(U: torch.Tensor, measure: str = "eq3") -> torch.Tensor:
    """U: (K, n, p) orthonormal signatures -> (K, K) angle matrix, degrees."""
    U = U.float()
    G = torch.einsum("inp,jnq->ijpq", U, U)
    return _hygiene(measure_from_gram(G, measure, eq2_solver="svd"))


def proximity_eq3_schedule_ref(Ua: torch.Tensor, Ub: torch.Tensor) -> torch.Tensor:
    """The eq3 kernel's schedule: (Ka, n, p) x (Kb, n, p) -> (Ka, Kb) degrees.

    The columns in chunks of ``MAX_TC_RANK`` (one launch each), each
    chunk's Gram diagonal as FP64 sums of the float32 inputs' exact
    products rounded to float32, and one float32 running sum of the clipped
    arccos angles over r = 0 ... p - 1 that each chunk after the first
    continues from the result so far.  No hygiene.
    """
    A, B = Ua.float().double(), Ub.float().double()
    total = None
    for r0 in range(0, A.shape[2], MAX_TC_RANK):
        cols = slice(r0, min(A.shape[2], r0 + MAX_TC_RANK))
        diag = torch.einsum("anr,bnr->abr", A[:, :, cols], B[:, :, cols]).float()
        angles = torch.rad2deg(torch.arccos(torch.clamp(diag.abs(), 0.0, 1.0)))
        for r in range(angles.shape[2]):
            total = angles[:, :, r] if total is None else total + angles[:, :, r]
    return total


def proximity_eq2_schedule_ref(Ua: torch.Tensor, Ub: torch.Tensor, *,
                               sm_count: int = H100_SMS,
                               workspace_bytes: int = EQ2_WORKSPACE_BYTES) -> torch.Tensor:
    """The eq2 kernel's schedule: (Ka, n, p) x (Kb, n, q) -> (Ka, Kb) degrees.

    Follows :func:`~repro_torch.kernels.proximity.proximity.eq2_plan`
    through the kernel's workspace layout: batch by batch, each tile's
    pieces (chunk_p x chunk_q Gram entries) over each split of n, as FP64
    sums of the float32 inputs' exact products, written to
    ``ws[split][tile - tile0][r * q + s][32 * (a - a0) + (b - b0)]``; a
    write over an entry already written, or an entry of a pair left
    unwritten, makes the result NaN.  Then the splits added in split order
    and rounded to float32, and the packed Jacobi of ``G^T G`` for
    ``C[a, b]``.  When ``Ua is Ub`` (the kernel's symmetric grid) the tiles
    are the upper triangle's and each pair a < b also runs the Jacobi of
    ``G G^T`` for ``C[b, a]``, as the kernel does, instead of computing the
    Gram of (b, a) again.  No hygiene: that is the caller's.
    """
    sym = Ua is Ub
    Ka, n, p = Ua.shape
    Kb, _, q = Ub.shape
    plan = eq2_plan(Ka, Kb, n, p, q, sym, sm_count, workspace_bytes)
    A, B = Ua.float().double(), Ub.float().double()
    T, ntb = EQ2_TILE, math.ceil(Kb / EQ2_TILE)
    C = torch.full((Ka, Kb), float("nan"))
    for batch in plan.batches():
        ws = torch.full((plan.splits, len(batch), p, q, T, T), float("nan"), dtype=torch.float64)
        tiles = [triangle_tile(x) if sym else divmod(x, ntb) for x in batch]
        for slot, (bi, bj) in enumerate(tiles):
            a = slice(bi * T, min(Ka, (bi + 1) * T))
            b = slice(bj * T, min(Kb, (bj + 1) * T))
            for pc in plan.pieces():
                for i in range(pc.row_chunks):
                    for j in range(pc.col_chunks):
                        r = slice(pc.r_base + i * pc.rows, pc.r_base + (i + 1) * pc.rows)
                        c = slice(pc.s_base + j * pc.cols, pc.s_base + (j + 1) * pc.cols)
                        for s in range(plan.splits):
                            t = slice(s * plan.split_rows, min(n, (s + 1) * plan.split_rows))
                            part = torch.einsum("anp,bnq->pqab", A[a, t, r], B[b, t, c])
                            dst = ws[s, slot, r, c, :part.shape[2], :part.shape[3]]
                            dst.copy_(torch.where(dst.isnan(), part, float("nan")))
        G = ws[0]
        for s in range(1, plan.splits):
            G = G + ws[s]
        G = G.float()
        for slot, (bi, bj) in enumerate(tiles):
            a = slice(bi * T, min(Ka, (bi + 1) * T))
            b = slice(bj * T, min(Kb, (bj + 1) * T))
            g = G[slot, :, :, :a.stop - a.start, :b.stop - b.start].permute(2, 3, 0, 1)
            tile = measure_from_gram(g, "eq2", eq2_solver="jacobi")
            if sym:
                # [a, b] = the Jacobi of G_ab G_ab^T, the value of C[b, a]
                mirror = measure_from_gram(g.transpose(-1, -2), "eq2", eq2_solver="jacobi")
                ia = torch.arange(a.start, a.stop)[:, None]
                ib = torch.arange(b.start, b.stop)[None, :]
                upper = ia <= ib
                C[a, b] = torch.where(upper, tile, C[a, b])
                lower_t = (ia < ib).T
                C[b, a] = torch.where(lower_t, mirror.T, C[b, a])
            else:
                C[a, b] = tile
    return C
