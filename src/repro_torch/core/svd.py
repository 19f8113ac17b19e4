"""Truncated SVD client signatures (PACFL step 1).

Port of ``repro.core.svd``.  Each client owns a data matrix
``D_k in R^{N x M}`` whose *columns* are samples and uploads the ``p`` most
significant left singular vectors.

* :func:`truncated_svd` — exact, via ``torch.linalg.svd``.  The oracle.
* :func:`randomized_truncated_svd` — Halko-Martinsson-Tropp randomized range
  finder with power iterations; with ``use_tsgemm`` its five sketch
  products run through the tsgemm kernel (:mod:`repro_torch.kernels.tsgemm`).

Both take a leading batch dimension where the reference ``vmap``s:
``D`` may be ``(N, M)`` or ``(Bt, N, M)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _orthonormalize(Y: torch.Tensor) -> torch.Tensor:
    """QR-based orthonormalization of the columns of Y (batched)."""
    Q, _ = torch.linalg.qr(Y)
    return Q


def truncated_svd(D: torch.Tensor, p: int) -> torch.Tensor:
    """Exact p-truncated left singular basis of ``D`` (..., N, M) -> (..., N, p)."""
    U, _, _ = torch.linalg.svd(D.float(), full_matrices=False)
    return U[..., :p]


def sketch_width(n: int, m: int, p: int, oversample: int = 8) -> int:
    """Columns of the random sketch: ``min(p + oversample, n, m)``."""
    return min(p + oversample, min(n, m))


def randomized_truncated_svd(
    D: torch.Tensor,
    p: int,
    *,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
    oversample: int = 8,
    n_iter: int = 2,
    use_tsgemm: bool = False,
) -> torch.Tensor:
    """Randomized p-truncated left singular basis (Halko et al. 2011).

    ``Y = D @ Omega`` -> power iterations -> QR -> small exact SVD of
    ``Q^T D``.  ``omega`` (``(..., M, ell)``) overrides the Gaussian sketch
    drawn from ``generator``; tests use it to feed the reference and the
    port the same sketch.  With ``use_tsgemm`` all five sketch products go
    through the tsgemm kernel wrapper, with the transposed operands passed
    as strided views.
    """
    D = D.float()
    n, m = int(D.shape[-2]), int(D.shape[-1])
    ell = sketch_width(n, m, p, oversample)
    if omega is None:
        omega = torch.randn(
            (*D.shape[:-2], m, ell), generator=generator,
            dtype=torch.float32, device=D.device,
        )
    omega = omega.to(device=D.device, dtype=torch.float32)
    if tuple(omega.shape[-2:]) != (m, ell):
        raise ValueError(f"omega must be (..., {m}, {ell}), got {tuple(omega.shape)}")

    if use_tsgemm:
        from repro_torch.kernels.tsgemm import ops as tsops

        matmul = tsops.tsgemm
    else:
        matmul = torch.matmul

    Dt = D.transpose(-1, -2)
    Y = matmul(D, omega)                      # (n, ell)
    Q = _orthonormalize(Y)
    for _ in range(n_iter):                   # power iterations sharpen spectrum
        Z = matmul(Dt, Q)                     # (m, ell)
        Z = _orthonormalize(Z)
        Y = matmul(D, Z)                      # (n, ell)
        Q = _orthonormalize(Y)
    B = matmul(Q.transpose(-1, -2), D)        # (ell, m) small
    Ub, _, _ = torch.linalg.svd(B, full_matrices=False)
    return Q @ Ub[..., :p]                    # (n, p)


def client_signature(
    D: torch.Tensor,
    p: int,
    *,
    method: str = "exact",
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Compute the PACFL signature ``U_p`` for one client (or a batch).

    ``method``: "exact" | "randomized" | "randomized_tsgemm".
    """
    if method == "exact":
        return truncated_svd(D, p)
    if method == "randomized":
        return randomized_truncated_svd(D, p, generator=generator)
    if method == "randomized_tsgemm":
        return randomized_truncated_svd(D, p, generator=generator, use_tsgemm=True)
    raise ValueError(f"unknown SVD method: {method!r}")


def bucket_samples(m: int, *, min_bucket: int = 16) -> int:
    """Round a client sample count up to its shape bucket (next power of two).

    Zero columns do not change the left singular basis, so ragged clients
    padded to a common bucket width batch together.
    """
    if m <= 0:
        raise ValueError(f"sample count must be positive, got {m}")
    b = min_bucket
    while b < m:
        b *= 2
    return b


def batched_client_signatures(
    D_stack: torch.Tensor,
    p: int,
    method: str,
    *,
    generators: Optional[list[torch.Generator]] = None,
) -> torch.Tensor:
    """:func:`client_signature` over a same-shape client batch.

    ``D_stack`` is (B, N, M_bucket), ragged clients padded with zero columns.
    The randomized methods draw client ``b``'s sketch from
    ``generators[b]``, so each client's signature is independent of which
    batch it lands in.
    """
    if method == "exact":
        return truncated_svd(D_stack, p)
    if method not in ("randomized", "randomized_tsgemm"):
        raise ValueError(f"unknown SVD method: {method!r}")
    Bt, n, m = (int(s) for s in D_stack.shape)
    if generators is None or len(generators) != Bt:
        raise ValueError("randomized signatures need one generator per client")
    ell = sketch_width(n, m, p)
    omega = torch.stack([
        torch.randn((m, ell), generator=g, dtype=torch.float32, device=D_stack.device)
        for g in generators
    ])
    return randomized_truncated_svd(
        D_stack, p, omega=omega, use_tsgemm=method == "randomized_tsgemm"
    )


def signature_upload_bytes(U: torch.Tensor) -> int:
    """Bytes a client uploads for its signature (communication accounting)."""
    return U.numel() * U.element_size()
