"""Reference distribution-distance measures (supplementary Table 6).

Port of ``repro.core.similarity``.  The paper argues principal-angle
proximity is *consistent* with classical distribution distances that FL
privacy forbids (they need raw data or moments): Bhattacharyya distance,
KL divergence (Gaussian closed forms) and kernel MMD.  They take two
(samples, dims) tensors and compute in float32 on the tensors' device, as
the reference does, with TF32 off (:func:`repro_torch._device.float32_math`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import float32_math


def _gaussian_stats(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and (regularized) covariance of rows of X (samples x dims)."""
    mu = X.mean(dim=0)
    Xc = X - mu
    cov = (Xc.T @ Xc) / (X.shape[0] - 1)
    cov = cov + 1e-6 * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return mu, cov


def bhattacharyya_gaussian(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """BD between Gaussian fits of two sample sets (Kailath 1967)."""
    with float32_math():
        mu1, S1 = _gaussian_stats(X.float())
        mu2, S2 = _gaussian_stats(Y.float())
        S = 0.5 * (S1 + S2)
        dmu = mu1 - mu2
        term1 = 0.125 * dmu @ torch.linalg.solve(S, dmu)
        ld = torch.linalg.slogdet(S).logabsdet
        ld1 = torch.linalg.slogdet(S1).logabsdet
        ld2 = torch.linalg.slogdet(S2).logabsdet
        return term1 + 0.5 * (ld - 0.5 * (ld1 + ld2))


def kl_gaussian(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """KL(N_X || N_Y) between Gaussian fits (Hershey & Olsen 2007 setting)."""
    with float32_math():
        mu1, S1 = _gaussian_stats(X.float())
        mu2, S2 = _gaussian_stats(Y.float())
        d = mu1.shape[0]
        S2inv_S1 = torch.linalg.solve(S2, S1)
        dmu = mu2 - mu1
        ld1 = torch.linalg.slogdet(S1).logabsdet
        ld2 = torch.linalg.slogdet(S2).logabsdet
        return 0.5 * (
            torch.trace(S2inv_S1) + dmu @ torch.linalg.solve(S2, dmu) - d + ld2 - ld1
        )


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of all entries; an even count averages the two middle values
    (``jnp.median``; ``torch.median`` would return the lower one)."""
    s = v.reshape(-1).sort().values
    k = s.numel()
    return 0.5 * (s[(k - 1) // 2] + s[k // 2])


def _sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, summed over the difference of each pair
    (as the reference does, not through the ``|a|^2 + |b|^2 - 2ab`` form)."""
    return ((A[:, None] - B[None]) ** 2).sum(dim=-1)


def mmd_rbf(
    X: torch.Tensor, Y: torch.Tensor, gamma: Optional[float] = None
) -> torch.Tensor:
    """Unbiased kernel two-sample MMD^2 with an RBF kernel (Gretton 2012),
    returned as its square root; ``gamma`` defaults to 1 / the median
    pairwise squared distance of the pooled samples."""
    with float32_math():
        X, Y = X.float(), Y.float()
        if gamma is None:
            Z = torch.cat([X, Y], dim=0)
            gamma = 1.0 / (_median(_sq_dists(Z, Z)) + 1e-12)

        def k(A, B):
            return torch.exp(-gamma * _sq_dists(A, B))

        m, n = X.shape[0], Y.shape[0]
        Kxx, Kyy, Kxy = k(X, X), k(Y, Y), k(X, Y)
        sxx = (Kxx.sum() - torch.trace(Kxx)) / (m * (m - 1))
        syy = (Kyy.sum() - torch.trace(Kyy)) / (n * (n - 1))
        sxy = Kxy.mean()
        return torch.sqrt(torch.clamp(sxx + syy - 2 * sxy, min=0.0))
