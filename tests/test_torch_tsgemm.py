"""Port parity: the tsgemm kernel's plain twin and the randomized SVD.

The batched, strided tsgemm wrapper (plain twin on CPU tensors) is held
against the reference's Pallas tsgemm (interpret mode on the CPU) at the
reference's own test shapes and tolerances (``tests/test_kernels.py``:
rtol 1e-5 float32, 2e-2 bfloat16, atol 10x rtol).  The port's randomized
SVD, fed the same Gaussian sketch the reference draws, must span the same
subspace as the reference's (max principal angle <= 1e-2 degrees) and the
exact SVD's (< 1 degree, as ``tests/test_core_pacfl.py`` holds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svd as ref_svd
from repro.kernels.tsgemm import tsgemm as ref_tsgemm
from repro_torch.core import svd
from repro_torch.core.angles import principal_angles
from repro_torch.kernels.tsgemm import tsgemm, tsgemm_cuda, tsgemm_ref

SHAPES = [(128, 128, 8), (512, 300, 10), (1000, 768, 13), (50, 40, 3)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _subspace_data(seed, n, m, basis_rank=5, noise=0.01, spectrum_decay=0.8):
    """Data matrix (n, m) concentrated on a decaying-spectrum subspace."""
    rng = np.random.default_rng(seed)
    B = np.linalg.qr(rng.normal(size=(n, basis_rank)))[0]
    spec = spectrum_decay ** np.arange(basis_rank)
    C = rng.normal(size=(basis_rank, m)) * spec[:, None]
    return (B @ C + noise * rng.normal(size=(n, m))).astype(np.float32)


def _max_angle_deg(U, W):
    """Largest principal angle between span(U) and span(W), from its sine in
    float64: arccos of float32 singular values near 1 bottoms out at ~0.02
    degrees, too coarse for the 1e-2 degree bound."""
    U, W = np.asarray(U, np.float64), np.asarray(W, np.float64)
    resid = W - U @ (U.T @ W)
    return float(np.degrees(np.arcsin(min(1.0, np.linalg.norm(resid, 2)))))


class TestTsgemmParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("m,k,p", SHAPES)
    def test_matches_reference_kernel(self, m, k, p, dtype):
        A, B = _normal(m + k, m, k), _normal(p, k, p)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = np.asarray(ref_tsgemm(jnp.asarray(A).astype(jdt), jnp.asarray(B).astype(jdt)))
        got = tsgemm(torch.from_numpy(A).to(tdt), torch.from_numpy(B).to(tdt))
        assert got.dtype == torch.float32 and got.shape == (m, p)
        rtol = 2e-2 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 10)

    @pytest.mark.parametrize("m,k,p", SHAPES)
    def test_batched_strided_matches_per_client_reference(self, m, k, p):
        """The batch dimension replaces the reference's vmap, and transposed
        operands arrive as strided views (``D.T``), never copies."""
        A = _normal(m, 3, k, m)           # stored (Bt, k, m): A.T is (Bt, m, k)
        B = _normal(k, 3, k, p)
        At = torch.from_numpy(A).transpose(1, 2)
        assert not At.is_contiguous()
        got = tsgemm(At, torch.from_numpy(B)).numpy()
        for b in range(3):
            want = np.asarray(ref_tsgemm(jnp.asarray(A[b].T), jnp.asarray(B[b])))
            np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, tsgemm_ref(At, torch.from_numpy(B)).numpy(), rtol=1e-6)

    def test_shape_errors_and_cuda_wrapper_refuses_cpu(self):
        A, B = torch.zeros(4, 5), torch.zeros(6, 2)
        with pytest.raises(ValueError, match="shape mismatch"):
            tsgemm(A, B)
        with pytest.raises(ValueError, match="CUDA"):
            tsgemm_cuda(torch.zeros(4, 5), torch.zeros(5, 2))


class TestRandomizedSVD:
    @pytest.mark.parametrize("use_tsgemm", [False, True])
    @pytest.mark.parametrize("p", [2, 3, 5])
    def test_same_sketch_same_subspace_as_reference(self, p, use_tsgemm):
        D = _subspace_data(p, 96, 300)
        key = jax.random.PRNGKey(p)
        ell = min(p + 8, min(D.shape))
        omega = np.asarray(jax.random.normal(key, (D.shape[1], ell), dtype=jnp.float32))
        want = np.asarray(ref_svd.randomized_truncated_svd(
            jnp.asarray(D), p, key=key, use_tsgemm=use_tsgemm
        ))
        got = svd.randomized_truncated_svd(
            torch.from_numpy(D), p, omega=torch.from_numpy(omega), use_tsgemm=use_tsgemm
        ).numpy()
        assert got.shape == (96, p)
        np.testing.assert_allclose(got.T @ got, np.eye(p), atol=1e-5)
        assert _max_angle_deg(got, want) <= 1e-2
        exact = svd.truncated_svd(torch.from_numpy(D), p)
        assert _max_angle_deg(got, exact.numpy()) < 1.0
        # the reference's own check, through the port's principal_angles
        assert np.degrees(principal_angles(torch.from_numpy(got), exact).max().item()) < 1.0

    def test_exact_matches_reference(self):
        D = _subspace_data(7, 64, 200)
        got = svd.truncated_svd(torch.from_numpy(D), 4).numpy()
        want = np.asarray(ref_svd.truncated_svd(jnp.asarray(D), 4))
        assert _max_angle_deg(got, want) <= 1e-2

    @pytest.mark.parametrize("method", ["exact", "randomized", "randomized_tsgemm"])
    def test_batched_signatures_match_one_by_one(self, method):
        """The explicit batch dimension gives each client the signature it
        gets alone (the reference vmaps per client)."""
        D = np.stack([_subspace_data(s, 48, 64) for s in range(3)])
        gens = lambda: [torch.Generator().manual_seed(s) for s in range(3)]  # noqa: E731
        batched = svd.batched_client_signatures(
            torch.from_numpy(D), 3, method, generators=gens()
        ).numpy()
        for b, g in enumerate(gens()):
            one = svd.client_signature(torch.from_numpy(D[b]), 3, method=method, generator=g)
            assert _max_angle_deg(batched[b], one.numpy()) <= 1e-2

    def test_buckets_and_upload_bytes_match_reference(self):
        for m in (1, 15, 16, 17, 300, 512, 513, 700):
            assert svd.bucket_samples(m) == ref_svd.bucket_samples(m)
        U = np.zeros((5, 32, 3), np.float32)
        assert svd.signature_upload_bytes(torch.from_numpy(U)) == ref_svd.signature_upload_bytes(
            jnp.asarray(U)
        )
        with pytest.raises(ValueError):
            svd.bucket_samples(0)
