"""Port parity: ``repro_torch.core.measures`` against ``repro.core.measures``.

Inputs are made with numpy from a seed and fed to both packages.  Angles
must agree within ``TOL_DEG`` = 1e-3 degrees (the reference's own
cross-backend tolerance, ``tests/test_measures_sharded.py``): the float32
sums run in another order in the two frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as ref
from repro_torch.core import measures as port

TOL_DEG = 1e-3


def _signatures(K, n=40, p=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(K)]
    ).astype(np.float32)


def _clustered(K, n=40, p=3, seed=0, spread=0.05):
    """Near-identical subspaces: smax near 1, the arccos-sensitive regime."""
    rng = np.random.default_rng(seed)
    B0 = rng.normal(size=(n, p))
    return np.stack([
        np.linalg.qr(B0 + spread * rng.normal(size=(n, p)))[0] for _ in range(K)
    ]).astype(np.float32)


def _both(fn_ref, fn_port, *arrays, **kw):
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    want = np.asarray(fn_ref(*(jnp.asarray(a) for a in arrays), **kw))
    return got, want


@pytest.mark.parametrize("make", [_signatures, _clustered], ids=["random", "clustered"])
@pytest.mark.parametrize("measure", ["eq3", "eq2"])
@pytest.mark.parametrize("p", [1, 3, 5])
class TestMeasureParity:
    def test_measure_tile(self, p, measure, make):
        Ui, Uj = make(6, p=p, seed=1), make(5, p=p, seed=2)
        got, want = _both(ref.measure_tile, port.measure_tile, Ui, Uj, measure=measure)
        assert got.shape == (6, 5)
        np.testing.assert_allclose(got, want, atol=TOL_DEG)

    def test_measure_pair(self, p, measure, make):
        Ui, Uj = make(7, p=p, seed=3), make(4, p=p, seed=4)
        got, want = _both(ref.measure_pair, port.measure_pair, Ui, Uj, measure=measure)
        np.testing.assert_allclose(got, want, atol=TOL_DEG)

    @pytest.mark.parametrize("solver", ["jacobi", "eigh", "svd"])
    def test_measure_from_gram(self, p, measure, make, solver):
        # distinct stacks: a self-pair sits at G = I, where one float32 ulp
        # of the singular value is already 0.02 degrees under arccos
        Ui, Uj = make(6, p=p, seed=5), make(5, p=p, seed=6)
        G = np.einsum("inp,jnq->ijpq", Ui, Uj).astype(np.float32)
        got, want = _both(
            ref.measure_from_gram, port.measure_from_gram, G,
            measure=measure, eq2_solver=solver,
        )
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=TOL_DEG)


class TestJacobiEigensolve:
    @pytest.mark.parametrize("p", [1, 2, 3, 5, 7])
    def test_matches_numpy_eigh(self, p):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(500, p, p)).astype(np.float32)
        B = np.einsum("bij,bkj->bik", X, X)
        lam = port.jacobi_max_eig(torch.from_numpy(B), p).numpy()
        np.testing.assert_allclose(lam, np.linalg.eigvalsh(B)[:, -1], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("p", [3, 6])
    def test_sweep_count_matches_reference(self, p):
        assert port.jacobi_sweeps(p) == ref.jacobi_sweeps(p)
        rng = np.random.default_rng(p)
        X = rng.normal(size=(64, p, p)).astype(np.float32)
        B = np.einsum("bij,bkj->bik", X, X)
        got = port.jacobi_max_eig(torch.from_numpy(B), p).numpy()
        want = np.asarray(ref.jacobi_max_eig(jnp.asarray(B), p))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_zero_and_identity_blocks_no_nan(self):
        """Zero Gram blocks and the identity hit the guarded d = e = 0 plane."""
        B = torch.stack([torch.zeros(3, 3), torch.eye(3), 2.0 * torch.eye(3)])
        lam = port.jacobi_max_eig(B, 3).numpy()
        assert np.isfinite(lam).all()
        np.testing.assert_allclose(lam, [0.0, 1.0, 2.0], atol=1e-6)
        G = torch.stack([torch.zeros(3, 3), torch.eye(3)])
        for measure in ("eq2", "eq3"):
            ang = port.measure_from_gram(G, measure).numpy()
            assert np.isfinite(ang).all()
        np.testing.assert_allclose(port.measure_from_gram(G, "eq2").numpy(), [90.0, 0.0], atol=1e-4)
        np.testing.assert_allclose(port.measure_from_gram(G, "eq3").numpy(), [270.0, 0.0], atol=1e-4)

    def test_unknown_measure_and_solver_raise(self):
        G = torch.eye(3)[None]
        with pytest.raises(ValueError, match="unknown measure"):
            port.measure_from_gram(G, "eq4")
        with pytest.raises(ValueError, match="unknown eq2 solver"):
            port.measure_from_gram(G, "eq2", eq2_solver="qr")
