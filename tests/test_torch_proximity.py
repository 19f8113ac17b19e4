"""Port parity: the proximity backends and the proximity kernel's plain twin.

The port's ``repro_torch.core.angles`` backends (``torch``, ``torch_blocked``
and ``kernel``, which on CPU tensors runs the CUDA kernel's plain twin) are
held against the reference's Pallas kernel (interpret mode on the CPU, as
the reference's own tests run it), its oracle ``proximity_ref``, and its
``proximity_matrix`` / ``cross_proximity``, within ``TOL_DEG`` = 1e-3
degrees.  Inputs are made with numpy from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import angles as ref_angles
from repro.core.hc import hierarchical_clustering as ref_hc
from repro.kernels.proximity import proximity_ref as ref_proximity_ref
from repro.kernels.proximity.proximity import proximity_pallas
from repro_torch.core import angles
from repro_torch.core.hc import hierarchical_clustering
from repro_torch.kernels.proximity import (
    proximity,
    proximity_cross,
    proximity_cuda,
    proximity_plain,
    proximity_ref,
)

TOL_DEG = 1e-3
PORT_BACKENDS = ["torch", "torch_blocked", "kernel"]


def _signatures(K, n=40, p=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(K)]
    ).astype(np.float32)


def _clustered(K, n=40, p=3, seed=0, n_bases=3, spread=0.08):
    rng = np.random.default_rng(seed)
    bases = [rng.normal(size=(n, p)) for _ in range(n_bases)]
    return np.stack([
        np.linalg.qr(bases[k % n_bases] + spread * rng.normal(size=(n, p)))[0]
        for k in range(K)
    ]).astype(np.float32)


def _port(U, measure, backend, **kw):
    return angles.proximity_matrix(
        torch.from_numpy(U), measure, backend=backend, block_size=4, **kw
    ).numpy()


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("K", [5, 13])
class TestSquareParity:
    def test_backends_match_reference_kernel_and_oracle(self, K, p, measure):
        U = _signatures(K, p=p, seed=K * 10 + p)
        pallas = np.asarray(proximity_pallas(jnp.asarray(U), measure=measure))
        oracle = np.asarray(ref_proximity_ref(jnp.asarray(U), measure=measure))
        for backend in PORT_BACKENDS:
            got = _port(U, measure, backend)
            np.testing.assert_allclose(got, pallas, atol=TOL_DEG, err_msg=backend)
            np.testing.assert_allclose(got, oracle, atol=TOL_DEG, err_msg=backend)
        np.testing.assert_allclose(
            proximity_ref(torch.from_numpy(U), measure).numpy(), oracle, atol=TOL_DEG
        )

    def test_hygiene_and_labels_agree(self, K, p, measure):
        """The reference's ``test_angles_and_labels_agree`` pattern: quantile
        beta from the reference matrix, then equal HC labels."""
        U = _clustered(K, p=p, seed=K + p)
        ref = np.asarray(ref_angles.proximity_matrix(jnp.asarray(U), measure, backend="jnp"))
        beta = float(np.quantile(ref[ref > 0], 0.25))
        ref_labels = ref_hc(ref, beta=beta)
        for backend in PORT_BACKENDS:
            got = _port(U, measure, backend)
            assert (got == got.T).all(), backend
            assert (np.diag(got) == 0).all(), backend
            np.testing.assert_allclose(got, ref, atol=TOL_DEG, err_msg=backend)
            labels = hierarchical_clustering(got, beta=beta)
            assert (labels == ref_labels).all(), (backend, measure, K, p)


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
@pytest.mark.parametrize("p", [1, 3, 5])
class TestCrossParity:
    def test_cross_matches_reference(self, p, measure):
        Ua, Ub = _clustered(13, p=p, seed=p), _signatures(6, p=p, seed=p + 1)
        want = np.asarray(ref_angles.cross_proximity(
            jnp.asarray(Ua), jnp.asarray(Ub), measure, backend="jnp_blocked", block_size=4
        ))
        for backend in PORT_BACKENDS:
            got = angles.cross_proximity(
                torch.from_numpy(Ua), torch.from_numpy(Ub), measure,
                backend=backend, block_size=4,
            ).numpy()
            assert got.shape == (13, 6)
            np.testing.assert_allclose(got, want, atol=TOL_DEG, err_msg=backend)

    def test_cross_block_is_square_off_diagonal(self, p, measure):
        Ua, Ub = _clustered(9, p=p, seed=2 * p), _clustered(4, p=p, seed=2 * p + 1)
        U = torch.from_numpy(np.concatenate([Ua, Ub]))
        square = proximity(U, measure=measure).numpy()
        cross = proximity_cross(torch.from_numpy(Ua), torch.from_numpy(Ub), measure).numpy()
        np.testing.assert_allclose(cross, square[:9, 9:], atol=1e-5)


class TestRectangularAndLimits:
    @pytest.mark.parametrize("p,q", [(3, 5), (5, 2)])
    def test_eq2_rectangular_matches_reference(self, p, q):
        Ua, Ub = _signatures(7, p=p, seed=1), _signatures(5, p=q, seed=2)
        want = np.asarray(ref_angles.measure_pair(jnp.asarray(Ua), jnp.asarray(Ub), "eq2"))
        got = proximity_plain(torch.from_numpy(Ua), torch.from_numpy(Ub), "eq2").numpy()
        np.testing.assert_allclose(got, want, atol=TOL_DEG)

    def test_eq3_needs_equal_ranks(self):
        Ua, Ub = _signatures(3, p=3), _signatures(3, p=4)
        with pytest.raises(ValueError, match="p == q"):
            proximity_cross(torch.from_numpy(Ua), torch.from_numpy(Ub), "eq3")

    @pytest.mark.parametrize("measure", ["eq3", "eq2"])
    def test_rank_above_kernel_limit_raises(self, measure):
        """Ranks above the kernel's unrolled-template limit (8) do not raise:
        at p = 9 and 12 every backend matches the reference within TOL_DEG —
        its Pallas kernel for eq3 (its eq2 Jacobi unrolled at p > 8 takes
        minutes to trace in interpret mode), its ``jnp`` backend (the same
        packed Jacobi) for eq2, and its SVD oracle for both."""
        for p in (9, 12):
            U = _signatures(6, n=48, p=p, seed=p)
            jU = jnp.asarray(U)
            wants = [np.asarray(ref_proximity_ref(jU, measure=measure))]
            if measure == "eq3":
                wants.append(np.asarray(proximity_pallas(jU, measure=measure)))
            else:
                wants.append(np.asarray(ref_angles.proximity_matrix(jU, measure, backend="jnp")))
            for backend in PORT_BACKENDS:
                got = _port(U, measure, backend)
                for want in wants:
                    np.testing.assert_allclose(got, want, atol=TOL_DEG, err_msg=f"{backend} p={p}")

    @pytest.mark.parametrize("measure", ["eq3", "eq2"])
    @pytest.mark.parametrize("p", [9, 12])
    def test_high_rank_square_and_cross_match_reference(self, p, measure):
        """The kernel's twin at p > 8: the square matrix and a cross block
        against the reference's ``proximity_matrix`` / ``cross_proximity``."""
        U = _clustered(10, n=48, p=p, seed=3 * p)
        want = np.asarray(ref_angles.proximity_matrix(jnp.asarray(U), measure, backend="jnp"))
        np.testing.assert_allclose(_port(U, measure, "kernel"), want, atol=TOL_DEG)
        want_c = np.asarray(ref_angles.cross_proximity(
            jnp.asarray(U[:7]), jnp.asarray(U[7:]), measure, backend="jnp"))
        got_c = proximity_cross(torch.from_numpy(U[:7]), torch.from_numpy(U[7:]), measure)
        np.testing.assert_allclose(got_c.numpy(), want_c, atol=TOL_DEG)

    def test_cross_rank_3_by_12_matches_reference(self):
        Ua, Ub = _signatures(5, n=48, p=3, seed=31), _signatures(4, n=48, p=12, seed=32)
        want = np.asarray(ref_angles.measure_pair(jnp.asarray(Ua), jnp.asarray(Ub), "eq2"))
        got = proximity_cross(torch.from_numpy(Ua), torch.from_numpy(Ub), "eq2").numpy()
        assert got.shape == (5, 4)
        np.testing.assert_allclose(got, want, atol=TOL_DEG)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        U = torch.from_numpy(_signatures(3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            proximity_cuda(U, U, "eq3")

    def test_auto_resolves_by_device(self):
        cpu = torch.device("cpu")
        assert angles._resolve_backend("auto", 8, cpu) == "torch"
        assert angles._resolve_backend("auto", 4096, cpu) == "torch_blocked"
        assert angles._resolve_backend("auto", 8, torch.device("cuda")) == "kernel"
        with pytest.raises(ValueError, match="jacobi"):
            angles.proximity_matrix(
                torch.from_numpy(_signatures(3)), "eq2", backend="kernel", eq2_solver="svd"
            )
        # the reference's jnp_sharded is the port's "sharded" (opt-in: "auto"
        # never takes it); the reference's name, and a bogus one, still raise
        assert angles._resolve_backend("sharded", 8, cpu) == "sharded"
        U = torch.from_numpy(_signatures(3))
        assert torch.equal(angles.proximity_matrix(U, backend="sharded"),
                           angles.proximity_matrix(U, backend="kernel"))
        for name in ("jnp_sharded", "bogus"):
            with pytest.raises(ValueError, match="unknown proximity backend"):
                angles.proximity_matrix(U, backend=name)

    def test_single_pair_entries_match_reference(self):
        U, W = _signatures(2, p=3, seed=9)
        tU, tW = torch.from_numpy(U), torch.from_numpy(W)
        jU, jW = jnp.asarray(U), jnp.asarray(W)
        np.testing.assert_allclose(
            angles.principal_angles(tU, tW).numpy(),
            np.asarray(ref_angles.principal_angles(jU, jW)), atol=1e-5,
        )
        for port_fn, ref_fn in [
            (angles.smallest_principal_angle_deg, ref_angles.smallest_principal_angle_deg),
            (angles.trace_angle_deg, ref_angles.trace_angle_deg),
        ]:
            np.testing.assert_allclose(
                float(port_fn(tU, tW)), float(ref_fn(jU, jW)), atol=TOL_DEG
            )
