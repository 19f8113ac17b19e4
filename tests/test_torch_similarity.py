"""The port's Table-6 distances on the CPU, held against ``repro.core.similarity``.

Bhattacharyya distance and KL divergence between Gaussian fits, and the RBF
kernel MMD with the median heuristic, on the same float32 samples (made with
numpy from a seed) in both packages.  Both compute in float32; they differ
in the order of their sums and in the LAPACK routine behind ``solve`` and
``slogdet``, so values agree within ``RTOL`` of their scale.  The MMD's
median over an even count averages the two middle values as ``jnp.median``
does (``torch.median`` would return the lower one): the tests cover even
and odd pooled counts and check the median itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core import similarity as ref
from repro_torch.core import similarity

# float32 sums of covariance products and a d x d factorization: ~1e-6
# relative a term, amplified by the covariances' conditioning (tens here).
RTOL = 2e-4


def _samples(seed, m, n, d, shift):
    """Correlated Gaussian samples; the mixing stays near the identity, so
    the covariances are well conditioned and float32 solves agree to their
    rounding (a near-singular covariance would amplify it ~1e4-fold)."""
    rng = np.random.default_rng(seed)
    mix = np.eye(d) + 0.3 * rng.normal(size=(d, d)) / np.sqrt(d)
    X = rng.normal(size=(m, d)) @ mix
    Y = rng.normal(size=(n, d)) @ mix + shift
    return X.astype(np.float32), Y.astype(np.float32)


def _close(got, want):
    got, want = float(got), float(want)
    assert np.isfinite(got)
    assert abs(got - want) <= RTOL * max(abs(want), 1.0), (got, want)


CASES = [(0, 120, 100, 8, 0.0), (1, 200, 150, 16, 0.5), (2, 64, 64, 32, 1.0)]


@pytest.mark.parametrize("seed,m,n,d,shift", CASES)
def test_bhattacharyya_equals_reference(seed, m, n, d, shift):
    X, Y = _samples(seed, m, n, d, shift)
    got = similarity.bhattacharyya_gaussian(torch.as_tensor(X), torch.as_tensor(Y))
    assert got.dtype == torch.float32
    _close(got, ref.bhattacharyya_gaussian(jnp.asarray(X), jnp.asarray(Y)))


@pytest.mark.parametrize("seed,m,n,d,shift", CASES)
def test_kl_equals_reference(seed, m, n, d, shift):
    X, Y = _samples(seed, m, n, d, shift)
    got = similarity.kl_gaussian(torch.as_tensor(X), torch.as_tensor(Y))
    assert got.dtype == torch.float32
    _close(got, ref.kl_gaussian(jnp.asarray(X), jnp.asarray(Y)))


@pytest.mark.parametrize("m,n", [(30, 20), (31, 20), (40, 40)])
def test_mmd_median_heuristic_equals_reference(m, n):
    """Pooled counts 50 and 80 are even (the median averages two middle
    values of an even number of distances), 51 odd."""
    X, Y = _samples(3, m, n, 12, 0.7)
    got = similarity.mmd_rbf(torch.as_tensor(X), torch.as_tensor(Y))
    assert got.dtype == torch.float32
    _close(got, ref.mmd_rbf(jnp.asarray(X), jnp.asarray(Y)))


def test_mmd_with_gamma_equals_reference():
    X, Y = _samples(4, 50, 60, 10, 0.3)
    got = similarity.mmd_rbf(torch.as_tensor(X), torch.as_tensor(Y), gamma=0.05)
    _close(got, ref.mmd_rbf(jnp.asarray(X), jnp.asarray(Y), gamma=0.05))


def test_even_count_median_averages_the_two_middle_values():
    v = torch.tensor([[4.0, 1.0], [3.0, 10.0]])
    assert float(similarity._median(v)) == 3.5 == float(jnp.median(jnp.asarray(v.numpy())))
    assert float(similarity._median(torch.tensor([5.0, 1.0, 2.0]))) == 2.0
    assert float(torch.median(v)) == 3.0   # the lower one: not the reference's


def test_identical_samples_are_at_distance_zero():
    X, _ = _samples(5, 40, 40, 6, 0.0)
    Xt = torch.as_tensor(X)
    assert abs(float(similarity.bhattacharyya_gaussian(Xt, Xt))) <= 1e-4
    assert abs(float(similarity.kl_gaussian(Xt, Xt))) <= 1e-4
    assert float(similarity.mmd_rbf(Xt, Xt)) <= 1e-3


def test_distances_grow_with_the_shift():
    """The Table-6 ordering: a farther shift is farther by every measure."""
    near = _samples(6, 100, 100, 8, 0.2)
    far = _samples(6, 100, 100, 8, 1.5)
    for fn in (similarity.bhattacharyya_gaussian, similarity.kl_gaussian, similarity.mmd_rbf):
        d_near = float(fn(*(torch.as_tensor(a) for a in near)))
        d_far = float(fn(*(torch.as_tensor(a) for a in far)))
        assert d_far > d_near
