"""Shared helpers of the FL port tests: the reference's random draws
replayed with ``jax.random``, tree conversions, and a fixture that runs a
module on one torch thread."""
import jax
import numpy as np
import pytest
import torch


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def trainable(tree):
    """A reference param tree without LeNet-5's int32 ``_meta`` leaf: the
    reference's ``jax.grad`` rejects integer leaves, so its LeNet-5 trains
    only without it (the apply never reads it)."""
    return {k: v for k, v in tree.items() if k != "_meta"}


def rel_err(got: dict, want: dict) -> float:
    """max over leaves of max|got - want| / max|want| (port dicts)."""
    return max(
        float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30))
        for k in want
    )


def ref_draws(key, n, steps, batch, perfed=False):
    """The reference's minibatch indices for one vmapped local update:
    ``_run_local`` splits the round key per client, ``local_sgd`` splits
    each client key per step and draws ``randint(0, max(n_k, 1))``;
    Per-FedAvg splits each step key into B1's and B2's."""
    keys = jax.random.split(key, len(n))
    out = []
    for key_i, n_i in zip(keys, n):
        hi = max(int(n_i), 1)
        per_step = []
        for key_t in jax.random.split(key_i, steps):
            if perfed:
                k1, k2 = jax.random.split(key_t)
                per_step.append([np.asarray(jax.random.randint(k, (batch,), 0, hi))
                                 for k in (k1, k2)])
            else:
                per_step.append(np.asarray(jax.random.randint(key_t, (batch,), 0, hi)))
        out.append(per_step)
    return torch.as_tensor(np.asarray(out, dtype=np.int64))


def ref_warmup_draws(key, n, segments, steps, batch, client_offset=0):
    """The reference warmup's minibatch indices ``(K, segments, steps,
    batch)``: client ``k``'s key is ``fold_in(key, client_offset + k)``,
    its segment ``s`` key ``fold_in`` of that with ``s`` (``warmup.py``),
    and ``local_sgd`` splits a segment key per step and draws ``randint(0,
    max(n_k, 1))``."""
    out = []
    for k, n_k in enumerate(n):
        key_k = jax.random.fold_in(key, client_offset + k)
        hi = max(int(n_k), 1)
        out.append([
            [np.asarray(jax.random.randint(key_t, (batch,), 0, hi))
             for key_t in jax.random.split(jax.random.fold_in(key_k, s), steps)]
            for s in range(segments)
        ])
    return np.asarray(out, dtype=np.int64)


def ref_projection(key0, n_params, sketch_dim):
    """The reference ``weight_delta`` sketch (``weight_delta.py``): normal
    draws from ``fold_in(key0, 0x5EED)`` over ``sqrt(sketch_dim)``."""
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(
        jax.random.fold_in(key0, 0x5EED), (n_params, sketch_dim), dtype=jnp.float32,
    ) / np.sqrt(sketch_dim))


def max_angle_deg(Ua, Ub) -> float:
    """Largest principal angle, in degrees, between the column spans of two
    (K, n, p) stacks, over clients: the arcsine of the spectral norm of
    ``Ub - Ua Ua^T Ub`` in float64 (accurate near 0 degrees, where an
    arccos of a float32 cosine has a floor of ~0.02 degrees)."""
    Ua, Ub = (np.asarray(U, dtype=np.float64) for U in (Ua, Ub))
    R = Ub - Ua @ np.einsum("knp,knq->kpq", Ua, Ub)
    sin = np.linalg.norm(R, ord=2, axis=(1, 2)).max()
    return float(np.degrees(np.arcsin(min(sin, 1.0))))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's port calls on one intra-op thread: its tensors are
    small, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores.  The previous count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
