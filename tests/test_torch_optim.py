"""Port parity: ``repro_torch.optim`` against ``repro.optim``.

The same numpy-seeded parameter tree (nested dicts for the reference, the
same leaves by dotted name for the port) takes 5 steps of numpy-seeded
gradients through each optimizer on both sides; the parameters, and the
schedule, norm and clipping values, agree within 1e-6 relative (float32 on
both sides, differing only in rounding order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim

RTOL = 1e-6
SHAPES = {"w": (6, 5), "blk": {"b": (7,), "k": (3, 4, 2)}, "head": (5, 9)}
STEPS = 5


def _flat(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


def _draw(rng, shapes, scale=1.0):
    return {k: _draw(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.normal(size=v)).astype(np.float32) for k, v in shapes.items()}


def _port(tree):
    return {name: torch.from_numpy(np.array(a)) for name, a in _flat(tree)}


def _rel(port: dict, ref) -> float:
    ref = dict(_flat(jax.tree.map(np.asarray, ref)))
    scale = max(np.abs(a).max() for a in ref.values())
    return max(np.abs(port[n].numpy() - ref[n]).max() for n in ref) / scale


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.05), {}),
    "sgd_momentum": (lambda m: m.sgd(0.05, momentum=0.9), {}),
    "sgd_momentum_decay": (lambda m: m.sgd(0.05, momentum=0.9, weight_decay=0.01), {}),
    "sgd_cosine": (lambda m: m.sgd(m.cosine_schedule(0.1, warmup=2, total=5), momentum=0.9), {}),
    "adamw": (lambda m: m.adamw(1e-2), {}),
    "adamw_decay": (lambda m: m.adamw(1e-2, weight_decay=0.1), {}),
    "adamw_cosine": (lambda m: m.adamw(m.cosine_schedule(3e-2, warmup=2, total=5),
                                       b1=0.8, b2=0.95, eps=1e-6, weight_decay=0.05), {}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_reference_over_steps(name):
    make, _ = OPTIMIZERS[name]
    ref_opt, opt = make(ref_optim), make(optim)
    rng = np.random.default_rng(0)
    params = _draw(rng, SHAPES)
    ref_params, port_params = jax.tree.map(jnp.asarray, params), _port(params)
    ref_state, state = ref_opt.init(ref_params), opt.init(port_params)
    for step in range(STEPS):
        grads = _draw(rng, SHAPES, scale=10.0 ** (step - 2))   # 1e-2 .. 1e2
        upd, ref_state = ref_opt.update(jax.tree.map(jnp.asarray, grads), ref_state, ref_params)
        ref_params = ref_optim.apply_updates(ref_params, upd)
        upd, state = opt.update(_port(grads), state, port_params)
        port_params = optim.apply_updates(port_params, upd)
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        assert _rel(port_params, ref_params) <= RTOL, f"step {step}"
        assert all(p.dtype == torch.float32 for p in port_params.values())
    for key in ("mu", "m", "v"):
        if key in ref_state:
            assert _rel(state[key], ref_state[key]) <= RTOL, key


def test_cosine_schedule_matches_reference():
    ref, port = (m.cosine_schedule(3e-4, warmup=10, total=100, min_frac=0.1)
                 for m in (ref_optim, optim))
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= RTOL * abs(want) + 1e-12, step


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _draw(np.random.default_rng(1), SHAPES)
    want = float(ref_optim.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(optim.global_norm(_port(tree)))
    assert abs(got - want) <= RTOL * want
    clipped = optim.clip_by_global_norm(_port(tree), max_norm)
    assert _rel(clipped, ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                                       max_norm)) <= RTOL
    assert float(optim.global_norm(clipped)) <= max(max_norm, want) * (1 + 1e-6)


def test_state_is_float32_and_keyed_like_params():
    params = {"a": torch.zeros((2, 3), dtype=torch.bfloat16), "b": torch.zeros(4)}
    state = optim.adamw(1e-3).init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key in ("m", "v"):
        assert set(state[key]) == set(params)
        assert all(t.dtype == torch.float32 for t in state[key].values())
    assert "mu" not in optim.sgd(0.1).init(params)
    assert optim.sgd(0.1, momentum=0.9).init(params)["mu"]["a"].dtype == torch.float32
