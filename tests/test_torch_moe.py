"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the reference.

The reference's ``init_moe`` parameters (reduced qwen2-moe-a2.7b: 4 experts,
top-2, one shared expert; reduced llama4-scout: top-1) are carried across,
and both packages apply the FFN to the same numpy-seeded activations in
float32: the top-k choices are equal, and the outputs and the Switch
auxiliary loss agree within 1e-5.  The cases cover one whole chunk, a last
chunk with padding (padded tokens get no capacity), chunks whose capacity
drops choices (``capacity_factor`` 0.5), several chunks and one decode
token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.layers import MLP

TOL = 1e-5

# (arch, tokens, capacity_factor): moe_chunk is 16 in the reduced configs
CASES = [
    ("qwen2-moe-a2.7b", 16, 1.25),   # one whole chunk
    ("qwen2-moe-a2.7b", 20, 1.25),   # second chunk padded 4 -> 16
    ("qwen2-moe-a2.7b", 40, 0.5),    # capacity 4: drops, and a padded chunk
    ("llama4-scout-17b-a16e", 37, 0.5),   # top-1, drops, padding
    ("llama4-scout-17b-a16e", 1, 1.25),   # one decode token
]


def _cfgs(arch, capacity_factor):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), capacity_factor=capacity_factor)
    port = dataclasses.replace(get_config(arch).reduced(), capacity_factor=capacity_factor)
    return ref, port


def _port_moe(tree) -> moe.MoE:
    t = {k: torch.from_numpy(np.array(v)) for k, v in tree.items() if k != "shared"}
    shared = None
    if "shared" in tree:
        shared = MLP(**{k: torch.from_numpy(np.array(v)) for k, v in tree["shared"].items()})
    return moe.MoE(t["router"], t["w_in"], t["w_gate"], t["w_out"], shared)


@pytest.mark.parametrize("arch,S,capacity_factor", CASES)
def test_moe_apply_matches_reference(arch, S, capacity_factor):
    ref_cfg, cfg = _cfgs(arch, capacity_factor)
    tree = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(S), ref_cfg))
    params = _port_moe(tree)
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)

    want, want_aux = ref_moe.moe_apply(tree, jnp.asarray(x), ref_cfg)
    got, got_aux = moe.moe_apply(params, torch.from_numpy(x), cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=TOL)

    # the reference's routing lines on the same tokens: equal choices
    logits = ref_layers.mm(jnp.asarray(x), tree["router"]).astype(jnp.float32)
    ref_w, ref_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), ref_cfg.top_k)
    _, top_w, top_i = moe.route(params, torch.from_numpy(x), cfg, torch.float32)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    ref_w = ref_w / jnp.maximum(jnp.sum(ref_w, -1, keepdims=True), 1e-9)
    np.testing.assert_allclose(top_w.numpy(), np.asarray(ref_w), atol=TOL)

    if capacity_factor < 1:
        # some expert of some chunk and batch row is asked for more than its slots
        cs = min(cfg.moe_chunk, S)
        C = moe.capacity(cs, cfg)
        idx = top_i.numpy()
        counts = [np.bincount(idx[b, c:c + cs].ravel(), minlength=cfg.n_experts).max()
                  for b in range(idx.shape[0]) for c in range(0, S, cs)]
        assert max(counts) > C == ref_moe._capacity(cs, ref_cfg)


def test_init_moe_shapes_match_reference():
    ref_cfg, cfg = _cfgs("qwen2-moe-a2.7b", 1.25)
    tree = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg))
    gen = torch.Generator().manual_seed(0)
    port = moe.init_moe(gen, cfg, "cpu")
    for name in ("router", "w_in", "w_gate", "w_out"):
        assert tuple(getattr(port, name).shape) == tree[name].shape, name
    for name, leaf in tree["shared"].items():
        assert tuple(getattr(port.shared, name).shape) == leaf.shape, name
