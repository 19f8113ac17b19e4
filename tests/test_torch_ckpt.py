"""Port parity: ``repro_torch.ckpt`` and the LM tree converters.

The port writes the reference's on-disk format (``arrays.npz`` keyed by
JAX key paths, ``meta.json`` with ``step`` / ``config`` / ``keys``), so
each package restores the other's checkpoints.  Where the reference's
``restore`` without ``like`` leaves a list (the LM's ``stages``) as a dict
keyed "0", "1", ..., the port's gives the list back, and
``convert.lm_params_from_numpy`` takes it as it is.
``convert.lm_params_to_numpy`` gives the reference's tree back bit for
bit.  Everything is exact (no tolerance).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy

ARCHS = ["tinyllama-1.1b", "gemma3-4b", "zamba2-7b", "whisper-medium", "qwen2-moe-a2.7b"]


def _ref_tree(arch):
    cfg = ref_get_config(arch).reduced()
    return cfg, jax.tree.map(np.asarray, ref_lm.init_params(cfg, jax.random.PRNGKey(1)))


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path


def test_round_trip_with_and_without_like(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "layers": [{"b": torch.zeros(5), "k": torch.ones((2, 2), dtype=torch.float64)},
                       {"b": torch.arange(5.0), "k": torch.eye(2, dtype=torch.float64)}],
            "step_count": np.int32(7)}
    ckpt.save(tmp_path / "c", tree, step=12, config={"lr": 0.1})
    meta = json.loads((tmp_path / "c" / "meta.json").read_text())
    assert meta["step"] == 12 and meta["config"] == {"lr": 0.1}
    assert meta["keys"] == ["['layers'][0]['b']", "['layers'][0]['k']", "['layers'][1]['b']",
                            "['layers'][1]['k']", "['step_count']", "['w']"]
    numpy_tree = jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                              else np.asarray(t), tree)
    got, meta = ckpt.restore(tmp_path / "c")
    _assert_same(got, numpy_tree)
    got, _ = ckpt.restore(tmp_path / "c", like=tree)
    _assert_same(got, numpy_tree)
    # the reference reads the port's checkpoint into the same structure
    ref_got, ref_meta = ref_ckpt.restore(tmp_path / "c", like=numpy_tree)
    _assert_same(jax.tree.map(np.asarray, ref_got), numpy_tree)
    assert ref_meta["keys"] == meta["keys"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_lm_checkpoint_restores_into_the_port(tmp_path, arch):
    cfg, ref_tree = _ref_tree(arch)
    ref_ckpt.save(tmp_path / "ref", ref_tree, step=3, config={"arch": arch})
    ref_flat, _ = ref_ckpt.restore(tmp_path / "ref")
    assert isinstance(ref_flat["stages"], dict)          # the reference's digit-keyed dict
    got, meta = ckpt.restore(tmp_path / "ref")
    assert meta["step"] == 3 and meta["config"] == {"arch": arch}
    assert isinstance(got["stages"], list)
    _assert_same(got, ref_tree)
    model = lm_params_from_numpy(get_config(arch).reduced(), got, device="cpu")
    want = lm_params_from_numpy(get_config(arch).reduced(), ref_tree, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), n
    # and the port's checkpoint of the model reads back into the reference's tree
    ckpt.save(tmp_path / "port", lm_params_to_numpy(model), step=4)
    back, _ = ref_ckpt.restore(tmp_path / "port", like=ref_tree)
    _assert_same(jax.tree.map(np.asarray, back), ref_tree)


@pytest.mark.parametrize("arch", sorted(set(ARCHS) | {"rwkv6-1.6b", "internvl2-26b",
                                                     "llama4-scout-17b-a16e"}))
def test_lm_params_to_numpy_inverts_from_numpy(arch):
    _, ref_tree = _ref_tree(arch)
    model = lm_params_from_numpy(get_config(arch).reduced(), ref_tree, device="cpu")
    _assert_same(lm_params_to_numpy(model), ref_tree)
    grads = {n: torch.full_like(p, 2.0) for n, p in model.named_parameters()}
    doubled = lm_params_to_numpy(model, grads)
    _assert_same(doubled, jax.tree.map(lambda a: np.full_like(a, 2.0), ref_tree))
