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


# bfloat16 leaves: the reference writes a JAX bfloat16 array as 2-byte |V2
# records of its bits; the port writes a bfloat16 tensor the same way.
def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    ref_tree = {"w": jnp.asarray(rng.normal(size=(5, 7)), dtype=jnp.bfloat16),
                "b": jnp.asarray(rng.normal(size=(7,)), dtype=jnp.float32),
                "layers": [{"k": jnp.asarray(rng.normal(size=(3, 2)), dtype=jnp.bfloat16)}]}
    ref_ckpt.save(tmp_path / "ref", ref_tree, step=2)
    ref_flat, _ = ref_ckpt.restore(tmp_path / "ref")
    got, meta = ckpt.restore(tmp_path / "ref")
    assert meta["step"] == 2
    # without like: the reference's |V2 records, bit for bit
    for a, b in ((got["w"], ref_flat["w"]), (got["layers"][0]["k"], ref_flat["layers"]["0"]["k"])):
        assert a.dtype == b.dtype == np.dtype("V2") and np.array_equal(a, b)
    np.testing.assert_array_equal(got["w"].view(np.int16), _bf16_bits(ref_tree["w"]))
    # with like: bfloat16 tensors with the reference's bits, other leaves as stored
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16), "b": torch.zeros(7),
            "layers": [{"k": torch.zeros((3, 2), dtype=torch.bfloat16)}]}
    got, _ = ckpt.restore(tmp_path / "ref", like=like)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (5, 7)
    np.testing.assert_array_equal(_bf16_bits(got["w"]), _bf16_bits(ref_tree["w"]))
    np.testing.assert_array_equal(_bf16_bits(got["layers"][0]["k"]),
                                  _bf16_bits(ref_tree["layers"][0]["k"]))
    np.testing.assert_array_equal(got["b"], np.asarray(ref_tree["b"]))


def test_port_bf16_checkpoint_restores_into_the_reference(tmp_path):
    import jax.numpy as jnp

    g = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn((4, 6), generator=g).to(torch.bfloat16),
            "v": torch.randn((6,), generator=g),
            "nan_inf": torch.tensor([float("nan"), float("inf"), -0.0, 1e-40]).to(torch.bfloat16)}
    ckpt.save(tmp_path / "port", tree, step=9)
    like = {"w": jnp.zeros((4, 6), jnp.bfloat16), "v": jnp.zeros(6, jnp.float32),
            "nan_inf": jnp.zeros(4, jnp.bfloat16)}
    for ref_got in (ref_ckpt.restore(tmp_path / "port", like=like)[0],
                    ref_ckpt.restore(tmp_path / "port")[0]):
        for key in ("w", "nan_inf"):
            assert np.asarray(ref_got[key]).dtype == np.dtype("V2")
            np.testing.assert_array_equal(_bf16_bits(ref_got[key]), _bf16_bits(tree[key]))
        np.testing.assert_array_equal(np.asarray(ref_got["v"]), tree["v"].numpy())
    # the reference's own bf16 array of the same values is the same bytes on disk
    ref_ckpt.save(tmp_path / "ref", {"w": jnp.asarray(tree["w"].float().numpy(), jnp.bfloat16)})
    a = np.load(tmp_path / "port" / "arrays.npz")["['w']"]
    b = np.load(tmp_path / "ref" / "arrays.npz")["['w']"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_bf16_lm_params_round_trip(tmp_path, arch):
    """A model stored in bfloat16 (serving's init_params) round-trips through
    the port's checkpoint bit for bit, and the reference reads the same bits."""
    from repro_torch.models import lm

    model = lm.init_params(get_config(arch).reduced(), seed=3, dtype=torch.bfloat16,
                           device="cpu")
    tree = {name: p.detach() for name, p in model.named_parameters()}
    assert any(t.dtype == torch.bfloat16 for t in tree.values())
    ckpt.save(tmp_path / "c", tree, step=1)
    got, _ = ckpt.restore(tmp_path / "c", like=tree)
    for name, t in tree.items():
        assert tuple(got[name].shape) == tuple(t.shape), name
        if t.dtype == torch.bfloat16:     # a bfloat16 tensor; other leaves stay NumPy
            assert got[name].dtype == torch.bfloat16, name
            assert torch.equal(got[name].view(torch.int16), t.view(torch.int16)), name
        else:
            assert got[name].dtype == t.numpy().dtype, name
            np.testing.assert_array_equal(got[name], t.numpy())
    ref_got, _ = ref_ckpt.restore(tmp_path / "c")
    for name, t in tree.items():
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(ref_got[name]), _bf16_bits(t))
