"""Port parity: the LM serving slice (configs, models, converter, serve).

Reduced configurations of the reference (``ArchConfig.reduced()``: 2 layers,
d_model 256) are built with the reference's ``lm.init_params``, carried
across by ``repro_torch.convert.lm_params_from_numpy`` and served by both
packages from the same numpy-seeded prompt: prefill logits and 8 greedy
decode steps agree within 1e-4 (float32 on both sides; the largest error
measured on these cases is 6.9e-6 against logits of magnitude ~3.5, from
summation order), and the greedy tokens are identical.  Everything runs
on the CPU, where the port's attention and WKV wrappers take their plain
twins.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 1e-4
N_DECODE = 8
SERVED = ["tinyllama-1.1b", "rwkv6-1.6b", "llama3.2-3b", "granite-8b"]
NOT_SERVED = sorted(set(ARCH_NAMES) - set(SERVED))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _models(arch, seed=0):
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced()
    port = lm_params_from_numpy(cfg, _numpy_tree(ref_params), device="cpu")
    return ref_cfg, ref_params, port


def _prompt(cfg, batch=2, length=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(np.int32)


def test_configs_match_reference():
    assert ARCH_NAMES == REF_ARCH_NAMES
    for name in ARCH_NAMES:
        port, ref = get_config(name), ref_get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_greedy_decode_match_reference(arch):
    ref_cfg, ref_params, port = _models(arch)
    prompt = _prompt(ref_cfg)
    B, S = prompt.shape
    max_len = S + N_DECODE
    ref_prefill = jax.jit(ref_lm.make_prefill_step(ref_cfg, max_len=max_len))
    ref_decode = jax.jit(ref_lm.make_serve_step(ref_cfg))
    prefill = lm.make_prefill_step(max_len=max_len)
    decode = lm.make_serve_step()

    want, ref_cache = ref_prefill(ref_params, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        got, cache = prefill(port, torch.from_numpy(prompt).long())
        errs = [float(np.abs(got.numpy() - np.asarray(want)).max())]
        tok, ref_tok = got.argmax(-1)[:, None], jnp.argmax(want, axis=-1)[:, None]
        for t in range(N_DECODE):
            assert tok.numpy().tolist() == np.asarray(ref_tok).tolist(), f"step {t}"
            want, ref_cache = ref_decode(ref_params, ref_cache, ref_tok, jnp.int32(S + t))
            got, cache = decode(port, cache, tok, S + t)
            errs.append(float(np.abs(got.numpy() - np.asarray(want)).max()))
            tok, ref_tok = got.argmax(-1)[:, None], jnp.argmax(want, axis=-1)[:, None]
    assert got.shape == (B, ref_cfg.vocab_padded)
    assert max(errs) <= LOGIT_ATOL, errs


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b"])
def test_full_sequence_logits_match_reference(arch):
    """Every position's logits (not only the last) from a cache-free forward."""
    ref_cfg, ref_params, port = _models(arch, seed=1)
    prompt = _prompt(ref_cfg, batch=3, length=20, seed=1)
    want, _, _ = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(prompt), mode="train")
    with torch.inference_mode():
        got, cache = lm.forward(port, torch.from_numpy(prompt).long(), mode="prefill")
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", NOT_SERVED)
def test_families_not_ported_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        lm.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1"):
        lm.check_supported(cfg)


def test_train_mode_and_bad_calls_raise():
    port = lm.init_params(get_config("tinyllama-1.1b").reduced(), dtype=torch.float32, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="train step"):
        lm.forward(port, tokens, mode="train")
    with pytest.raises(ValueError, match="decode needs"):
        lm.forward(port, tokens[:, :1], mode="decode")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(get_config("tinyllama-1.1b").reduced())


def test_init_params_shapes_match_reference_and_are_seeded():
    cfg = get_config("rwkv6-1.6b").reduced()
    ref = _numpy_tree(ref_lm.init_params(ref_get_config("rwkv6-1.6b").reduced(),
                                         jax.random.PRNGKey(0)))
    a = lm.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    b = lm.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    assert a.embed.shape == ref["embed"].shape and a.lm_head.shape == ref["lm_head"].shape
    layer = a.stages[0][1]["sub0"]
    for name, leaf in ref["stages"][0]["sub0"].items():
        assert tuple(getattr(layer, name).shape) == leaf.shape[1:], name
    assert len(a.stages[0]) == cfg.n_layers
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    half = lm.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    assert half.embed.dtype == torch.bfloat16 and half.final_norm.dtype == torch.float32


def test_converter_rejects_mismatched_trees():
    cfg = get_config("tinyllama-1.1b").reduced()
    ref = _numpy_tree(ref_lm.init_params(ref_get_config("tinyllama-1.1b").reduced(),
                                         jax.random.PRNGKey(0)))
    bad = dict(ref, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    missing = {k: v for k, v in ref.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="no reference leaf"):
        lm_params_from_numpy(cfg, missing, device="cpu")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "float32" in out


def test_layers_match_reference():
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale, bias = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    f32 = torch.float32
    np.testing.assert_allclose(layers.rmsnorm(tx, ts, 1e-5, f32).numpy(),
                               np.asarray(ref_layers.rmsnorm(jx, js)), atol=1e-5)
    np.testing.assert_allclose(layers.layernorm(tx, ts, tb, 1e-5, f32).numpy(),
                               np.asarray(ref_layers.layernorm(jx, js, jb)), atol=1e-5)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(layers.act_fn(name)(tx).numpy(),
                                   np.asarray(ref_layers.act_fn(name)(jx)), atol=1e-6)
    ref_mlp = _numpy_tree(ref_layers.init_mlp(jax.random.PRNGKey(0), 16, 24))
    mlp = layers.MLP(**{k: torch.from_numpy(np.array(v)) for k, v in ref_mlp.items()})
    want = ref_layers.mlp_apply(ref_mlp, jx, "gelu")
    np.testing.assert_allclose(layers.mlp_apply(mlp, tx, "gelu", f32).numpy(),
                               np.asarray(want), atol=1e-5)


def test_generate_is_greedy_over_padded_vocab():
    cfg = get_config("tinyllama-1.1b").reduced()
    port = lm.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    prompt = serve.random_prompt(cfg, 2, 5, seed=2, device="cpu")
    toks, times = serve.generate(port, prompt, 4)
    assert toks.shape == (2, 4) and set(times) == {"prefill_s", "decode_s"}
    with torch.inference_mode():
        logits, _ = lm.forward(port, prompt)
    assert torch.equal(toks[:, 0], logits[:, -1].argmax(-1))
    assert int(toks.max()) < cfg.vocab_padded


def test_new_modules_import_without_jax():
    """The slice's modules import with ``jax`` blocked."""
    script = (
        "import sys, importlib, json\n"
        "sys.modules['jax'] = None\n"
        "mods = ['repro_torch.configs', 'repro_torch.models.layers',\n"
        "        'repro_torch.models.attention', 'repro_torch.models.ssm',\n"
        "        'repro_torch.models.lm', 'repro_torch.launch.serve',\n"
        "        'repro_torch.kernels.flash_attention', 'repro_torch.kernels.wkv',\n"
        "        'repro_torch.convert']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'repro' or k.startswith(('repro.', 'jax.')))\n"
        "print(json.dumps({'bad': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, check=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []
