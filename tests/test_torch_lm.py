"""Port parity: the LM serving slice (configs, models, converter, serve).

Reduced configurations of the reference (``ArchConfig.reduced()``: 2 layers,
d_model 256) of all ten architectures are built with the reference's
``lm.init_params``, carried across by
``repro_torch.convert.lm_params_from_numpy`` and served by both packages
from the same numpy-seeded prompt (and vision embeddings or encoder frames
where the model takes them): prefill logits and 8 greedy decode steps agree
within 1e-4 (float32 on both sides; the largest error measured on the
first four models is 6.9e-6 against logits of magnitude ~3.5, from
summation order), and the greedy tokens are identical.  Besides the reduced
head dim (32), gemma3 runs at its real head dim 256 and zamba2 at its 112,
and gemma3 with a prompt longer than its window (the ring rolls at prefill
and wraps at decode).  One reference model per configuration is shared by
the file's cases.  Everything runs on the CPU, where the port's attention
and WKV wrappers take their plain twins.
"""
import dataclasses
import functools
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
SERVED = ["tinyllama-1.1b", "rwkv6-1.6b", "llama3.2-3b", "granite-8b", "gemma3-4b",
          "qwen2-moe-a2.7b", "zamba2-7b", "whisper-medium", "internvl2-26b",
          "llama4-scout-17b-a16e"]
# (arch, head dim or None for the reduced 32, prompt length)
SERVED_CASES = [(arch, None, 12) for arch in SERVED] + [
    ("gemma3-4b", 256, 12),    # gemma3's real head dim
    ("zamba2-7b", 112, 12),    # zamba2's real head dim (3584 / 32)
    ("gemma3-4b", None, 20),   # prompt 20 > window 8: the ring rolls, then wraps
]


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _reduced(get, arch, head_dim=None):
    cfg = get(arch).reduced()
    return cfg if head_dim is None else dataclasses.replace(cfg, head_dim=head_dim)


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0, head_dim=None):
    ref_cfg = _reduced(ref_get_config, arch, head_dim)
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed))
    cfg = _reduced(get_config, arch, head_dim)
    port = lm_params_from_numpy(cfg, _numpy_tree(ref_params), device="cpu")
    return ref_cfg, ref_params, port


def _prompt(cfg, batch=2, length=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(np.int32)


def _extras(cfg, batch=2, seed=0):
    """The model's extra prefill inputs as numpy arrays, at the reference's
    scale (0.02 x standard normal)."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.vision_tokens:
        out["vision_embeds"] = 0.02 * rng.normal(size=(batch, cfg.vision_tokens, cfg.d_model))
    if cfg.is_enc_dec:
        out["encoder_frames"] = 0.02 * rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_configs_match_reference():
    assert ARCH_NAMES == REF_ARCH_NAMES
    for name in ARCH_NAMES:
        port, ref = get_config(name), ref_get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("arch,head_dim,prompt_len", SERVED_CASES)
def test_prefill_and_greedy_decode_match_reference(arch, head_dim, prompt_len):
    ref_cfg, ref_params, port = _models(arch, head_dim=head_dim)
    prompt = _prompt(ref_cfg, length=prompt_len)
    extras = _extras(ref_cfg)
    B, S = prompt.shape
    max_len = S + N_DECODE
    ref_prefill = jax.jit(ref_lm.make_prefill_step(ref_cfg, max_len=max_len))
    ref_decode = jax.jit(ref_lm.make_serve_step(ref_cfg))
    prefill = lm.make_prefill_step(max_len=max_len)
    decode = lm.make_serve_step()

    want, ref_cache = ref_prefill(
        ref_params, {"tokens": jnp.asarray(prompt), **{k: jnp.asarray(v) for k, v in extras.items()}})
    with torch.inference_mode():
        got, cache = prefill(port, {"tokens": torch.from_numpy(prompt).long(),
                                    **{k: torch.from_numpy(v) for k, v in extras.items()}})
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


@pytest.mark.parametrize("arch", SERVED)
def test_full_sequence_logits_match_reference(arch):
    """Every position's logits (not only the last) from a cache-free forward."""
    ref_cfg, ref_params, port = _models(arch)
    prompt = _prompt(ref_cfg, batch=3, length=20, seed=1)
    extras = _extras(ref_cfg, batch=3, seed=1)
    want, _, _ = ref_lm.forward(ref_params, ref_cfg, jnp.asarray(prompt), mode="train",
                                **{k: jnp.asarray(v) for k, v in extras.items()})
    with torch.inference_mode():
        got, cache = lm.forward(port, torch.from_numpy(prompt).long(), mode="prefill",
                                **{k: torch.from_numpy(v) for k, v in extras.items()})
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_train_mode_and_bad_calls_raise():
    port = lm.init_params(get_config("tinyllama-1.1b").reduced(), dtype=torch.float32, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    # train mode runs (tests/test_torch_lm_train.py), but takes no cache
    with pytest.raises(ValueError, match="no cache"):
        lm.forward(port, tokens, mode="train", cache=lm.init_cache(port, 1, 4))
    with pytest.raises(ValueError, match="unknown mode"):
        lm.forward(port, tokens, mode="eval")
    with pytest.raises(ValueError, match="decode needs"):
        lm.forward(port, tokens[:, :1], mode="decode")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(get_config("tinyllama-1.1b").reduced())
    whisper = lm.init_params(get_config("whisper-medium").reduced(), dtype=torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="encoder_frames"):
        lm.forward(whisper, tokens)
    vlm_cfg = get_config("internvl2-26b").reduced()
    vlm = lm.init_params(vlm_cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vision embeddings"):
        lm.forward(vlm, tokens, vision_embeds=torch.zeros((1, vlm_cfg.vision_tokens,
                                                           vlm_cfg.d_model)))


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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b", "whisper-medium",
                                  "internvl2-26b"])
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


# Flash calls in one forward at full width (prefill, decode): one per
# attention layer, two with cross-attention, one per application of zamba2's
# shared block (13 super-blocks), whisper's 24 encoder layers at prefill.
ATTENTION_CALLS = {"tinyllama-1.1b": (22, 22), "rwkv6-1.6b": (0, 0), "llama3.2-3b": (28, 28),
                   "granite-8b": (36, 36), "gemma3-4b": (34, 34), "qwen2-moe-a2.7b": (24, 24),
                   "zamba2-7b": (13, 13), "whisper-medium": (72, 48), "internvl2-26b": (48, 48),
                   "llama4-scout-17b-a16e": (48, 48)}
# reduced depths that hold a whole super-block and a remainder layer
CALL_DEPTH = {"gemma3-4b": 7, "zamba2-7b": 7}


@pytest.mark.parametrize("arch", SERVED)
def test_attention_calls_count_the_forward(arch, monkeypatch):
    """``lm.attention_calls`` (the launch count the card checks expect) at
    full width, and against the attention calls a reduced prefill and decode
    step make on the CPU."""
    from repro_torch.models import attention

    full = get_config(arch)
    assert (lm.attention_calls(full, True), lm.attention_calls(full, False)) == \
        ATTENTION_CALLS[arch]
    cfg = get_config(arch).reduced()
    if arch in CALL_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=CALL_DEPTH[arch])
    port = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    prompt = serve.random_prompt(cfg, 1, 12, seed=0, device="cpu")
    extra = serve.model_inputs(cfg, 1, dtype=torch.float32, seed=1, device="cpu")
    calls = []
    inner = attention.chunked_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(attention, "chunked_attention", counted)
    with torch.inference_mode():
        logits, cache = lm.make_prefill_step(14)(port, {"tokens": prompt, **extra})
        n_prefill = len(calls)
        lm.make_serve_step()(port, cache, logits.argmax(-1)[:, None], 12)
    assert (n_prefill, len(calls) - n_prefill) == (lm.attention_calls(cfg, True),
                                                   lm.attention_calls(cfg, False))


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
        "        'repro_torch.models.moe', 'repro_torch.models.lm', 'repro_torch.launch.serve',\n"
        "        'repro_torch.kernels.flash_attention', 'repro_torch.kernels.wkv',\n"
        "        'repro_torch.convert', 'repro_torch.sharding', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.train', 'repro_torch.launch.dryrun']\n"
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
