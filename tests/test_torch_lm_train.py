"""Port parity: the LM train step (``lm_loss``, its gradients, ``make_train_step``).

All ten configurations at ``reduced()`` size (2 layers, d_model 256), plus
gemma3 at its real head dim 256 and zamba2 at its 112, are built by the
reference's ``lm.init_params``, carried across by
``convert.lm_params_from_numpy`` and trained by both packages, float32 on
both sides, on the same numpy-seeded batch (tokens (2, 20), longer than the
reduced attention chunk of 16 and gemma3's window of 8, with vision
embeddings or encoder frames where the model takes them):

* ``lm_loss`` within 1e-5 relative of ``jax.value_and_grad(lm_loss)``'s;
* every gradient leaf (``convert.lm_params_to_numpy`` restacks the port's
  into the reference's tree) within 1e-4 of that leaf's max |g_ref|.  No
  family needs more: the largest measured is rwkv6's, ~5e-5 of its
  channel-mix key weights (the WKV state sums nearly every past k v^T at the
  model's slow decay, so summation order shows most there);
* one ``make_train_step`` with ``sgd(momentum=0.9)`` and one with
  ``adamw(cosine_schedule)`` give parameters within 1e-5 (absolute) of the
  reference's jitted step.

Attention runs through the ``FlashAttention`` autograd Function, whose CPU
forward and backward are the kernels' plain twins, and each super-block
under ``torch.utils.checkpoint`` (``cfg.remat``); its gradients equal those
without remat bit for bit.  Gradient accumulation over 2 microbatches
equals one batch (the reference's ``tests/test_models.py`` check), and the
training launcher runs on the CPU.  Each reference result is computed once
per configuration.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # of each leaf's max |g_ref|
PARAM_ATOL = 1e-5
ARCHS = ["tinyllama-1.1b", "rwkv6-1.6b", "llama3.2-3b", "granite-8b", "gemma3-4b",
         "qwen2-moe-a2.7b", "zamba2-7b", "whisper-medium", "internvl2-26b",
         "llama4-scout-17b-a16e"]
GRAD_CASES = [(arch, None) for arch in ARCHS] + [("gemma3-4b", 256), ("zamba2-7b", 112)]
BATCH, SEQ = 2, 20
OPTIMIZERS = {
    "sgd_momentum": lambda m: m.sgd(1e-2, momentum=0.9),
    # the launcher's schedule (warmup 10) at a base rate whose first step
    # (5e-6) bounds AdamW's first update, -lr g / (|g| + eps) ~ -lr sign(g):
    # a gradient element near 0 whose sign the two packages' rounding sets
    # differently moves by 2 lr there, whatever the gradients' agreement.
    # The update arithmetic itself is held at 1e-6 on equal gradients in
    # tests/test_torch_optim.py.
    "adamw_cosine": lambda m: m.adamw(m.cosine_schedule(5e-5, warmup=10, total=100),
                                      weight_decay=0.1),
}


def _reduced(get, arch, head_dim=None):
    cfg = get(arch).reduced()
    return cfg if head_dim is None else dataclasses.replace(cfg, head_dim=head_dim)


def _batch(cfg, batch=BATCH, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * rng.normal(size=(batch, cfg.vision_tokens, cfg.d_model))
                                ).astype(np.float32)
    if cfg.is_enc_dec:
        out["encoder_frames"] = (0.02 * rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
                                 ).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, head_dim=None):
    """(ref cfg, ref params as numpy, batch, loss, grads as numpy)."""
    cfg = _reduced(ref_get_config, arch, head_dim)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: ref_lm.lm_loss(p, cfg, jbatch)))(params)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return cfg, as_np(params), batch, float(loss), as_np(grads)


def _port(arch, head_dim=None):
    ref_params = _reference(arch, head_dim)[1]
    return lm_params_from_numpy(_reduced(get_config, arch, head_dim), ref_params, device="cpu")


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,head_dim", GRAD_CASES)
def test_loss_and_gradients_match_reference(arch, head_dim):
    _, _, batch, ref_loss, ref_grads = _reference(arch, head_dim)
    port = _port(arch, head_dim)
    loss, grads = lm.value_and_grad(port, _torch_batch(batch))
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    got, want = _leaves(lm_params_to_numpy(port, grads)), _leaves(ref_grads)
    assert set(got) == set(want)
    for key, g_ref in want.items():
        assert got[key].shape == g_ref.shape, key
        if g_ref.size == 0:
            continue
        err = np.abs(got[key] - g_ref).max()
        assert err <= GRAD_TOL * np.abs(g_ref).max(), (key, err, np.abs(g_ref).max())
    # training leaves the parameters gradient-free, as serving expects them
    assert not any(p.requires_grad for p in port.parameters())


@functools.lru_cache(maxsize=None)
def _reference_step(arch, opt_name):
    cfg, params, batch, _, _ = _reference(arch)
    opt = OPTIMIZERS[opt_name](ref_optim)
    step = jax.jit(ref_lm.make_train_step(cfg, opt))
    new, _, metrics = step(jax.tree.map(jnp.asarray, params), opt.init(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, new), float(metrics["loss"])


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, opt_name):
    want, want_loss = _reference_step(arch, opt_name)
    port = _port(arch)
    opt = OPTIMIZERS[opt_name](optim)
    state = opt.init(dict(port.named_parameters()))
    step = lm.make_train_step(opt)
    port, state, metrics = step(port, state, _torch_batch(_reference(arch)[2]))
    assert int(state["step"]) == 1
    assert abs(float(metrics["loss"]) - want_loss) <= LOSS_RTOL * abs(want_loss)
    got = _leaves(lm_params_to_numpy(port))
    for key, w in _leaves(want).items():
        if w.size:
            assert np.abs(got[key] - w).max() <= PARAM_ATOL, key


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b", "whisper-medium"])
def test_remat_gives_the_same_gradients(arch):
    port = _port(arch)
    batch = _torch_batch(_reference(arch)[2])
    assert port.cfg.remat
    loss, grads = lm.value_and_grad(port, batch)
    port.cfg = dataclasses.replace(port.cfg, remat=False)
    loss2, grads2 = lm.value_and_grad(port, batch)
    assert torch.equal(loss, loss2)
    for name, g in grads.items():
        assert torch.equal(g, grads2[name]), name


def test_gradient_accumulation_matches_full_batch():
    """microbatches=2 with averaged grads == one batch (same update); the
    port of the reference's test_models.py check, at its tolerances."""
    cfg = get_config("tinyllama-1.1b").reduced()
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 32))).long()}
    out = []
    for microbatches in (1, 2):
        params = lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        opt = optim.sgd(1e-2)
        step = lm.make_train_step(opt, microbatches=microbatches)
        out.append(step(params, opt.init(dict(params.named_parameters())), batch))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for (name, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, err_msg=name)


def test_train_mode_builds_a_graph_through_attention():
    """Train mode reaches the FlashAttention Function on the CPU (its twins),
    with a gradient at every attention weight, and takes no cache."""
    port = _port("tinyllama-1.1b")
    tokens = torch.from_numpy(_reference("tinyllama-1.1b")[2]["tokens"]).long()
    loss, grads = lm.value_and_grad(port, {"tokens": tokens})
    for name, g in grads.items():
        if ".attn." in name:
            assert g.abs().max() > 0, name
    with pytest.raises(ValueError, match="no cache"):
        lm.forward(port, tokens, mode="train", cache=[])


def test_train_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--steps", "6", "--microbatches", "2"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("arch=tinyllama-1.1b") and lines[-1] == "done"
    losses = [float(l.split()[3]) for l in lines if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
