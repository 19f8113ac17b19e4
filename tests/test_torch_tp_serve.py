"""Port parity: tensor- and expert-parallel LM serving over gloo ranks.

The attention + MLP / MoE families at ``reduced()`` size (tinyllama-1.1b,
llama3.2-3b, granite-8b, qwen2-moe-a2.7b, llama4-scout-17b-a16e,
internvl2-26b), and llama4-scout with its 16 experts kept
(``reduced()`` caps experts at 4, which puts llama4 under the expert-F
rule; with 16 the experts go over the model axis: the one place expert
parallelism meets the reference on the CPU).  The reference's
``lm.init_params`` weights are cut to each rank's shard by
``repro_torch.convert.lm_shard_from_numpy`` and served by ranks in fresh
processes (``repro_torch.launch.mesh.run_ranks``, gloo, a ``file://``
store under the test's temporary directory) on meshes 1x2 (``tp_only``),
1x4 (``fsdp_tp``, data 1) and 2x2 (``tp_only``, ``ddp`` and ``fsdp_tp``,
whose weights are gathered over data before use: each data group its own
row).  A sharded model's train mode gives finite logits through a graph
autograd recorded.  Prefill and 8 greedy decode steps: every step's logits
within the LM tests' ``LOGIT_ATOL`` of the reference's ``make_prefill_step``
/ ``make_serve_step`` (float32 both sides; sharding changes only summation
order), the greedy tokens equal, and every rank of a model group holding
the same logits bit for bit (activations are replicated over the axis).
One spawn serves every case of a mesh (module-scoped), each join under a
time limit.  Also: ``init_params_sharded`` equals the unsharded init's
slices bit for bit (float32 and bfloat16) and ``shard_params`` of it, and
``launch/serve.py --mesh`` on the CPU gives the one-card path's tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import sharding
from repro_torch.launch import serve
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm

LOGIT_ATOL = 1e-4          # tests/test_torch_lm.py
N_DECODE = 8
BATCH, PROMPT = 2, 12
SPAWN_TIMEOUT_S = 300.0
FAMILIES = ["tinyllama-1.1b", "llama3.2-3b", "granite-8b", "qwen2-moe-a2.7b",
            "llama4-scout-17b-a16e", "internvl2-26b"]
# (label, arch, experts kept or None for reduced()'s)
CONFIGS = [(arch, arch, None) for arch in FAMILIES] + [
    ("llama4-scout, 16 experts", "llama4-scout-17b-a16e", 16)]
# mesh -> (data, model, [(config label, scheme)])
MESHES = {
    "1x2": (1, 2, [(label, "tp_only") for label, _, _ in CONFIGS]),
    "1x4": (1, 4, [(label, "fsdp_tp") for label, _, _ in CONFIGS]),
    "2x2": (2, 2, [("tinyllama-1.1b", "tp_only"), ("qwen2-moe-a2.7b", "tp_only"),
                   ("llama4-scout, 16 experts", "tp_only"), ("internvl2-26b", "ddp"),
                   ("llama4-scout, 16 experts", "ddp"), ("qwen2-moe-a2.7b", "fsdp_tp")]),
}
SERVE_CASES = [(mesh, label, scheme) for mesh, (_, _, cases) in MESHES.items()
               for label, scheme in cases]
# (label, arch, experts, dtype); meshes with their scheme (fsdp_tp only at data 1)
INIT_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", None, torch.float32),
              ("llama4-scout, 16 experts", "llama4-scout-17b-a16e", 16, torch.float32),
              ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", None, torch.bfloat16)]
INIT_MESHES = {"1x4": (1, 4, "fsdp_tp"), "2x2": (2, 2, "tp_only")}
CLI_ARGV = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--tokens", "4"]
CONFIG = {label: (arch, experts) for label, arch, experts in CONFIGS}


def _ref_config(arch, experts):
    import dataclasses

    cfg = ref_get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(cfg, n_experts=experts)


@functools.lru_cache(maxsize=None)
def _inputs(label):
    """The reference's weights (numpy tree), the prompt and the extra
    inputs of a configuration, from seeds."""
    arch, experts = CONFIG[label]
    cfg = _ref_config(arch, experts)
    tree = jax.tree.map(np.asarray, ref_lm.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    extras = {}
    if cfg.vision_tokens:
        extras["vision_embeds"] = (0.02 * rng.normal(
            size=(BATCH, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return tree, prompt, extras


@functools.lru_cache(maxsize=None)
def _reference(label):
    """The reference's prefill and greedy decode: every step's logits
    (1 + N_DECODE, B, vocab_padded) and the tokens fed (B, N_DECODE)."""
    arch, experts = CONFIG[label]
    cfg = _ref_config(arch, experts)
    tree, prompt, extras = _inputs(label)
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(ref_lm.make_prefill_step(cfg, max_len=PROMPT + N_DECODE))
    decode = jax.jit(ref_lm.make_serve_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt),
                                     **{k: jnp.asarray(v) for k, v in extras.items()}})
    seen, fed = [np.asarray(logits)], []
    for t in range(N_DECODE):
        tok = jnp.argmax(logits, axis=-1)[:, None]
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, jnp.int32(PROMPT + t))
        seen.append(np.asarray(logits))
    return np.stack(seen), np.concatenate(fed, axis=1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{mesh: every rank's result}, one spawn per mesh, on first use."""
    store = tmp_path_factory.mktemp("tp_store")

    @functools.lru_cache(maxsize=None)
    def run(mesh):
        data, model, cases = MESHES[mesh]
        args = [(label, *CONFIG[label], scheme, *_inputs(label)) for label, scheme in cases]
        return run_ranks(ranks.serve_cases, data * model, data, model, args, N_DECODE,
                         backend="gloo", timeout=SPAWN_TIMEOUT_S, store_dir=str(store))

    return run


@pytest.mark.parametrize("mesh,label,scheme", SERVE_CASES)
def test_sharded_serving_matches_reference(served, mesh, label, scheme):
    data, model, _ = MESHES[mesh]
    want_logits, want_tokens = _reference(label)
    rows = BATCH // data
    by_group = {}
    for res in served(mesh):
        d = res["coords"]["data"][0]
        got = res[(label, scheme)]
        lo = d * rows
        np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens[lo:lo + rows])
        err = np.abs(got["logits"].numpy() - want_logits[:, lo:lo + rows]).max()
        assert err <= LOGIT_ATOL, (mesh, label, err)
        if scheme != "ddp":
            assert got["train_graph"]
        first = by_group.setdefault(d, got["logits"])   # replicated over the model axis
        assert torch.equal(first, got["logits"])
    assert sorted(by_group) == list(range(data))


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp_init")
    return {mesh: run_ranks(ranks.init_cases, d * m, d, m,
                            [(label, arch, experts, scheme, dtype)
                             for label, arch, experts, dtype in INIT_CASES],
                            backend="gloo", timeout=SPAWN_TIMEOUT_S, store_dir=str(store))
            for mesh, (d, m, scheme) in INIT_MESHES.items()}


@pytest.mark.parametrize("mesh", sorted(INIT_MESHES))
@pytest.mark.parametrize("case", INIT_CASES, ids=lambda c: f"{c[0]}-{c[3]}")
def test_sharded_init_is_the_unsharded_init_cut(inits, mesh, case):
    label, arch, experts, dtype = case
    cfg = ranks.config(arch, experts)
    plan = sharding.plan_for(cfg, INIT_MESHES[mesh][2])
    full = dict(lm.init_params(cfg, seed=3, dtype=dtype, device="cpu").named_parameters())
    for res in inits[mesh]:
        got = res[label]
        assert got["shard_params_equal"]
        assert set(got["params"]) == set(full)
        for name, p in got["params"].items():
            want = sharding.local_slice(full[name], plan[name], res["coords"])
            assert p.dtype == want.dtype and torch.equal(p, want), name
    # each rank holds its slices, not the whole model (norms and the router
    # replicate)
    n_local = sum(p.numel() for p in inits[mesh][0][label]["params"].values())
    assert n_local < sum(p.numel() for p in full.values()) / 1.8


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_serve_cli_mesh_on_cpu(mesh, tmp_path):
    data, model = map(int, mesh.split("x"))
    out = run_ranks(ranks.cli, data * model, CLI_ARGV + ["--mesh", mesh], backend="gloo",
                    timeout=SPAWN_TIMEOUT_S, store_dir=str(tmp_path))
    want = serve.main(CLI_ARGV)["tokens"]
    rows = want.shape[0] // data
    for r, res in enumerate(out):
        d = r // model
        assert torch.equal(res["tokens"], want[d * rows:(d + 1) * rows]), (mesh, r)
