"""Port parity: the Mamba2, RWKV6, sliding-window and cross-attention blocks on a mesh.

zamba2-7b (Mamba2 blocks and the shared attention block after each
super-block), rwkv6-1.6b, gemma3-4b (local layers' ring caches) and
whisper-medium (encoder, cross attention) at ``reduced()`` size, served
and trained on gloo ranks in fresh processes
(``repro_torch.launch.mesh.run_ranks``) on meshes 1x2 (``tp_only``), 2x2
(``fsdp_tp``: FSDP over data, tensor parallelism over model) and 2x1
(``ddp``, rwkv6).  Each rank holds its shard of the reference's
``lm.init_params`` weights (``convert.lm_shard_from_numpy``; a Mamba2
``in_proj`` and ``conv_w`` by component, ``sharding.mamba_parts``) and its
rows of numpy-seeded inputs (``sharding.local_batch``).  Against the
reference, float32 both sides:

* serving: the prefill's and 4 greedy decode steps' logits within the LM
  tests' ``LOGIT_ATOL`` of ``make_prefill_step`` / ``make_serve_step``, the
  tokens equal, every rank of a data group bit-equal, and train mode's
  logits finite through a graph autograd recorded;
* training, at tests/test_torch_lm_train.py's limits: the loss within 1e-5
  relative; every gradient leaf, put together from the ranks' pieces,
  within 1e-4 of the leaf's max |g_ref|; the parameters after one AdamW
  step within 1e-5 and, with their v, inside the first step's windows
  (``first_step_windows``); every piece two ranks hold bit-equal,
  gradients and parameters (a replicated leaf a rank uses only in part,
  such as Mamba2's ``A_log`` or RWKV6's ``u``, must come out whole on
  every rank);
* ``init_params_sharded`` is the unsharded init cut, bit for bit;
* ``launch/train.py --mesh 2x2 --arch zamba2-7b`` gives ``--mesh 1x1``'s
  losses within 1e-5.

Two spawns serve the whole file, started at once in threads while the test
process computes the reference: two ranks (the 1x2 and 2x1 meshes, the
inits), four ranks (2x2, the CLI).
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import optim as port_optim
from repro_torch import sharding
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import train
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm

LOGIT_ATOL = 1e-4          # tests/test_torch_lm.py
LOSS_RTOL = 1e-5           # tests/test_torch_lm_train.py
GRAD_TOL = 1e-4            # of each leaf's max |g_ref|
PARAM_ATOL = 1e-5
ADAM_B1 = 0.9
N_DECODE = 4
SERVE_BATCH, PROMPT = 2, 12    # gemma3's reduced window is 8: the prompt rolls its rings
BATCH, SEQ = 4, 20             # zamba2's reduced SSD chunk is 8: the sequence is padded
SPAWN_TIMEOUT_S = 300.0
ARCHS = ("zamba2-7b", "rwkv6-1.6b", "gemma3-4b", "whisper-medium")
# mesh -> (data, model, [(arch, scheme)])
MESHES = {
    "1x2": (1, 2, [(arch, "tp_only") for arch in ARCHS]),
    "2x1": (2, 1, [("rwkv6-1.6b", "ddp")]),
    "2x2": (2, 2, [(arch, "fsdp_tp") for arch in ARCHS]),
}
# spawn -> (ranks, meshes it runs)
SPAWNS = {"pair": (2, ("1x2", "2x1")), "quad": (4, ("2x2",))}
CASES = [(mesh, arch, scheme) for mesh, (_, _, cases) in MESHES.items()
         for arch, scheme in cases]
CLI_ARGV = ["--reduced", "--device", "cpu", "--steps", "3", "--arch", "zamba2-7b"]


def _optimizer(m):
    return m.adamw(m.cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)


def _frames(cfg, rng, rows):
    return {"encoder_frames": (0.02 * rng.normal(size=(rows, cfg.encoder_seq, cfg.d_model))
                               ).astype(np.float32)} if cfg.is_enc_dec else {}


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """The reference's weights and AdamW init state (numpy trees), the
    serving prompt and its extra inputs, and the training batch, from
    seeds."""
    cfg = ref_get_config(arch).reduced()
    as_np = functools.partial(jax.tree.map, np.asarray)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(SERVE_BATCH, PROMPT)).astype(np.int32)
    extras = _frames(cfg, rng, SERVE_BATCH)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32),
             **_frames(cfg, rng, BATCH)}
    return {"tree": as_np(params), "state": as_np(_optimizer(ref_optim).init(params)),
            "prompt": prompt, "extras": extras, "batch": batch}


@functools.lru_cache(maxsize=None)
def _ref_serving(arch):
    """The reference's prefill and greedy decode: every step's logits
    (1 + N_DECODE, B, vocab_padded) and the tokens fed (B, N_DECODE)."""
    cfg = ref_get_config(arch).reduced()
    inp = _inputs(arch)
    params = jax.tree.map(jnp.asarray, inp["tree"])
    prefill = jax.jit(ref_lm.make_prefill_step(cfg, max_len=PROMPT + N_DECODE))
    decode = jax.jit(ref_lm.make_serve_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(inp["prompt"]),
                                     **{k: jnp.asarray(v) for k, v in inp["extras"].items()}})
    seen, fed = [np.asarray(logits)], []
    for t in range(N_DECODE):
        tok = jnp.argmax(logits, axis=-1)[:, None]
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, jnp.int32(PROMPT + t))
        seen.append(np.asarray(logits))
    return np.stack(seen), np.concatenate(fed, axis=1)


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    """The reference's jitted ``make_train_step`` from its init state:
    (loss, grads read back from the first moment, params)."""
    cfg = ref_get_config(arch).reduced()
    inp = _inputs(arch)
    step = ref_lm.make_train_step(cfg, _optimizer(ref_optim))
    params, state, metrics = jax.tree.map(np.asarray, jax.jit(step)(
        *jax.tree.map(jnp.asarray, (inp["tree"], inp["state"], inp["batch"]))))
    grads = jax.tree.map(lambda m: m / np.float32(1 - ADAM_B1), state["m"])
    return metrics["loss"], grads, params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in the test process, as in the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{spawn: every rank's job results}: both spawns start at once, in
    threads, while the test process computes the reference."""
    store = tmp_path_factory.mktemp("blocks_store")

    def calls(mesh):
        data, model, cases = MESHES[mesh]
        serve = [(arch, arch, None, scheme, _inputs(arch)["tree"], _inputs(arch)["prompt"],
                  _inputs(arch)["extras"]) for arch, scheme in cases]
        fit = [((arch, scheme, 1), arch, None, scheme, _inputs(arch)["tree"],
                _inputs(arch)["batch"], 1, _inputs(arch)["state"]) for arch, scheme in cases]
        return [("serve_cases", (data, model, serve, N_DECODE)),
                ("train_cases", (data, model, fit))]

    def run(spawn):
        n, meshes = SPAWNS[spawn]
        jobs = [job for mesh in meshes for job in calls(mesh)]
        if spawn == "pair":
            jobs.append(("init_cases", (1, 2, [(arch, arch, None, "tp_only", torch.float32)
                                               for arch in ARCHS])))
        else:
            jobs.append(("train_cli", (CLI_ARGV + ["--mesh", "2x2", "--backend", "gloo"],)))
        return run_ranks(ranks.jobs, n, jobs, backend="gloo", timeout=SPAWN_TIMEOUT_S,
                         store_dir=str(store))

    for arch in ARCHS:   # jax in this thread only
        _inputs(arch)
    with ThreadPoolExecutor(len(SPAWNS)) as pool:
        futures = {spawn: pool.submit(run, spawn) for spawn in SPAWNS}
        yield lambda spawn: futures[spawn].result()


def _results(spawned, mesh, job):
    """Every rank's result of ``mesh``'s ``job`` (0 serving, 1 training)."""
    spawn = next(k for k, (_, meshes) in SPAWNS.items() if mesh in meshes)
    return [res[2 * SPAWNS[spawn][1].index(mesh) + job] for res in spawned(spawn)]


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    """A port model of ``arch``: its parameter names and the reference's
    tree layout (its values are not read)."""
    return lm.init_params(ranks.config(arch), dtype=torch.float32, device="cpu")


def _check_tree(arch, got: dict, want, tol_rel=None, atol=None, what=""):
    got, want = _leaves(lm_params_to_numpy(_port_model(arch), got)), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if w.size == 0:
            continue
        err = np.abs(got[k] - w).max()
        limit = atol if atol is not None else tol_rel * np.abs(w).max()
        assert err <= limit, (what, k, err, limit)


@pytest.mark.parametrize("mesh,arch,scheme", CASES)
def test_sharded_serving_matches_reference(spawned, mesh, arch, scheme):
    want_logits, want_tokens = _ref_serving(arch)
    rows = SERVE_BATCH // MESHES[mesh][0]
    results = _results(spawned, mesh, 0)
    by_group = {}
    for res in results:
        got = res[(arch, scheme)]
        d = res["coords"]["data"][0]
        mine = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(got["logits"].numpy(), want_logits[:, mine], rtol=0,
                                   atol=LOGIT_ATOL)
        assert np.array_equal(got["tokens"].numpy(), want_tokens[mine])
        first = by_group.setdefault(d, got)   # replicated over the model axis
        assert torch.equal(got["logits"], first["logits"])
        if MESHES[mesh][1] > 1:
            assert got["train_graph"]


@pytest.mark.parametrize("mesh,arch,scheme", CASES)
def test_sharded_train_step_matches_reference(spawned, mesh, arch, scheme):
    cfg = ranks.config(arch)
    plan = sharding.plan_for(cfg, scheme)
    key = (arch, scheme, 1)
    results = _results(spawned, mesh, 1)
    loss, grads, params = _ref_step(arch)
    for res in results:
        got = res[key]
        assert torch.equal(got["loss"], results[0][key]["loss"])
        assert abs(float(got["loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert abs(float(got["step_loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert int(got["step"]) == 1
    g, g_same = ranks.assemble(cfg, plan, results, key, "grads")
    p, p_same = ranks.assemble(cfg, plan, results, key, "params")
    assert g_same and p_same   # every piece two ranks hold: bit for bit
    _check_tree(arch, g, grads, tol_rel=GRAD_TOL, what="gradient")
    _check_tree(arch, p, params, atol=PARAM_ATOL, what="parameter")
    v, v_same = ranks.assemble(cfg, plan, results, key, "v")
    assert v_same
    start = {k: torch.tensor(x) for k, x in _leaves(_inputs(arch)["tree"]).items() if x.size}
    want = {k: torch.tensor(x) for k, x in _leaves(grads).items() if x.size}
    windows = ranks.first_step_windows(
        _optimizer(port_optim), start, want,
        {k: GRAD_TOL * float(x.abs().max()) for k, x in want.items()})
    for what, tree in (("p", p), ("v", v)):
        got = _leaves(lm_params_to_numpy(_port_model(arch), tree))
        for k, w in windows.items():
            assert ranks.outside(torch.from_numpy(got[k]), w[what]) == 0.0, (what, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_is_the_unsharded_init_cut(spawned, arch):
    cfg = ranks.config(arch)
    plan = sharding.plan_for(cfg, "tp_only")
    full = dict(lm.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
                .named_parameters())
    for res in spawned("pair"):
        got = res[-1][arch]
        assert got["shard_params_equal"] and set(got["params"]) == set(full)
        for name, piece in got["params"].items():
            want = sharding.local_slice(full[name], plan[name], res[-1]["coords"],
                                        sharding.mamba_parts(cfg, name))
            assert torch.equal(piece, want), name


def test_train_cli_mesh_on_cpu(spawned):
    got = [res[-1] for res in spawned("quad")]
    want = train.main(CLI_ARGV)
    for losses in got:
        assert losses == got[0]
        np.testing.assert_allclose(losses, want, rtol=1e-5)
