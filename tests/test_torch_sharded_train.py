"""Port parity: the LM train step on a device mesh, against the reference.

The attention + MLP / MoE families at ``reduced()`` size (tinyllama-1.1b,
granite-8b, qwen2-moe-a2.7b with its experts split by F, internvl2-26b
with its vision embeddings split by rows, and llama4-scout with its 16
experts kept, so they go over the model axis: expert parallelism) train on
gloo ranks in fresh processes (``repro_torch.launch.mesh.run_ranks``) on
meshes 1x2 (``tp_only``), 2x1 (``ddp``) and
2x2 (``fsdp_tp``: FSDP and tensor parallelism together; ``tp_only`` on
qwen2-moe, whose Switch loss reads its statistics over the data axis).
Each rank holds its shard of the reference's ``lm.init_params`` weights
(``convert.lm_shard_from_numpy``) and its rows of a numpy-seeded batch
(``sharding.local_batch``), and takes ``lm.value_and_grad`` and one
``make_train_step`` of the LM tests' ``adamw_cosine``, its AdamW state the
reference's cut by ``convert.opt_state_shard_from_numpy``.  Against the
reference's jitted ``make_train_step`` on the whole batch (its
``jax.value_and_grad(lm_loss)``: the loss it reports, the gradients read
back from its first moment), float32 both sides, at
tests/test_torch_lm_train.py's limits:

* the loss within 1e-5 relative, the same on every rank;
* every gradient leaf, put together from the ranks' pieces, within 1e-4 of
  that leaf's max |g_ref|;
* the parameters after the step within 1e-5 (absolute), AdamW's m and v
  within 1e-4 of their leaf's max; and each parameter, and its v, inside
  the window that one AdamW step from zero moments allows a gradient
  within 1e-4 of the reference's (``first_step_windows``: far narrower
  than 1e-5, which is 2 lr, wherever the gradient's sign is settled);
* every piece that two ranks both hold (a replicated leaf, a model slice
  on each data group) bit-equal on those ranks, gradients and parameters.

``microbatches=2`` on a dense and a MoE case at 2x2: each rank takes its
piece of the reference's microbatches, so the MoE blocks' Switch loss
reads each microbatch's whole rows.  Also ``launch/train.py --mesh 2x2``
on gloo ranks gives ``--mesh 1x1``'s losses within 1e-5, and
``MeshAxis``' collectives (its FSDP gather and reduce-scatter,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` over gloo and
NCCL alike) put pieces together and sum gradients as their autograd rules
say.

Two spawns serve the whole file (a rank process takes seconds to start):
two ranks take the 1x2 mesh's cases and then the 2x1 mesh's, four ranks
the 2x2 mesh's, the collectives and the CLI; both start at once, in
threads, while the test process computes the reference.
"""
import dataclasses
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

LOSS_RTOL = 1e-5           # tests/test_torch_lm_train.py
GRAD_TOL = 1e-4            # of each leaf's max |g_ref|
PARAM_ATOL = 1e-5
ADAM_B1 = 0.9              # the reference's and the port's AdamW default
BATCH, SEQ = 4, 20
SPAWN_TIMEOUT_S = 300.0
# label -> (arch, experts kept or None for reduced()'s)
CONFIGS = {"tinyllama": ("tinyllama-1.1b", None), "granite": ("granite-8b", None),
           "qwen2-moe": ("qwen2-moe-a2.7b", None), "internvl2": ("internvl2-26b", None),
           "llama4-scout, 16 experts": ("llama4-scout-17b-a16e", 16)}
ALL = list(CONFIGS)
# mesh -> (data, model, [(config label, scheme, microbatches)])
MESHES = {
    "1x2": (1, 2, [(label, "tp_only", 1) for label in ALL]),
    "2x1": (2, 1, [(label, "ddp", 1) for label in ("tinyllama", "qwen2-moe", "internvl2")]),
    "2x2": (2, 2, [(label, "fsdp_tp", 1) for label in ALL]
            + [("tinyllama", "fsdp_tp", 2), ("qwen2-moe", "fsdp_tp", 2)]
            + [("qwen2-moe", "tp_only", 1)]),
}
# spawn -> (ranks, meshes it trains): each mesh's world is the spawn's
SPAWNS = {"pair": (2, ("1x2", "2x1")), "quad": (4, ("2x2",))}
CASES = [(mesh, *case) for mesh, (_, _, cases) in MESHES.items() for case in cases]
CLI_ARGV = ["--reduced", "--device", "cpu", "--steps", "3", "--arch", "qwen2-moe-a2.7b"]


def _ref_config(label):
    arch, experts = CONFIGS[label]
    cfg = ref_get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(cfg, n_experts=experts)


def _optimizer(m):
    return m.adamw(m.cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)


@functools.lru_cache(maxsize=None)
def _inputs(label):
    """The reference's weights and AdamW init state (numpy trees) and the
    batch, from seeds."""
    cfg = _ref_config(label)
    as_np = functools.partial(jax.tree.map, np.asarray)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = (0.02 * rng.normal(
            size=(BATCH, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return as_np(params), as_np(_optimizer(ref_optim).init(params)), batch


@functools.lru_cache(maxsize=None)
def _reference(label, microbatches):
    """The reference's jitted ``make_train_step`` from its init state:
    (loss, grads, params, state).  The step takes ``jax.value_and_grad``
    of ``lm_loss`` (over each microbatch, averaged); its loss is that
    value, and its gradients are read back from the first moment, which
    from zero moments is (1 - b1) g (within an ulp of g).  One trace of the
    model a case: the test process's compile time is most of this file's."""
    cfg = _ref_config(label)
    params, state, batch = _inputs(label)
    step = ref_lm.make_train_step(cfg, _optimizer(ref_optim), microbatches=microbatches)
    params, state, metrics = jax.tree.map(np.asarray, jax.jit(step)(
        *jax.tree.map(jnp.asarray, (params, state, batch))))
    grads = jax.tree.map(lambda m: m / np.float32(1 - ADAM_B1), state["m"])
    return metrics["loss"], grads, params, state


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in the test process, as in the ranks: its
    tensors are small, and a thread pool's spinning costs more CPU than it
    saves where the ranks and other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{spawn: every rank's job results}: the two spawns start at once, in
    threads, while the test process computes the reference."""
    store = tmp_path_factory.mktemp("train_store")

    def cases(mesh):
        data, model, cases = MESHES[mesh]
        return ("train_cases", (data, model, [
            ((label, scheme, mb), *CONFIGS[label], scheme, params, batch, mb, state)
            for label, scheme, mb in cases for params, state, batch in [_inputs(label)]]))

    def run(spawn):
        n, meshes = SPAWNS[spawn]
        calls = [cases(mesh) for mesh in meshes]
        if spawn == "quad":
            calls += [("collectives_case", ()),
                      ("train_cli", (CLI_ARGV + ["--mesh", "2x2", "--backend", "gloo"],))]
        return run_ranks(ranks.jobs, n, calls, backend="gloo", timeout=SPAWN_TIMEOUT_S,
                         store_dir=str(store))

    for label in CONFIGS:   # jax in this thread only
        _inputs(label)
    with ThreadPoolExecutor(len(SPAWNS)) as pool:
        futures = {spawn: pool.submit(run, spawn) for spawn in SPAWNS}
        yield lambda spawn: futures[spawn].result()


@pytest.fixture(scope="module")
def trained(spawned):
    """{mesh: every rank's ``train_cases`` result}."""
    def get(mesh):
        spawn = next(k for k, (_, meshes) in SPAWNS.items() if mesh in meshes)
        return [res[SPAWNS[spawn][1].index(mesh)] for res in spawned(spawn)]
    return get


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _port_model(label):
    """A port model of ``label``'s configuration: its parameter names and
    the reference's tree layout (its values are not read)."""
    return lm.init_params(ranks.config(*CONFIGS[label]), dtype=torch.float32, device="cpu")


def _check_tree(label, got: dict, want, tol_rel=None, atol=None, what=""):
    got, want = _leaves(lm_params_to_numpy(_port_model(label), got)), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if w.size == 0:
            continue
        err = np.abs(got[k] - w).max()
        limit = atol if atol is not None else tol_rel * np.abs(w).max()
        assert err <= limit, (what, k, err, limit)


@pytest.mark.parametrize("mesh,label,scheme,microbatches", CASES)
def test_sharded_train_step_matches_reference(trained, mesh, label, scheme, microbatches):
    cfg = ranks.config(*CONFIGS[label])
    plan = sharding.plan_for(cfg, scheme)
    key = (label, scheme, microbatches)
    results = trained(mesh)
    loss, grads, params, state = _reference(label, microbatches)
    for res in results:
        got = res[key]
        assert torch.equal(got["loss"], results[0][key]["loss"])
        assert abs(float(got["loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert abs(float(got["step_loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert int(got["step"]) == 1
    g, g_same = ranks.assemble(cfg, plan, results, key, "grads")
    p, p_same = ranks.assemble(cfg, plan, results, key, "params")
    assert g_same and p_same   # every piece two ranks hold: bit for bit
    _check_tree(label, g, grads, tol_rel=GRAD_TOL, what="gradient")
    _check_tree(label, p, params, atol=PARAM_ATOL, what="parameter")
    moments = {}
    for moment in ("m", "v"):
        whole, same = ranks.assemble(cfg, plan, results, key, moment)
        assert same
        _check_tree(label, whole, state[moment], tol_rel=GRAD_TOL, what=moment)
        moments[moment] = whole
    # the step itself: each parameter and its v inside the window that one
    # AdamW step from zero moments allows a gradient within GRAD_TOL of the
    # reference's (1e-5 alone is 2 lr: a rank that did not step passes it)
    start = {k: torch.tensor(v) for k, v in _leaves(_inputs(label)[0]).items() if v.size}
    want = {k: torch.tensor(v) for k, v in _leaves(grads).items() if v.size}
    windows = ranks.first_step_windows(
        _optimizer(port_optim), start, want,
        {k: GRAD_TOL * float(g.abs().max()) for k, g in want.items()})
    for what, tree in (("p", p), ("v", moments["v"])):
        got = _leaves(lm_params_to_numpy(_port_model(label), tree))
        for k, w in windows.items():
            assert ranks.outside(torch.from_numpy(got[k]), w[what]) == 0.0, (what, k)


def test_train_cli_mesh_on_cpu(spawned):
    got = [res[-1] for res in spawned("quad")]
    want = train.main(CLI_ARGV)
    for losses in got:
        assert losses == got[0]
        np.testing.assert_allclose(losses, want, rtol=1e-5)


@pytest.mark.parametrize("dim", [0, 1])
def test_mesh_axis_collectives(spawned, dim):
    """``MeshAxis`` over four gloo ranks: a gather along ``dim`` puts the
    pieces together in rank order and its backward sums the gradient and
    keeps the rank's piece; ``copy`` sums the gradient, ``reduce`` the
    value, ``sum`` both."""
    ranks.check_collectives([res[-2] for res in spawned("quad")], dim)
