"""Port parity: attention whose KV heads are fewer than the model axis's ranks.

``sharding.attn_heads`` gives each rank of a model axis of m its heads.
Where the KV heads divide over the axis, a rank holds Hkv / m of them with
their query heads; where m divides by Hkv, R = m / Hkv consecutive ranks
(a replica group) share one KV head, each holding it whole, and split its
G = Hq / Hkv query heads as ``torch.tensor_split`` does (a rank may hold
none); anything else is refused.

* The rule for all ten configurations at m = 2, 4, 8 and 16: every query
  head held once, every KV head by R ranks, each rank's query heads
  reading its own KV head; refusals where neither count divides the other.
* One ``run_ranks`` spawn of four gloo CPU ranks, at ``reduced()`` size
  with the heads changed, each rank holding its shard of the reference's
  ``lm.init_params`` weights (``convert.lm_shard_from_numpy``):
  llama3.2-3b with 6 query / 2 KV heads over 1x4 ``tp_only`` (query heads
  2 / 1 a rank, KV heads shared by pairs) serves and trains; with 2 / 1
  heads over 1x4 (two ranks with no query head) serves; tinyllama-1.1b
  with 4 / 1 heads over 2x2 ``fsdp_tp`` (a KV head shared by the two model
  ranks under FSDP) trains.  Serving: prefill and greedy decode against
  the reference's ``make_prefill_step`` / ``make_serve_step`` (logits
  within 1e-4, tokens equal).  Training: against the reference's jitted
  ``make_train_step`` at tests/test_torch_sharded_train.py's limits, every
  piece two ranks hold bit-equal after the AdamW step, the KV replicas
  included.
* The 1x4 state after the step saved by ``ckpt.save_sharded``: the file
  equals the reference's ``repro.ckpt.save`` of the whole state the pieces
  make, and restores at 1x2 and 1x1 bit for bit.
* ``launch/step_costs.py`` on ``meta``: over the model ranks the counted
  matmul FLOPs sum to the unsharded count plus the replicas' K and V
  projections, reckoned by hand, the kernels' to the unsharded count; a
  rank with no query head launches no flash kernel
  (``lm.attention_calls``).  The replica group's collectives against gloo
  ranks are in tests/test_torch_step_costs.py.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shared_kv_ranks as kv_ranks
import _torch_tp_ranks as ranks
from repro import ckpt as ref_ckpt
from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import optim as port_optim
from repro_torch import sharding
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import step_costs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm

LOGIT_ATOL = 1e-4
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5   # tests/test_torch_sharded_train.py
ADAM_B1 = 0.9
N_DECODE = 6
SERVE_BATCH, PROMPT = 2, 12
TRAIN_BATCH, SEQ = 4, 20
SPAWN_TIMEOUT_S = 300.0
# label -> (arch, (query heads, KV heads))
CONFIGS = {"6/2": ("llama3.2-3b", (6, 2)), "2/1": ("llama3.2-3b", (2, 1)),
           "4/1": ("tinyllama-1.1b", (4, 1))}
SERVE = ["6/2", "2/1"]                        # over 1x4 tp_only
TRAIN = {"6/2": (1, 4, "tp_only"), "4/1": (2, 2, "fsdp_tp")}


def _ref_config(label):
    arch, (n_heads, n_kv) = CONFIGS[label]
    return dataclasses.replace(ref_get_config(arch).reduced(), n_heads=n_heads, n_kv_heads=n_kv)


def _config(label):
    return kv_ranks.config(*CONFIGS[label])


def _ref_optimizer(m):
    return m.adamw(m.cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_attn_heads_cover_every_head(arch, m):
    cfg = get_config(arch)
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    if Hkv % m and m % Hkv:
        with pytest.raises(ValueError, match="neither divides"):
            sharding.attn_heads(cfg, m, 0)
        with pytest.raises(ValueError, match="neither divides"):
            sharding.check_plan(cfg, sharding.plan_for(cfg, "tp_only"), {"model": m})
        return
    R = sharding.kv_replicas(cfg, m)
    assert R == (m // Hkv if m > Hkv else 1)
    q_held, kv_held = [0] * Hq, [0] * Hkv
    counts = []
    for i in range(m):
        (q0, nq), (k0, nk) = sharding.attn_heads(cfg, m, i)
        counts.append(nq)
        for h in range(q0, q0 + nq):
            q_held[h] += 1
            assert k0 <= h // G < k0 + nk   # reads a KV head the rank holds
        for j in range(k0, k0 + nk):
            kv_held[j] += 1
        assert nk == max(1, Hkv // m)
    assert q_held == [1] * Hq and kv_held == [R] * Hkv
    # within a replica group the query heads go as tensor_split cuts them
    for g in range(0, m, R):
        assert counts[g:g + R] == [len(c) for c in torch.arange(G * max(1, Hkv // m))
                                   .tensor_split(R)]
    if not any(n % m for what, n in sharding.head_counts(cfg)
               if what not in ("query heads", "KV heads")):
        assert sharding.check_plan(cfg, sharding.plan_for(cfg, "tp_only"), {"model": m})


# ---------------------------------------------------------------------------
# Gloo ranks against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inputs(label):
    """The reference's weights and AdamW init state (numpy trees), a prompt
    and a training batch, from seeds."""
    cfg = _ref_config(label)
    as_np = functools.partial(jax.tree.map, np.asarray)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(SERVE_BATCH, PROMPT)).astype(np.int32)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(TRAIN_BATCH, SEQ)).astype(np.int32)}
    return as_np(params), as_np(_ref_optimizer(ref_optim).init(params)), prompt, batch


@functools.lru_cache(maxsize=None)
def _ref_serve(label):
    cfg = _ref_config(label)
    tree, _, prompt, _ = _inputs(label)
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(ref_lm.make_prefill_step(cfg, max_len=PROMPT + N_DECODE))
    decode = jax.jit(ref_lm.make_serve_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
    seen, fed = [np.asarray(logits)], []
    for t in range(N_DECODE):
        tok = jnp.argmax(logits, axis=-1)[:, None]
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, jnp.int32(PROMPT + t))
        seen.append(np.asarray(logits))
    return np.stack(seen), np.concatenate(fed, axis=1)


@functools.lru_cache(maxsize=None)
def _ref_train(label):
    """The reference's jitted step: (loss, grads read back from the first
    moment, params, state)."""
    cfg = _ref_config(label)
    params, state, _, batch = _inputs(label)
    step = ref_lm.make_train_step(cfg, _ref_optimizer(ref_optim))
    params, state, metrics = jax.tree.map(np.asarray, jax.jit(step)(
        *jax.tree.map(jnp.asarray, (params, state, batch))))
    grads = jax.tree.map(lambda m: m / np.float32(1 - ADAM_B1), state["m"])
    return metrics["loss"], grads, params, state


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's result of the one spawn, started in a thread while the
    test process computes the reference."""
    store = tmp_path_factory.mktemp("shared_kv")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def train_case(label):
        params, state, _, batch = _inputs(label)
        arch, heads = CONFIGS[label]
        return (label, arch, heads, TRAIN[label][2], params, batch, state)

    serve = [(label, *CONFIGS[label], "tp_only", _inputs(label)[0], _inputs(label)[2])
             for label in SERVE]
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, kv_ranks.shared_kv_rank, 4, str(store), serve,
                             train_case("6/2"), train_case("4/1"), N_DECODE, backend="gloo",
                             timeout=SPAWN_TIMEOUT_S, store_dir=str(store))
        for label in SERVE:
            _ref_serve(label)
        for label in TRAIN:
            _ref_train(label)
        yield {"store": store, "ranks": future.result()}
    torch.set_num_threads(threads)


@pytest.mark.parametrize("label", SERVE)
def test_serving_matches_reference(spawned, label):
    cfg = _config(label)
    want_logits, want_tokens = _ref_serve(label)
    results = spawned["ranks"]
    for res in results:
        got = res[("serve", label)]
        i = res["coords"]["model"][0]
        (_, n_q), (_, n_kv) = sharding.attn_heads(cfg, 4, i)
        assert got["heads"] == (n_q, n_kv) and got["cache_heads"] == n_kv == 1
        np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
        np.testing.assert_allclose(got["logits"].numpy(), want_logits, rtol=0, atol=LOGIT_ATOL)
        assert torch.equal(got["logits"], results[0][("serve", label)]["logits"])
    heads = [res[("serve", label)]["heads"][0] for res in results]
    assert heads == {"6/2": [2, 1, 2, 1], "2/1": [1, 1, 0, 0]}[label]


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_tree(model, got: dict, want, tol_rel=None, atol=None, what=""):
    got, want = _leaves(lm_params_to_numpy(model, got)), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if w.size == 0:
            continue
        err = np.abs(got[k] - w).max()
        limit = atol if atol is not None else tol_rel * np.abs(w).max()
        assert err <= limit, (what, k, err, limit)


def _results(spawned, label):
    """Each rank's result of ``label``'s training with its coordinates on
    that case's mesh."""
    coords = "coords" if TRAIN[label][:2] == (1, 4) else "coords_2x2"
    return [{"coords": res[coords], label: res[("train", label)]} for res in spawned["ranks"]]


@pytest.mark.parametrize("label", list(TRAIN))
def test_train_step_matches_reference(spawned, label):
    cfg = _config(label)
    plan = sharding.plan_for(cfg, TRAIN[label][2])
    results = _results(spawned, label)
    loss, grads, params, state = _ref_train(label)
    for res in results:
        got = res[label]
        assert torch.equal(got["loss"], results[0][label]["loss"])
        assert abs(float(got["loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert abs(float(got["step_loss"]) - float(loss)) <= LOSS_RTOL * abs(float(loss))
        assert int(got["step"]) == 1
    model = lm.init_params(cfg, dtype=torch.float32, device="cpu")
    g, g_same = ranks.assemble(cfg, plan, results, label, "grads")
    p, p_same = ranks.assemble(cfg, plan, results, label, "params")
    assert g_same and p_same   # every piece two ranks hold, KV replicas too: bit for bit
    _check_tree(model, g, grads, tol_rel=GRAD_TOL, what="gradient")
    _check_tree(model, p, params, atol=PARAM_ATOL, what="parameter")
    moments = {}
    for moment in ("m", "v"):
        whole, same = ranks.assemble(cfg, plan, results, label, moment)
        assert same
        _check_tree(model, whole, state[moment], tol_rel=GRAD_TOL, what=moment)
        moments[moment] = whole
    start = {k: torch.tensor(v) for k, v in _leaves(_inputs(label)[0]).items() if v.size}
    want = {k: torch.tensor(v) for k, v in _leaves(grads).items() if v.size}
    windows = ranks.first_step_windows(
        _ref_optimizer(port_optim), start, want,
        {k: GRAD_TOL * float(t.abs().max()) for k, t in want.items()})
    for what, tree in (("p", p), ("v", moments["v"])):
        got = _leaves(lm_params_to_numpy(model, tree))
        for k, w in windows.items():
            assert ranks.outside(torch.from_numpy(got[k]), w[what]) == 0.0, (what, k)


@pytest.mark.parametrize("label", list(TRAIN))
def test_kv_replicas_bit_equal_after_the_step(spawned, label):
    """The two ranks of each replica group hold the same k and v columns,
    gradients and AdamW moments, bit for bit, and they moved."""
    cfg = _config(label)
    data, m, _ = TRAIN[label]
    R = sharding.kv_replicas(cfg, m)
    assert R == 2
    by_at = {}
    for res in _results(spawned, label):
        c = res["coords"]
        group = (c["data"][0], c["model"][0] // R)
        by_at.setdefault(group, []).append(res[label])
    assert len(by_at) == data * m // R
    start = dict(lm.init_params(cfg, dtype=torch.float32, device="meta").named_parameters())
    names = [n for n in start if n.rsplit(".", 1)[-1] in ("k", "v")]
    assert names
    for members in by_at.values():
        first, other = members
        for n in names:
            for what in ("params", "grads", "m", "v"):
                assert torch.equal(first[what][n], other[what][n]), (what, n)
            assert first["grads"][n].abs().max() > 0, n


def _ref_file_of(spawned, label) -> dict:
    """The whole state the 1x4 ranks' pieces make, as the reference's tree."""
    cfg = _config(label)
    plan = sharding.plan_for(cfg, "tp_only")
    results = _results(spawned, label)
    model = lm.init_params(cfg, dtype=torch.float32, device="cpu")
    whole = {what: ranks.assemble(cfg, plan, results, label, what)[0]
             for what in ("params", "m", "v")}
    state = dict(_inputs(label)[1])
    state.update(step=np.asarray(results[0][label]["step"].numpy()),
                 m=lm_params_to_numpy(model, whole["m"]), v=lm_params_to_numpy(model, whole["v"]))
    return {"params": lm_params_to_numpy(model, whole["params"]), "opt_state": state}, whole


def test_checkpoint_is_the_reference_file_and_restores_on_smaller_meshes(spawned):
    label = "6/2"
    cfg = _config(label)
    store = spawned["store"]
    tree, whole = _ref_file_of(spawned, label)
    ref_ckpt.save(store / "ref_same", tree, step=1, config={"arch": CONFIGS[label][0]})
    got, want = (np.load(store / d / "arrays.npz") for d in ("ckpt_1x4", "ref_same"))
    assert list(got.files) == list(want.files)
    for key in want.files:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    plan = sharding.plan_for(cfg, "tp_only")
    one = spawned["ranks"][0]["restored_1x1"]
    for what in ("params", "m", "v"):
        for name, t in whole[what].items():
            assert torch.equal(one[what][name], t), (what, name)
    for res in spawned["ranks"][:2]:
        got = res["restored_1x2"]
        assert got["step"] == 1
        for what in ("params", "m", "v"):
            for name, t in whole[what].items():
                piece = sharding.local_slice(t, plan[name], got["coords"],
                                             sharding.model_parts(cfg, name))
                assert torch.equal(got[what][name], piece), (what, name)


# ---------------------------------------------------------------------------
# The dry run's count
# ---------------------------------------------------------------------------


def _count(label, kind, m, i):
    cfg = _config(label)
    return step_costs.count_step(cfg, InputShape(kind, SEQ, 2, kind), {"data": 1, "model": m},
                                 "tp_only", {"model": i}, compute_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_counted_flops_over_the_model_ranks(kind):
    """Summed over the four model ranks of 6 / 2 heads, the counted matmul
    FLOPs are the unsharded count plus the K and V projections each KV
    head's second replica repeats (forward, and in training the remat
    forward and the two backward products); the kernels' FLOPs are the
    unsharded count (the query heads split)."""
    label = "6/2"
    cfg = _config(label)
    one = _count(label, kind, 1, 0)
    ranks4 = [_count(label, kind, 4, i) for i in range(4)]
    R = sharding.kv_replicas(cfg, 4)
    projection = 2.0 * 2 * SEQ * cfg.d_model * cfg.n_kv_heads * cfg.resolved_head_dim
    passes = 1 if kind == "prefill" else (2 if cfg.remat else 1) + 2
    extra = (R - 1) * cfg.n_layers * 2 * projection * passes   # k and v
    assert sum(r["matmul_flops"] for r in ranks4) == one["matmul_flops"] + extra
    assert sum(r["kernel_flops"] for r in ranks4) == pytest.approx(one["kernel_flops"],
                                                                   rel=1e-12)
    kv = [c for c in ranks4[0]["collective_log"] if c["axis"] == "kv_replicas"]
    assert len(kv) == (2 * cfg.n_layers if kind == "train" else 0)
    assert all(c["kind"] == "all-reduce" and c["group"] == R for c in kv)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_rank_without_query_heads_launches_nothing(kind):
    label = "2/1"
    cfg = _config(label)
    prefill = kind != "decode"
    for i in range(4):
        counted = step_costs.launches(_count(label, kind, 4, i))
        want = (lm.train_step_launches(cfg, (4, i)) if kind == "train"
                else {k: n for k, n in {"flash_attention":
                                        lm.attention_calls(cfg, prefill, (4, i))}.items() if n})
        assert counted == want, (kind, i)
        assert bool(counted) == (i < 2)
