"""The port's federated-learning loop on the CPU, held against the JAX reference.

Inputs are made with numpy from a seed and go through both packages; the
port runs with ``device="cpu"`` (its proximity through the measure core).

* data and partitions: bitwise (``np.array_equal``), every field;
* models: reference params carried across by
  ``convert.cnn_params_from_numpy``; logits within 1e-5 of max|logits|,
  ``ce_loss`` gradients within 1e-4 of max|grad|;
* one local update (3 clients, 5 steps) fed the **reference's own index
  draws** (``ref_draws`` replays ``client.py``'s ``jax.random`` calls):
  parameters within 1e-4 of max|param|; the vmapped ResNet-9 update equal
  to its per-client runs;
* LG-FedAvg's global tensors and bytes, the launcher's JSON summary.

The strategies' parity lives in ``tests/test_torch_fl_strategies.py``.
"""
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import np_tree, ref_draws, rel_err, trainable
from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.data import DriftGenerator as RefDriftGenerator
from repro.data import DriftSpec as RefDriftSpec
from repro.data import make_dataset as ref_make_dataset
from repro.fl import FLConfig as RefFLConfig
from repro.fl import dirichlet_skew as ref_dirichlet_skew
from repro.fl import iid_split as ref_iid_split
from repro.fl import label_skew as ref_label_skew
from repro.fl import mix_datasets as ref_mix_datasets
from repro.fl import client as ref_client
from repro.fl import strategies as ref_strategies
from repro.launch import fl_train as ref_fl_train
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.data import DATASET_NAMES, DriftGenerator, DriftSpec, make_dataset
from repro_torch.fl import (
    ClientData, FLConfig, dirichlet_skew, iid_split, label_skew, mix_datasets,
    run_federation,
)
from repro_torch.fl import client as fl_client
from repro_torch.fl import strategies
from repro_torch.fl.client import stack_clients
from repro_torch.launch import fl_train
from repro_torch.models.cnn import MLP, LeNet5, ResNet9, build_model

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-5     # of max|logits|
GRAD_TOL = 1e-4      # of max|grad|
PARAM_TOL = 1e-4     # of max|param|
ALL_DATASETS = tuple(DATASET_NAMES) + ("cifar100s",)


# ---------------------------------------------------------------------------
# data and partitions: bitwise
# ---------------------------------------------------------------------------


def _assert_clients_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in ("x_train", "y_train", "x_test", "y_test"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert a.dataset_name == b.dataset_name
        assert a.meta.keys() == b.meta.keys()
        for k in a.meta:
            assert np.array_equal(a.meta[k], b.meta[k]), k


@pytest.mark.parametrize("name", ALL_DATASETS)
def test_make_dataset_bitwise(name):
    kw = dict(n_train=300, n_test=100, dim=64, seed=3)
    a, b = make_dataset(name, **kw), ref_make_dataset(name, **kw)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.name, a.n_classes) == (b.name, b.n_classes)


@pytest.mark.parametrize("kind", ["covariate", "label"])
def test_drift_generator_bitwise(kind):
    ds = make_dataset("cifar10s", n_train=200, n_test=50, dim=32, seed=0)
    spec = dict(kind=kind, angle_per_round_deg=7.0, rank=3, label_gamma=0.4, seed=5)
    port = DriftGenerator(DriftSpec(**spec), 32)
    ref = RefDriftGenerator(RefDriftSpec(**spec), 32)
    for rnd in (0, 1, 4):
        (x1, y1), (x2, y2) = (g.apply("client7", rnd, ds.x_train, ds.y_train)
                              for g in (port, ref))
        assert np.array_equal(x1, x2) and np.array_equal(y1, y2)


@pytest.fixture(scope="module")
def ds():
    return make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)


@pytest.fixture(scope="module")
def ref_ds():
    return ref_make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)


@pytest.mark.parametrize("case", [
    "label_skew", "label_skew_small_fed", "dirichlet", "iid", "mix",
])
def test_partitions_bitwise(case, ds, ref_ds):
    """The partitioners at the seeds ``tests/test_fl.py`` uses."""
    if case == "label_skew":
        port, ref = (f(d, 10, rho=0.2, seed=0) for f, d in
                     ((label_skew, ds), (ref_label_skew, ref_ds)))
    elif case == "label_skew_small_fed":
        port, ref = (f(d, 12, rho=0.2, seed=1, test_per_client=80) for f, d in
                     ((label_skew, ds), (ref_label_skew, ref_ds)))
    elif case == "dirichlet":
        port, ref = (f(d, 8, alpha=0.1, seed=0) for f, d in
                     ((dirichlet_skew, ds), (ref_dirichlet_skew, ref_ds)))
    elif case == "iid":
        port, ref = iid_split(ds, 5), ref_iid_split(ref_ds, 5)
    else:
        kw = dict(n_train=600, n_test=200, dim=64)
        port = mix_datasets([make_dataset("cifar10s", **kw), make_dataset("fmnists", **kw)],
                            [3, 2], samples_per_client=100)
        ref = ref_mix_datasets([ref_make_dataset("cifar10s", **kw),
                                ref_make_dataset("fmnists", **kw)],
                               [3, 2], samples_per_client=100)
    _assert_clients_equal(port, ref)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_init(arch, in_hw=16):
    """Reference params of ``_model_case`` (jitted: the reference's
    un-jitted ResNet-9 init takes seconds on the CPU)."""
    key = jax.random.PRNGKey({"mlp": 0, "lenet5": in_hw, "resnet9": 3}[arch])
    if arch == "mlp":
        return ref_cnn.init_mlp_clf(key, 48, 7, hidden=(32, 16))
    if arch == "lenet5":
        return ref_cnn.init_lenet5(key, in_hw=(in_hw, in_hw), n_classes=40)
    return jax.jit(partial(ref_cnn.init_resnet9, n_classes=10))(key)


def _model_case(arch, in_hw=16):
    """(reference params, jitted reference apply, port module, input dim)."""
    hw = (in_hw, in_hw)
    if arch == "mlp":
        return _ref_init(arch), jax.jit(ref_cnn.mlp_clf_apply), MLP(48, 7, hidden=(32, 16)), 48
    if arch == "lenet5":
        return (_ref_init(arch, in_hw), jax.jit(partial(ref_cnn.lenet5_apply, in_hw=hw)),
                LeNet5(in_hw=hw, n_classes=40), 3 * in_hw * in_hw)
    return (_ref_init(arch, in_hw), jax.jit(partial(ref_cnn.resnet9_apply, in_hw=hw)),
            ResNet9(in_hw=hw, n_classes=10), 3 * in_hw * in_hw)


MODEL_CASES = [("mlp", 16), ("lenet5", 16), ("lenet5", 32), ("resnet9", 16)]


@pytest.mark.parametrize("arch,in_hw", MODEL_CASES)
def test_logits_match_reference(arch, in_hw):
    ref_p, ref_apply, model, d = _model_case(arch, in_hw)
    x = np.random.default_rng(1).standard_normal((6, d)).astype(np.float32)
    want = np.asarray(ref_apply(ref_p, jnp.asarray(x)))
    params = convert.cnn_params_from_numpy(arch, np_tree(ref_p), model=model, device="cpu")
    got = torch.func.functional_call(model, params, (torch.as_tensor(x),)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch,in_hw", MODEL_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_ce_loss_gradients_match_reference(arch, in_hw, masked):
    ref_p, ref_apply, model, d = _model_case(arch, in_hw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, d)).astype(np.float32)
    y = rng.integers(0, 7, size=8)
    mask = (np.arange(8) < 5).astype(np.float32) if masked else None
    ref_g = jax.jit(jax.grad(lambda p: ref_client.ce_loss(
        ref_apply, p, jnp.asarray(x), jnp.asarray(y),
        None if mask is None else jnp.asarray(mask))))(trainable(ref_p))
    want = convert.cnn_params_from_numpy(arch, np_tree(ref_g), model=model, device="cpu")
    params = convert.cnn_params_from_numpy(arch, np_tree(ref_p), model=model, device="cpu")
    got = torch.func.grad(lambda p: fl_client.ce_loss(
        model, p, torch.as_tensor(x), torch.as_tensor(y),
        None if mask is None else torch.as_tensor(mask)))(params)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert err <= GRAD_TOL * scale


@pytest.mark.parametrize("channels", [6, 64, 512])
def test_groupnorm_equals_reference(channels):
    """``F.group_norm`` with min(32, C) groups and eps 1e-5 is the
    reference's ``_groupnorm`` (contiguous groups, biased variance)."""
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((2, 5, 4, channels)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    want = np.asarray(ref_cnn._groupnorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = torch.nn.functional.group_norm(
        torch.as_tensor(x).permute(0, 3, 1, 2), min(32, channels),
        torch.as_tensor(scale), torch.as_tensor(bias), eps=1e-5,
    ).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("arch,in_hw", MODEL_CASES)
def test_convert_round_trip(arch, in_hw):
    """Every reference leaf lands in exactly one port tensor and converts
    back to itself; LeNet-5's ``_meta`` (12 bytes, no parameter) is
    checked against the module and counted by ``meta_bytes`` instead, so
    model bytes equal the reference's ``tree_size_bytes``."""
    ref_p, _, model, _ = _model_case(arch, in_hw)
    ref_np = np_tree(ref_p)
    params = convert.cnn_params_from_numpy(arch, ref_np, model=model, device="cpu")
    leaves = dict(convert._flatten_tree({k: v for k, v in ref_np.items() if k != "_meta"}))
    assert list(params) == [n for n, _ in model.named_parameters()]
    assert set(params) == set(leaves)
    for name, leaf in leaves.items():
        back = params[name].numpy()
        if back.ndim == 4:           # OIHW -> HWIO
            back = back.transpose(2, 3, 1, 0)
        assert np.array_equal(back, leaf), name
    assert (fl_client.tree_size_bytes(params) + model.meta_bytes
            == ref_client.tree_size_bytes(ref_p))
    assert model.meta_bytes == (12 if arch == "lenet5" else 0)
    # the stacked (K, ...) form: row k is tree k
    trees = [{**jax.tree.map(lambda l, k=k: np.asarray(l) * (k + 1), trainable(ref_np)),
              **{k_: v for k_, v in ref_np.items() if k_ == "_meta"}} for k in range(3)]
    stack = convert.cnn_params_from_numpy(
        arch, jax.tree.map(lambda *ls: np.stack(ls), *trees), stacked=True, model=model,
        device="cpu")
    for k in range(3):
        row = convert.cnn_params_from_numpy(arch, trees[k], model=model, device="cpu")
        assert all(torch.equal(stack[n][k], row[n]) for n in row)


def test_build_model_derives_the_cnn_input():
    """The launcher's models: a CNN's forward pass takes the (hw, hw, 3)
    image its parameters were built for (the reference's apply defaults to
    16x16 whatever the init took)."""
    model = build_model("lenet5", dim=3072, n_classes=40)
    assert model.in_hw == (32, 32) and tuple(model.f1.w.shape) == (5 * 5 * 16, 120)
    logits = torch.func.functional_call(model, model.init_params(0, "cpu"),
                                        (torch.zeros(2, 3072),))
    assert tuple(logits.shape) == (2, 40)
    assert build_model("resnet9", dim=768, n_classes=10).in_hw == (16, 16)
    assert isinstance(build_model("mlp", dim=64, n_classes=10), MLP)
    with pytest.raises(ValueError, match="square"):
        build_model("lenet5", dim=1000, n_classes=10)


def test_convert_rejects_mismatched_trees():
    ref_p, _, _, _ = _model_case("lenet5", 16)
    # the same parameter shapes (16x16 and 17x17 inputs both pool to a 1x1
    # map) under a different declared input: the tree's _meta disagrees
    with pytest.raises(ValueError, match="_meta"):
        convert.cnn_params_from_numpy("lenet5", np_tree(ref_p),
                                      model=LeNet5(in_hw=(17, 17), n_classes=40), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        convert.cnn_params_from_numpy("mlp", np_tree(ref_p), model=MLP(48, 7), device="cpu")


@pytest.mark.parametrize("arch", ["mlp", "lenet5", "resnet9"])
def test_lg_global_tensors_and_split_bytes(arch):
    """LG-FedAvg aggregates the same tensors the reference's key-path rule
    picks (the MLP's last layer, LeNet-5's f3, ResNet-9's fc), with the
    same per-round bytes."""
    ref_p, ref_apply, model, d = _model_case(arch, 16)
    rng = np.random.default_rng(0)
    clients = [ClientData(*(rng.standard_normal((20, d)).astype(np.float32),
                            rng.integers(0, 7, 20)) * 2) for _ in range(3)]
    ref = ref_strategies.LGFedAvg(ref_apply, lambda key: ref_p, RefFLConfig())
    ref.setup(jax.random.PRNGKey(0), ref_client.stack_clients(clients))
    port = strategies.LGFedAvg(model, lambda s: model.init_params(s, "cpu"), FLConfig(),
                               device="cpu")
    port.setup(0, stack_clients(clients))
    ref_global = sorted(p for p in ref._paths if ref._is_global(p))
    port_global = sorted(strategies._keystr(n) for n in port.params
                         if port._is_global(strategies._keystr(n)))
    assert port_global == ref_global and port_global
    assert port._split_bytes() == ref._split_bytes()


# ---------------------------------------------------------------------------
# one local update on the reference's draws
# ---------------------------------------------------------------------------

M_CLIENTS, N_MAX, STEPS, BATCH = 3, 24, 5, 8


def _update_inputs(arch):
    ref_p, ref_apply, model, d = _model_case(arch, 16)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((M_CLIENTS, N_MAX, d)).astype(np.float32)
    y = rng.integers(0, 7, size=(M_CLIENTS, N_MAX)).astype(np.int64)
    n = np.array([N_MAX, 17, 6], dtype=np.int64)
    keys = jax.random.split(jax.random.PRNGKey(11), M_CLIENTS + 1)
    init = {"mlp": lambda k: ref_cnn.init_mlp_clf(k, 48, 7, hidden=(32, 16)),
            "lenet5": lambda k: ref_cnn.init_lenet5(k, in_hw=(16, 16), n_classes=40)}[arch]
    stacked = trainable(jax.jit(jax.vmap(init))(keys[:M_CLIENTS]))
    c_diff = jax.jit(lambda t: jax.tree.map(
        lambda l: 0.05 * jax.random.normal(keys[-1], l.shape, jnp.float32), t))(stacked)
    return ref_apply, model, x, y, n, stacked, c_diff


@pytest.mark.parametrize("case,arch", [
    ("sgd", "mlp"), ("sgd", "lenet5"), ("prox", "mlp"), ("control_variates", "mlp"),
    ("perfedavg", "mlp"),
])
def test_local_update_matches_reference_on_its_draws(case, arch):
    ref_apply, model, x, y, n, stacked, c_diff = _update_inputs(arch)
    key = jax.random.PRNGKey(21)
    if case == "perfedavg":
        kw = dict(steps=STEPS, batch_size=BATCH, alpha=0.05, beta=0.02)
        ref_local = ref_client.make_perfedavg_local(ref_apply, **kw)
        local = fl_client.make_perfedavg_local(model, **kw)
    else:
        kw = dict(steps=STEPS, batch_size=BATCH, lr=0.05, momentum=0.5,
                  prox_mu=0.3 if case == "prox" else 0.0,
                  use_control_variates=case == "control_variates")
        ref_local = ref_client.make_local_sgd(ref_apply, **kw)
        local = fl_client.make_local_sgd(model, **kw)
    # the anchor differs from the starting point so the proximal term acts
    anchor = jax.tree.map(lambda l: l[::-1], stacked)
    ref_c = c_diff if case == "control_variates" else jax.tree.map(jnp.zeros_like, stacked)
    want = jax.jit(jax.vmap(ref_local))(
        stacked, jnp.asarray(x), jnp.asarray(y), jnp.asarray(n),
        jax.random.split(key, M_CLIENTS), anchor, ref_c)
    to_port = partial(convert.cnn_params_from_numpy, arch, stacked=True, model=model,
                      device="cpu")
    idx = ref_draws(key, n, STEPS, BATCH, perfed=case == "perfedavg")
    got = local(to_port(np_tree(stacked)), torch.as_tensor(x), torch.as_tensor(y), idx,
                to_port(np_tree(anchor)),
                to_port(np_tree(c_diff)) if case == "control_variates" else None)
    want = to_port(np_tree(want))
    start = to_port(np_tree(stacked))
    assert rel_err(got, want) <= PARAM_TOL
    assert max(float((got[k] - start[k]).abs().max()) for k in got) > 1e-3   # it moved


def test_vmapped_resnet9_update_equals_per_client_runs():
    """The vmapped update (grouped convolutions, batched GroupNorm) gives
    each client what a run on that client alone gives (ResNet-9 at 8x8)."""
    model = ResNet9(in_hw=(8, 8), n_classes=5)
    base = model.init_params(0, "cpu")
    stack = {k: torch.stack([v, 1.01 * v]) for k, v in base.items()}
    gen = torch.Generator().manual_seed(3)
    x, y = torch.randn((2, 12, 192), generator=gen), torch.randint(0, 5, (2, 12), generator=gen)
    idx = fl_client.draw_indices(torch.tensor([12, 7]), (2, 4), gen)
    local = fl_client.make_local_sgd(model, steps=2, batch_size=4, lr=0.05, prox_mu=0.1)
    both = local(stack, x, y, idx, stack, None)
    for i in range(2):
        row = {k: v[i:i + 1] for k, v in stack.items()}
        one = local(row, x[i:i + 1], y[i:i + 1], idx[i:i + 1], row, None)
        assert rel_err({k: v[i] for k, v in both.items()}, {k: v[0] for k, v in one.items()}) \
            <= PARAM_TOL
    acc = fl_client.batch_eval(model, both, x, y, torch.tensor([12, 7]))
    assert acc.shape == (2,) and bool(((acc >= 0) & (acc <= 1)).all())


def test_draw_indices_bounded_per_client():
    n = torch.tensor([1, 0, 5, 300])
    idx = fl_client.draw_indices(n, (7, 16), torch.Generator().manual_seed(0))
    assert idx.shape == (4, 7, 16) and idx.dtype == torch.int64
    assert (idx[:2] == 0).all() and int(idx[2].max()) <= 4 and int(idx[3].max()) <= 299
    assert int(idx.min()) >= 0 and int(idx[3].max()) > 200   # it spans the range
    again = fl_client.draw_indices(n, (7, 16), torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_fl_train_launcher_matches_reference(monkeypatch):
    """``python -m repro_torch.launch.fl_train --device cpu`` at a small
    size: the same communication total and cluster count as the
    reference's launcher with the same flags."""
    flags = ["--clients", "12", "--rounds", "2", "--dim", "64"]
    port = fl_train.main(flags + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["fl_train"] + flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_fl_train.main()
    text = buf.getvalue()
    ref = json.loads(text[text.index("{"):])
    assert port["comm_mb"] == ref["comm_mb"]
    assert port["n_clusters"] == ref["n_clusters"]
    assert np.isfinite(port["final_acc_mean"])


def test_entry_points_default_to_cuda():
    """``device=None`` means the card: without one, the FL path raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    clients = label_skew(make_dataset("cifar10s", n_train=200, n_test=50, dim=16), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federation("fedavg", clients, MLP(16, 10, hidden=(8,)), FLConfig(rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP(16, 10).init_params(0)


def test_run_federation_computes_in_float32():
    """Inside ``run_federation`` TF32 is off for matmuls and for cuDNN (the
    convolutions, whose default is on), as the reference computes; the
    caller's settings come back afterwards."""
    clients = label_skew(make_dataset("cifar10s", n_train=200, n_test=50, dim=16), 4)
    model = MLP(16, 10, hidden=(8,))
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    seen = []

    def init_fn(seed):
        seen.append((matmul.allow_tf32, cudnn.allow_tf32))
        return model.init_params(seed, "cpu")

    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        run_federation("fedavg", clients, model, FLConfig(rounds=1), init_fn=init_fn,
                       device="cpu")
        after = matmul.allow_tf32, cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    assert seen and set(seen) == {(False, False)}
    assert after == (True, True)


def test_run_federation_holds_cudnn_to_deterministic_algorithms():
    """Inside ``run_federation`` cuDNN takes deterministic algorithms only,
    chosen without benchmarking, so two runs of one seed on the card give
    the same bits (the card test ``test_mix4_federation_repeats_bitwise``);
    the caller's settings come back afterwards."""
    clients = label_skew(make_dataset("cifar10s", n_train=200, n_test=50, dim=16), 4)
    model = MLP(16, 10, hidden=(8,))
    cudnn = torch.backends.cudnn
    seen = []

    def init_fn(seed):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return model.init_params(seed, "cpu")

    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        run_federation("fedavg", clients, model, FLConfig(rounds=1), init_fn=init_fn,
                       device="cpu")
        after = cudnn.deterministic, cudnn.benchmark
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    assert seen and set(seen) == {(True, False)}
    assert after == (False, True)


def test_fl_modules_import_without_jax():
    """The slice's modules import with ``jax`` blocked."""
    script = (
        "import sys, importlib, json\n"
        "sys.modules['jax'] = None\n"
        "mods = ['repro_torch.data', 'repro_torch.fl', 'repro_torch.fl.client',\n"
        "        'repro_torch.fl.strategies', 'repro_torch.fl.trainer',\n"
        "        'repro_torch.fl.churn', 'repro_torch.models.cnn',\n"
        "        'repro_torch.serving.server', 'repro_torch.launch.fl_train',\n"
        "        'repro_torch.launch.assign_serve', 'repro_torch.convert']\n"
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
