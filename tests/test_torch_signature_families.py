"""The port's signature families on the CPU, held against the JAX reference.

Mirrors ``tests/test_signature_families.py`` for ``repro_torch`` and adds
the parity the port owes the reference:

* the registry holds ``svd``, ``weight_delta`` and ``inference``;
* every family gives orthonormal (K, n, p) float32 stacks, deterministic in
  its inputs, independent of the chunk a client is computed in;
* ``weight_delta`` and ``inference`` signatures agree with the reference's
  within ``ANGLE_TOL_DEG`` (largest principal angle, float64) when the port
  is fed the reference's own draws: theta_0 (``init_mlp_clf`` at ``key0``),
  the warmup's ``fold_in`` minibatch indices and the sketch projection,
  carried across by ``repro_torch.convert``;
* the port flattens parameters coordinate for coordinate as the reference
  does, so the sketched deltas are equal (LeNet-5 included, whose ``_meta``
  rows are dropped from the reference's projection);
* PACFL labels are bitwise equal when both packages cluster the same float32
  signatures of each family, and a ``weight_delta`` federation with churn
  gives the reference's rosters and communication bytes.

The reference's LeNet-5 does not train (``jax.grad`` rejects its int32
``_meta`` leaf), so warmups are compared on the MLP.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import max_angle_deg, ref_projection, ref_warmup_draws
from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core.pacfl import PACFLConfig as RefConfig
from repro.core.pacfl import cluster_clients as ref_cluster_clients
from repro.core.pacfl import compute_signatures as ref_compute_signatures
from repro.core.signatures import ClientPayload as RefPayload
from repro.core.signatures import get_family as ref_get_family
from repro.core.signatures import warmup as ref_warmup
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core.pacfl import (
    PACFLConfig,
    cluster_clients,
    compute_signatures,
    one_shot_clustering,
)
from repro_torch.core.signatures import (
    ClientPayload,
    FamilyContext,
    SignatureFamily,
    family_names,
    get_family,
    register_family,
)
from repro_torch.core.signatures import inference, warmup, weight_delta
from repro_torch.core.svd import signature_upload_bytes
from repro_torch.models.cnn import MLP, LeNet5

# Largest principal angle allowed between the port's and the reference's
# signatures on the same draws.  Both run the same float32 SGD steps and
# differ only in summation order (~1e-7 relative an operation); measured
# ~1.5e-4 degrees at these sizes.  A wrong draw, flatten order or init
# moves the bases by degrees.
ANGLE_TOL_DEG = 1e-2
# A client's signature computed alone and in a batch of several: the
# batched matmuls may sum in another order (~1e-6 relative).
BATCH_ATOL = 1e-5

D, C = 32, 5
FAMILY_PARAMS = {
    "weight_delta": {"segments": 3, "steps": 4, "sketch_dim": 64},
    "inference": {"probe_per_dataset": 8, "steps": 4},
}


def _data(rng, K, d=D, n_classes=C, m_lo=30, m_hi=60, shift=0.3):
    """K ragged (x, y) client splits, client k's features shifted by its
    class k % n_classes."""
    out = []
    for k in range(K):
        m = int(rng.integers(m_lo, m_hi))
        x = rng.normal(size=(m, d)).astype(np.float32) + shift * (k % n_classes)
        out.append((x, rng.integers(0, n_classes, size=m).astype(np.int64)))
    return out


def _port(data):
    return [ClientPayload(x_train=x, y_train=y) for x, y in data]


def _ref(data):
    return [RefPayload(x_train=x, y_train=y) for x, y in data]


def _cfg(family, p=3, **kw):
    return PACFLConfig(p=p, family=family, family_params=dict(FAMILY_PARAMS[family]), **kw)


def _ref_cfg(family, p=3, **kw):
    return RefConfig(p=p, family=family, family_params=dict(FAMILY_PARAMS[family]), **kw)


def _orthonormal(U, atol=1e-4):
    G = torch.einsum("knp,knq->kpq", U, U)
    eye = torch.eye(U.shape[-1]).expand_as(G)
    return bool(torch.allclose(G, eye, atol=atol))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_builtins_registered(self):
        assert family_names() == ("inference", "svd", "weight_delta")

    def test_unknown_family_raises_with_choices(self):
        with pytest.raises(ValueError, match="unknown signature family"):
            get_family("nope")

    def test_register_latest_wins(self):
        class Fake(SignatureFamily):
            name = "weight_delta"

        orig = get_family("weight_delta")
        try:
            register_family(Fake())
            assert isinstance(get_family("weight_delta"), Fake)
        finally:
            register_family(orig)
        assert get_family("weight_delta") is orig

    def test_config_dispatch(self):
        with pytest.raises(ValueError, match="unknown signature family"):
            compute_signatures([], PACFLConfig(family="bogus"), device="cpu")

    def test_model_families_need_a_model_svd_does_not(self):
        assert get_family("weight_delta").needs_model
        assert get_family("inference").needs_model
        assert not get_family("svd").needs_model


# ---------------------------------------------------------------------------
# the families on their own
# ---------------------------------------------------------------------------


class TestModelFamilies:
    @pytest.mark.parametrize("family", ["weight_delta", "inference"])
    def test_shape_orthonormal_deterministic(self, family):
        payloads = _port(_data(np.random.default_rng(2), K=5))
        cfg = _cfg(family)
        U1 = compute_signatures(payloads, cfg, seed=4, device="cpu")
        U2 = compute_signatures(payloads, cfg, seed=4, device="cpu")
        assert torch.equal(U1, U2)
        n = 64 if family == "weight_delta" else 8 * 4
        assert tuple(U1.shape) == (5, n, 3) and U1.dtype == torch.float32
        assert _orthonormal(U1)

    def test_weight_delta_sketch_dim_sets_basis_rows(self):
        payloads = _port(_data(np.random.default_rng(3), K=3))
        cfg = PACFLConfig(p=2, family="weight_delta",
                          family_params={"segments": 2, "steps": 2, "sketch_dim": 24})
        assert tuple(compute_signatures(payloads, cfg, device="cpu").shape) == (3, 24, 2)

    def test_weight_delta_without_sketch_spans_every_parameter(self):
        payloads = _port(_data(np.random.default_rng(3), K=2, d=8))
        cfg = PACFLConfig(p=2, family="weight_delta",
                          family_params={"segments": 2, "steps": 2, "sketch_dim": 0})
        n_params = sum(p.numel() for p in MLP(8, C, hidden=(64,)).parameters())
        U = compute_signatures(payloads, cfg, device="cpu")
        assert tuple(U.shape) == (2, n_params, 2) and _orthonormal(U)

    def test_weight_delta_depends_only_on_payload_and_seed(self):
        """Same data and seed -> bitwise-equal basis (what lets the churn
        queue compute signatures at enqueue); other labels on the same
        inputs -> another basis (the signal the family measures)."""
        rng = np.random.default_rng(4)
        x = rng.normal(size=(60, 16)).astype(np.float32)

        def mk(label):
            return ClientPayload(x_train=x.copy(), y_train=np.full(60, label, dtype=np.int64))

        cfg = PACFLConfig(p=2, family="weight_delta",
                          family_params={"segments": 2, "steps": 4, "sketch_dim": 32})
        fam = get_family("weight_delta")
        Ua = fam.signature_one(mk(0), cfg, seed=2, device="cpu")
        Ua2 = fam.signature_one(mk(0), cfg, seed=2, device="cpu")
        Ub = fam.signature_one(mk(3), cfg, seed=2, device="cpu")
        assert torch.equal(Ua, Ua2)
        assert not torch.allclose(Ua, Ub, atol=1e-3)

    def test_inference_signature_rows_match_probe(self):
        rng = np.random.default_rng(5)
        payloads = _port(_data(rng, K=4, d=16))
        probe = rng.normal(size=(20, 16)).astype(np.float32)
        cfg = PACFLConfig(p=3, family="inference", family_params={"steps": 2})
        U = compute_signatures(payloads, cfg, context=FamilyContext(probe=probe), device="cpu")
        assert tuple(U.shape) == (4, 20, 3) and _orthonormal(U)

    def test_inference_needs_enough_classes(self):
        payloads = _port(_data(np.random.default_rng(6), K=3, n_classes=2))  # default MLP: C=2
        cfg = PACFLConfig(p=3, family="inference",
                          family_params={"probe_per_dataset": 8, "steps": 1})
        with pytest.raises(ValueError, match="n_classes >= p"):
            compute_signatures(payloads, cfg, device="cpu")

    def test_inference_probe_and_downlink_equal_reference(self):
        data = _data(np.random.default_rng(7), K=3, d=16)
        fam, ref_fam = get_family("inference"), ref_get_family("inference")
        cfg, ref_cfg = _cfg("inference", p=2), _ref_cfg("inference", p=2)
        assert fam.downlink_bytes(cfg, None, 3) == 0   # unresolved: unknown dim
        ctx = fam.prepare_context(_port(data), cfg, FamilyContext())
        ref_ctx = ref_fam.prepare_context(_ref(data), ref_cfg)
        np.testing.assert_array_equal(ctx.probe, np.asarray(ref_ctx.probe))
        assert ctx.probe.shape == (8 * 4, 16)
        assert fam.downlink_bytes(cfg, ctx, 3) == ref_fam.downlink_bytes(ref_cfg, ref_ctx, 3)
        assert fam.downlink_bytes(cfg, ctx, 3) == 8 * 4 * 16 * 4 * 3

    @pytest.mark.parametrize("family", ["weight_delta", "inference"])
    def test_signature_one_matches_batch(self, family):
        payloads = _port(_data(np.random.default_rng(8), K=4))
        cfg, fam = _cfg(family), get_family(family)
        one = fam.signature_one(payloads[0], cfg, seed=1, device="cpu")
        assert torch.equal(one, fam.signatures(payloads[:1], cfg, seed=1, device="cpu")[0])
        # the first of four: the same draws, batched matmuls of four
        batch = fam.signatures(payloads, cfg, seed=1, device="cpu")
        assert (one - batch[0]).abs().max().item() <= BATCH_ATOL

    @pytest.mark.parametrize("family", ["weight_delta", "inference"])
    def test_chunk_boundary_changes_no_signature(self, family, monkeypatch):
        """K = 10 in one chunk and in chunks of 4: client k's draws come from
        (seed, k, segment) wherever it sits, so every row is the same."""
        payloads = _port(_data(np.random.default_rng(9), K=10))
        cfg = _cfg(family)
        whole = compute_signatures(payloads, cfg, seed=3, device="cpu")
        if family == "weight_delta":
            monkeypatch.setattr(weight_delta, "WD_CHUNK", 4)
        else:
            monkeypatch.setattr(inference, "IF_CHUNK", 4)
        chunked = compute_signatures(payloads, cfg, seed=3, device="cpu")
        assert torch.equal(whole, chunked)

    def test_warmup_indices_below_client_counts(self):
        n = torch.tensor([1, 5, 37])
        idx = warmup.warmup_indices(n, segments=3, steps=4, batch_size=16, seed=0)
        assert tuple(idx.shape) == (3, 3, 4, 16)
        assert bool((idx >= 0).all()) and bool((idx < n[:, None, None, None]).all())
        again = warmup.warmup_indices(n[1:], segments=3, steps=4, batch_size=16, seed=0,
                                      client_offset=1)
        assert torch.equal(idx[1:], again)

    def test_stack_payloads_pads_to_the_pow2_bucket(self):
        data = _data(np.random.default_rng(10), K=3, m_lo=20, m_hi=40)
        x, y, n = warmup.stack_payloads(_port(data), torch.device("cpu"))
        rx, ry, rn = ref_warmup.stack_payloads(_ref(data))
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
        np.testing.assert_array_equal(n.numpy(), np.asarray(rn))

    def test_injected_draws_are_checked(self):
        payloads = _port(_data(np.random.default_rng(11), K=2))
        cfg = _cfg("weight_delta")
        bad = FamilyContext(indices=torch.zeros((3, 3, 4, 16), dtype=torch.long))
        with pytest.raises(ValueError, match="context.indices"):
            compute_signatures(payloads, cfg, context=bad, device="cpu")
        bad = FamilyContext(projection=torch.zeros((5, 64)))
        with pytest.raises(ValueError, match="context.projection"):
            compute_signatures(payloads, cfg, context=bad, device="cpu")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _mlp_tree(key0, d=D, n_classes=C):
    return jax.tree.map(np.asarray, ref_cnn.init_mlp_clf(key0, d, n_classes, hidden=(64,)))


@pytest.mark.parametrize("family", ["weight_delta", "inference"])
def test_signatures_match_reference_on_its_draws(family):
    """Both packages' default model (MLP, hidden 64) from the reference's
    theta_0, warmup indices and projection: signatures within
    ANGLE_TOL_DEG; both stacks orthonormal and of one shape."""
    data = _data(np.random.default_rng(12), K=10)
    key, key0 = jax.random.PRNGKey(3), jax.random.PRNGKey(0)
    U_ref = np.asarray(ref_compute_signatures(_ref(data), _ref_cfg(family), key=key))
    tree = _mlp_tree(key0)
    model = MLP(D, C, hidden=(64,))
    hp = FAMILY_PARAMS[family]
    segments = hp.get("segments", 1)
    idx = ref_warmup_draws(key, [len(y) for _, y in data], segments, hp["steps"], 16)
    ctx = FamilyContext(
        model=model, theta0=convert.cnn_params_from_numpy("mlp", tree, model=model, device="cpu"),
        indices=torch.as_tensor(idx),
    )
    if family == "weight_delta":
        n_params = sum(leaf.size for leaf in jax.tree.leaves(tree))
        ctx.projection = convert.projection_from_numpy(
            ref_projection(key0, n_params, hp["sketch_dim"]), model, "cpu")
    U = compute_signatures(_port(data), _cfg(family), context=ctx, device="cpu")
    assert tuple(U.shape) == U_ref.shape
    assert _orthonormal(U)
    assert max_angle_deg(U_ref, U.numpy()) <= ANGLE_TOL_DEG


@pytest.mark.parametrize("arch", ["mlp", "lenet5"])
def test_sketched_deltas_equal_reference(arch):
    """The port flattens a parameter dict coordinate for coordinate as the
    reference flattens its tree (sorted leaves, HWIO convolutions), and a
    delta sketched through the converted projection equals the
    reference's.  LeNet-5's ``_meta`` (cast to float32 here, as a wrapped
    init would) leads the reference's leaves and never moves, so its 3
    rows are dropped."""
    key = jax.random.PRNGKey(5)
    if arch == "mlp":
        model = MLP(24, 4, hidden=(16, 8))
        tree0 = jax.tree.map(np.asarray, ref_cnn.init_mlp_clf(key, 24, 4, hidden=(16, 8)))
    else:
        model = LeNet5(in_hw=(16, 16), in_ch=3, n_classes=7)
        tree0 = jax.tree.map(np.asarray, ref_cnn.init_lenet5(key, in_hw=(16, 16), n_classes=7))
        tree0["_meta"] = jax.tree.map(lambda a: a.astype(np.float32), tree0["_meta"])
    noise = iter(np.random.default_rng(13).normal(size=(64,)))

    def moved(a):   # every leaf but _meta moves
        return a if a.dtype != np.float32 else a + np.float32(next(noise)) * np.ones_like(a)

    tree1 = {k: (v if k == "_meta" else jax.tree.map(moved, v)) for k, v in tree0.items()}
    stacked = [jax.tree.map(lambda a: jnp.asarray(a)[None], t) for t in (tree0, tree1)]
    delta_ref = np.asarray(ref_warmup.flatten_params(stacked[1]) - ref_warmup.flatten_params(stacked[0]))
    trainable = [{k: v for k, v in t.items() if k != "_meta"} for t in (tree0, tree1)]
    port = [convert.cnn_params_from_numpy(arch, t, model=model, device="cpu") for t in trainable]
    flat = [warmup.flatten_params({k: v[None] for k, v in p.items()}) for p in port]
    np.testing.assert_array_equal(
        flat[0].numpy(), np.asarray(ref_warmup.flatten_params(
            jax.tree.map(lambda a: jnp.asarray(a)[None], trainable[0]))))
    proj = ref_projection(key, delta_ref.shape[1], 16)
    want = delta_ref @ proj
    got = ((flat[1] - flat[0]) @ convert.projection_from_numpy(proj, model, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if arch == "lenet5":
        assert np.all(delta_ref[:, :3] == 0.0)


@pytest.mark.parametrize("family,measure", [
    ("svd", "eq3"), ("weight_delta", "eq2"), ("weight_delta", "eq3"), ("inference", "eq2"),
])
def test_pacfl_labels_bitwise_on_equal_signatures(family, measure):
    """The reference's float32 signatures of each family through both
    packages' ``cluster_clients`` (threshold from ``beta_quantile``):
    bitwise-equal labels and cluster counts."""
    data = _data(np.random.default_rng(14), K=16, n_classes=4, shift=1.0)
    kw = dict(measure=measure, beta_quantile=0.3)
    if family == "svd":
        ref_cfg, cfg = RefConfig(p=3, **kw), PACFLConfig(p=3, **kw)
    else:
        ref_cfg, cfg = _ref_cfg(family, **kw), _cfg(family, **kw)
    U = np.asarray(ref_compute_signatures(_ref(data), ref_cfg, key=jax.random.PRNGKey(1)))
    ref = ref_cluster_clients(jnp.asarray(U), ref_cfg)
    port = cluster_clients(torch.as_tensor(U), cfg, device="cpu")
    assert port.n_clusters == ref.n_clusters
    np.testing.assert_array_equal(port.labels, ref.labels)


def test_one_shot_clustering_threads_context():
    rng = np.random.default_rng(15)
    payloads = _port(_data(rng, K=4, d=16))
    probe = rng.normal(size=(12, 16)).astype(np.float32)
    cfg = PACFLConfig(p=2, family="inference", beta_quantile=0.4, family_params={"steps": 1})
    clu = one_shot_clustering(payloads, cfg, context=FamilyContext(probe=probe), device="cpu")
    assert tuple(clu.U.shape) == (4, 12, 2)
    assert clu.signature_bytes == 4 * 12 * 2 * 4


def test_one_shot_weight_delta_small():
    """The README's CPU one-liner: weight_delta one-shot clustering."""
    payloads = _port(_data(np.random.default_rng(16), K=8, n_classes=4, shift=1.0))
    cfg = PACFLConfig(p=3, family="weight_delta", beta_quantile=0.2,
                      family_params={"segments": 3, "steps": 4, "sketch_dim": 64})
    clu = one_shot_clustering(payloads, cfg, seed=0, device="cpu")
    assert tuple(clu.U.shape) == (8, 64, 3)
    assert 1 <= clu.n_clusters <= 8 and clu.labels.shape == (8,)
    assert clu.signature_bytes == signature_upload_bytes(clu.U)


# ---------------------------------------------------------------------------
# the FL layer
# ---------------------------------------------------------------------------


def _fl_clients(rng, K, cls, d=12, n_classes=4):
    out = []
    for k in range(K):
        m = int(rng.integers(40, 70))
        lab = k % n_classes  # hard label skew -> real cluster structure
        out.append(cls(
            x_train=rng.normal(size=(m, d)).astype(np.float32) + lab,
            y_train=np.full(m, lab, dtype=np.int64),
            x_test=rng.normal(size=(10, d)).astype(np.float32) + lab,
            y_test=np.full(10, lab, dtype=np.int64),
            dataset_name="synthetic",
        ))
    return out


@pytest.mark.parametrize("family", ["weight_delta", "inference"])
def test_federation_with_churn_rosters_and_bytes_equal_reference(family):
    """``tests/test_signature_families.py``'s federation with churn, in both
    packages: the same client count, stable-id roster, signature bytes and
    upload / download totals (the probe broadcast for ``inference``)."""
    from repro.fl.partition import ClientData as RefClientData
    from repro.fl.strategies import FLConfig as RefFLConfig
    from repro.fl.trainer import ChurnEvent as RefChurnEvent
    from repro.fl.trainer import run_federation as ref_run_federation
    from repro_torch.fl import ChurnEvent, FLConfig, run_federation
    from repro_torch.fl.partition import ClientData

    params = {"weight_delta": {"segments": 2, "steps": 2, "sketch_dim": 24},
              "inference": {"probe_per_dataset": 4, "steps": 2}}[family]
    fl_kw = dict(rounds=3, sample_frac=0.5, local_epochs=1, batch_size=16)
    pac_kw = dict(p=2, family=family, beta_quantile=0.3, family_params=params)
    ref_clients = _fl_clients(np.random.default_rng(12), 7, RefClientData)
    clients = _fl_clients(np.random.default_rng(12), 7, ClientData)
    ref = ref_run_federation(
        "pacfl", ref_clients[:6], ref_cnn.mlp_clf_apply,
        functools.partial(ref_cnn.init_mlp_clf, d_in=12, n_classes=4, hidden=(16,)),
        RefFLConfig(**fl_kw, pacfl=RefConfig(**pac_kw)), seed=0, eval_every=3,
        churn=[RefChurnEvent(rnd=1, join=ref_clients[6:], leave=[0])],
    ).strategy_obj
    port = run_federation(
        "pacfl", clients[:6], MLP(12, 4, hidden=(16,)),
        FLConfig(**fl_kw, pacfl=PACFLConfig(**pac_kw)), seed=0, eval_every=3,
        churn=[ChurnEvent(rnd=1, join=clients[6:], leave=[0])], device="cpu",
    ).strategy_obj
    assert port.data.n_clients == ref.data.n_clients == 6   # 6 - 1 + 1
    assert port._client_ids == ref._client_ids
    assert tuple(port.clustering.U.shape) == tuple(ref.clustering.U.shape)
    assert port.clustering.signature_bytes == ref.clustering.signature_bytes
    n_rows = port.clustering.U.shape[1]
    assert port.clustering.signature_bytes == (6 + 1) * n_rows * 2 * 4
    assert (port.comm_up, port.comm_down) == (ref.comm_up, ref.comm_down)
    assert port._fam_ctx.model is port.model


def test_churn_signature_is_the_familys_signature_one():
    """The churn queue's eager signature of a newcomer is the family's
    ``signature_one`` at the strategy's seed stream, on the strategy's own
    model and theta_0."""
    from repro_torch.fl import FLConfig
    from repro_torch.fl.client import derive_seed, stack_clients
    from repro_torch.fl.partition import ClientData
    from repro_torch.fl.strategies import PACFL

    clients = _fl_clients(np.random.default_rng(17), 6, ClientData)
    model = MLP(12, 4, hidden=(16,))
    cfg = FLConfig(pacfl=PACFLConfig(p=2, family="weight_delta", beta_quantile=0.3,
                                     family_params={"segments": 2, "steps": 2, "sketch_dim": 24}))
    strat = PACFL(model, lambda s: model.init_params(s, "cpu"), cfg, device="cpu")
    strat.setup(7, stack_clients(clients[:5]))
    got = strat.churn_signature_fn()(clients[5])
    want = get_family("weight_delta").signature_one(
        clients[5], cfg.pacfl, seed=derive_seed(7, 1_000_003),
        context=FamilyContext(model=model, seed0=7), device="cpu")
    assert torch.equal(got, want)
