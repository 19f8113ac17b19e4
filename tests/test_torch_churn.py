"""The port's async churn pipeline on the CPU, held against the JAX reference.

* queue semantics and the ``DrainPolicy`` formula, mirroring
  ``tests/test_churn_queue.py``, plus the drain's batches equal to the
  reference queue's for the same arrivals under several policies;
* PACFL federations with join, leave and refresh events (shaped like
  ``tests/test_fl.py::TestChurn`` and ``TestQueueParity``): labels, the
  stable-id roster, engine ids and communication bytes bitwise equal to the
  reference's;
* the post-churn local-step refresh and its memo.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core.pacfl import PACFLConfig as RefPACFLConfig
from repro.data import DriftGenerator as RefDriftGenerator
from repro.data import DriftSpec as RefDriftSpec
from repro.data import make_dataset as ref_make_dataset
from repro.fl import ChurnEvent as RefChurnEvent
from repro.fl import ChurnQueue as RefChurnQueue
from repro.fl import DrainPolicy as RefDrainPolicy
from repro.fl import FLConfig as RefFLConfig
from repro.fl import label_skew as ref_label_skew
from repro.fl import run_federation as ref_run_federation
from repro.fl import strategies as ref_strategies
from repro.models.cnn import init_mlp_clf, mlp_clf_apply
from repro_torch.core.engine import ClusterEngine, EngineConfig
from repro_torch.core.pacfl import PACFLConfig
from repro_torch.data import DriftGenerator, DriftSpec, make_dataset
from repro_torch.fl import (
    ChurnEvent, ChurnQueue, DrainPolicy, FLConfig, apply_churn_batches, label_skew,
    run_federation,
)
from repro_torch.fl.client import stack_clients
from repro_torch.fl.strategies import PACFL, FedNova, PerFedAvg, bucket_steps
from repro_torch.models.cnn import MLP


def _clustered(K, n=32, p=3, n_bases=6, spread=0.08, seed=0):
    """K orthonormal (n, p) signatures around n_bases planted subspaces."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(rng.standard_normal((n, p)))[0] for _ in range(n_bases)]
    out = [np.linalg.qr(bases[k % n_bases] + spread * rng.standard_normal((n, p)))[0]
           for k in range(K)]
    return torch.as_tensor(np.stack(out), dtype=torch.float32)


# ---------------------------------------------------------------------------
# queue semantics (tests/test_churn_queue.py::TestQueueSemantics)
# ---------------------------------------------------------------------------


class TestQueueSemantics:
    def test_drain_preserves_arrival_order_and_coalesces(self):
        q = ChurnQueue(policy=DrainPolicy(100.0, 1.0, target_overhead=0.5, max_batch=2))
        assert q.policy.batch_size == 2
        for op in ("jA", "jB", "jC"):
            q.enqueue_join(op)
        q.enqueue_leave(0)
        q.enqueue_join("jD")
        batches = q.drain()
        # joins coalesce into runs of <= B, a leave bounds the run
        assert [(b.leave, b.join) for b in batches] == [
            ([], ["jA", "jB"]), ([], ["jC"]), ([0], ["jD"]),
        ]
        assert len(q) == 0
        assert q.stats.drained_batches == 3
        assert q.stats.drained_joins == 4 and q.stats.drained_leaves == 1

    def test_leave_then_join_share_a_batch(self):
        q = ChurnQueue()
        q.enqueue_leave(3)
        q.enqueue_leave(1)
        q.enqueue_join("jA")
        assert [(b.leave, b.join) for b in q.drain()] == [([3, 1], ["jA"])]

    def test_holdback_mode_defers_small_join_runs(self):
        q = ChurnQueue(policy=DrainPolicy(300.0, 1.0, target_overhead=0.5, max_batch=8))
        B = q.policy.batch_size
        for i in range(B - 1):
            q.enqueue_join(f"j{i}")
        assert q.drain(force=False) == []       # under B: held back
        assert q.pending_joins == B - 1
        q.enqueue_leave(0)                      # departures always drain...
        batches = q.drain(force=False)
        # ...and a leave bounds the join run, so the held joins flush first
        assert [(b.leave, len(b.join)) for b in batches] == [([], B - 1), ([0], 0)]
        q.enqueue_join("late")
        assert len(q.drain(force=True)) == 1    # force flushes remainders

    def test_eager_signatures_computed_at_enqueue(self):
        calls = []

        def sig_fn(client):
            calls.append(client)
            return torch.full((4, 2), float(len(calls)))

        q = ChurnQueue(signature_fn=sig_fn)
        q.enqueue_join("a")
        q.enqueue_join("b")
        assert calls == ["a", "b"]              # ran at enqueue, not drain
        assert q.stats.signature_us >= 0.0
        (batch,) = q.drain()
        assert isinstance(batch.signatures, torch.Tensor)
        assert tuple(batch.signatures.shape) == (2, 4, 2)
        assert bool((batch.signatures[1] == 2.0).all())

    def test_churn_event_adapter_orders_departs_first(self):
        q = ChurnQueue()
        q.enqueue_event(ChurnEvent(rnd=1, join=["x"], leave=[2, 5]))
        (batch,) = q.drain()
        assert batch.leave == [5, 2] and batch.join == ["x"]

    def test_refresh_batches_exclusive_and_ordered_first(self):
        q = ChurnQueue()
        q.enqueue_event(ChurnEvent(rnd=1, join=["x"], leave=[1],
                                   refresh=[(0, "rA"), (2, "rB")]))
        assert [(b.refresh, b.leave, b.join) for b in q.drain()] == [
            ([0, 2], [], []), ([], [1], ["x"]),
        ]
        with pytest.raises(ValueError, match="duplicate refresh position"):
            q.enqueue_event(ChurnEvent(rnd=2, refresh=[(3, "a"), (3, "b")]))


class TestDrainPolicy:
    def test_batch_size_formula(self):
        # B* = ceil(c0 (1-rho) / (c1 rho)) clamped to [1, max_batch]
        assert DrainPolicy(100.0, 10.0, target_overhead=0.25).batch_size == 30
        assert DrainPolicy(100.0, 10.0, target_overhead=0.5).batch_size == 10
        assert DrainPolicy(0.0, 10.0).batch_size == 1
        assert DrainPolicy(1e9, 1.0, max_batch=64).batch_size == 64
        p = DrainPolicy(123.4, 5.6, target_overhead=0.1)
        assert p.batch_size == DrainPolicy(123.4, 5.6, target_overhead=0.1).batch_size
        assert p.batch_size == RefDrainPolicy(123.4, 5.6, target_overhead=0.1).batch_size
        assert p.estimated_batch_us(2, 1, 3) == RefDrainPolicy(
            123.4, 5.6, target_overhead=0.1).estimated_batch_us(2, 1, 3)

    def test_measure_fits_positive_costs(self):
        """The seeded timing probe (QR'd Gaussians on the stack's device)."""
        pol = DrainPolicy.measure(_clustered(24), seed=0, reps=1, probe_batch=4)
        assert pol.dispatch_cost_us >= 0.0
        assert pol.per_newcomer_us > 0.0
        assert 1 <= pol.batch_size <= pol.max_batch


# The same arrivals under several policies: leaves, joins and refreshes
# interleaved, batch caps, the throughput hold-back, deadline slices.
_ARRIVALS = ([("join", "j0"), ("join", "j1"), ("refresh", 0, "r0"), ("join", "j2"),
              ("leave", 3), ("join", "j3"), ("join", "j4"), ("join", "j5"),
              ("refresh", 1, "r1"), ("refresh", 4, "r2"), ("leave", 0), ("join", "j6")])
_POLICIES = [
    None,
    dict(dispatch_cost_us=100.0, per_newcomer_us=1.0, target_overhead=0.5, max_batch=2),
    dict(dispatch_cost_us=300.0, per_newcomer_us=1.0, target_overhead=0.5, max_batch=8),
    dict(dispatch_cost_us=100.0, per_newcomer_us=10.0, max_batch=4, deadline_s=250e-6),
    dict(dispatch_cost_us=100.0, per_newcomer_us=10.0, max_batch=4, deadline_s=150e-6,
         priority_departures=True),
]


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("policy", _POLICIES)
def test_drain_batches_equal_reference(policy, force):
    queues = (ChurnQueue(policy=None if policy is None else DrainPolicy(**policy)),
              RefChurnQueue(policy=None if policy is None else RefDrainPolicy(**policy)))
    drained = []
    for q in queues:
        for op in _ARRIVALS:
            if op[0] == "join":
                q.enqueue_join(op[1])
            elif op[0] == "leave":
                q.enqueue_leave(op[1])
            else:
                q.enqueue_refresh(op[1], op[2])
        rounds = []
        while len(q) and len(rounds) < 20:
            rounds.append([(b.leave, b.join, b.refresh, b.refresh_clients)
                           for b in q.drain(force=force)])
            if not rounds[-1]:
                rounds.append([(b.leave, b.join, b.refresh, b.refresh_clients)
                               for b in q.drain(force=True)])
        drained.append((rounds, vars(q.stats)))
    assert drained[0] == drained[1]


def test_engine_labels_bitwise_vs_synchronous_queue():
    """Draining the queue reproduces the synchronous schedule's labels
    bitwise for every admission batch split (port engine, port queue)."""
    U = _clustered(20, n_bases=4, spread=0.2, seed=7)
    joins = _clustered(7, n_bases=5, spread=0.3, seed=8)
    cfg = EngineConfig(beta=25.0)
    schedule = [
        ChurnEvent(rnd=1, join=[joins[0], joins[1]], leave=[3]),
        ChurnEvent(rnd=2, join=[joins[2]]),
        ChurnEvent(rnd=3, join=[joins[3], joins[4], joins[5]], leave=[0, 5]),
        ChurnEvent(rnd=4, join=[joins[6]]),
    ]
    sync = ClusterEngine.from_signatures(U, cfg, device="cpu")
    for ev in schedule:
        if ev.leave:
            sync.depart(sync.ids[np.asarray(ev.leave)])
        if ev.join:
            sync.admit(torch.stack(ev.join))
    for cap in (None, 1, 2):
        policy = None if cap is None else DrainPolicy(
            1.0, 1.0, target_overhead=1.0 / (1 + cap), max_batch=cap)
        queued = ClusterEngine.from_signatures(U, cfg, device="cpu")
        q = ChurnQueue(signature_fn=lambda u: u, policy=policy)
        for ev in schedule:
            q.enqueue_event(ev)
        for batch in q.drain():
            if batch.leave:
                gone, _ = batch.resolve_leaves(queued.ids)
                queued.depart(np.asarray(gone))
            if batch.join:
                queued.admit(batch.signatures)
        np.testing.assert_array_equal(sync.labels, queued.labels)
        np.testing.assert_array_equal(sync.canonical_labels, queued.canonical_labels)


# ---------------------------------------------------------------------------
# PACFL federations with churn, against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feds():
    """``small_fed`` of tests/test_churn_queue.py (14 clients), both
    packages.  Its PACFL config (eq2, beta 20) puts these clients in one
    cluster; the churn parity cases use :data:`CHURN_PACFL`, which split
    them."""
    cfg_kw = dict(rounds=4, sample_frac=0.34, local_epochs=2, batch_size=16, lr=0.05)
    pac = dict(p=3, beta=20.0, measure="eq2")
    kw = dict(n_train=1200, n_test=400, dim=128, seed=0)
    ds, ref_ds = make_dataset("cifar10s", **kw), ref_make_dataset("cifar10s", **kw)
    port = (label_skew(ds, 14, rho=0.2, seed=1, test_per_client=80),
            FLConfig(**cfg_kw, pacfl=PACFLConfig(**pac)))
    ref = (ref_label_skew(ref_ds, 14, rho=0.2, seed=1, test_per_client=80),
           lambda key: init_mlp_clf(key, 128, 10, hidden=(64,)),
           RefFLConfig(**cfg_kw, pacfl=RefPACFLConfig(**pac)))
    return port, ref


# PACFL settings with several clusters on these clients (the first ten:
# eq3 at beta 175 gives 2 clusters, eq2 at beta 10 gives 2).
CHURN_PACFL = {"eq3": dict(p=3, beta=175.0, measure="eq3"),
               "eq2": dict(p=3, beta=10.0, measure="eq2")}


def _drifted(clients, drift_cls, spec_cls, which):
    """Covariate-drifted copies (30 degrees at round 3) of ``clients[which]``."""
    gen = drift_cls(spec_cls(kind="covariate", angle_per_round_deg=10.0, rank=3, seed=4), 128)
    out = []
    for i in which:
        c = clients[i]
        x, y = gen.apply(f"client{i}", 3, c.x_train, c.y_train)
        out.append(type(c)(x, y, c.x_test, c.y_test, c.dataset_name, dict(c.meta)))
    return out


def _schedule(event_cls, clients, drifted, *, beta_case):
    if beta_case == "join_leave":
        # tests/test_fl.py::TestChurn and TestQueueParity's shapes
        return [event_cls(rnd=2, join=clients[10:13], leave=[0, 3]),
                event_cls(rnd=4, join=clients[13:14], leave=[1])]
    return [event_cls(rnd=2, refresh=[(0, drifted[0]), (2, drifted[1])]),
            event_cls(rnd=3, refresh=[(1, drifted[2])], leave=[3], join=clients[10:12]),
            event_cls(rnd=4, leave=[0], join=clients[12:14])]


@pytest.mark.parametrize("measure,case,split", [
    ("eq3", "join_leave", False), ("eq3", "refresh", False),
    ("eq2", "join_leave", True), ("eq2", "refresh", True),
])
def test_pacfl_churn_labels_and_roster_bitwise(feds, measure, case, split):
    """Labels, roster and engine state bitwise equal to the reference's
    after joins, leaves and refreshes (``split``: single-client admission
    batches)."""
    (clients, cfg), (ref_clients, ref_init, ref_cfg) = feds
    cfg = dataclasses.replace(cfg, pacfl=PACFLConfig(**CHURN_PACFL[measure]))
    ref_cfg = dataclasses.replace(ref_cfg, pacfl=RefPACFLConfig(**CHURN_PACFL[measure]))
    drifted = _drifted(clients, DriftGenerator, DriftSpec, (4, 5, 6))
    ref_drifted = _drifted(ref_clients, RefDriftGenerator, RefDriftSpec, (4, 5, 6))
    policy = dict(dispatch_cost_us=0.0, per_newcomer_us=1.0, max_batch=1) if split else None
    res = run_federation("pacfl", clients[:10], MLP(128, 10, hidden=(64,)), cfg, seed=0,
                         churn=_schedule(ChurnEvent, clients, drifted, beta_case=case),
                         drain_policy=policy and DrainPolicy(**policy), device="cpu")
    ref = ref_run_federation("pacfl", ref_clients[:10], mlp_clf_apply, ref_init, ref_cfg,
                             seed=0,
                             churn=_schedule(RefChurnEvent, ref_clients, ref_drifted,
                                             beta_case=case),
                             drain_policy=policy and RefDrainPolicy(**policy))
    port_s, ref_s = res.strategy_obj, ref.strategy_obj
    np.testing.assert_array_equal(port_s.labels, ref_s.labels)
    assert port_s._client_ids == ref_s._client_ids
    port_e, ref_e = port_s.clustering.engine, ref_s.clustering.engine
    np.testing.assert_array_equal(port_e.ids, ref_e.ids)
    np.testing.assert_array_equal(port_e.labels, ref_e.labels)
    np.testing.assert_array_equal(port_e.canonical_labels, ref_e.canonical_labels)
    assert port_e.version == ref_e.version
    assert (port_s.comm_up, port_s.comm_down) == (ref_s.comm_up, ref_s.comm_down)
    assert len(res.final_accs) == len(ref.final_accs)
    # the per-cluster model stack covers every live stable label
    assert int(port_s.labels.max()) < next(iter(port_s.cluster_params.values())).shape[0]
    assert port_s.clustering.n_clusters >= 2


def _port_pacfl(clients, cfg):
    model = MLP(128, 10, hidden=(64,))
    strat = PACFL(model, lambda s: model.init_params(s, "cpu"), cfg, device="cpu")
    strat.setup(0, stack_clients(clients))
    return strat


def test_bad_leave_position_fails_before_any_mutation(feds):
    (clients, cfg), _ = feds
    strat = _port_pacfl(clients[:6], cfg)
    labels0 = strat.labels.copy()
    q = ChurnQueue(signature_fn=strat.churn_signature_fn())
    q.enqueue_event(ChurnEvent(rnd=1, join=clients[6:8]))
    q.enqueue_leave(2)
    q.enqueue_leave(99)   # invalid even after the joins above
    with pytest.raises(IndexError, match="out of range"):
        apply_churn_batches(q, strat, clients[:6])
    assert strat.clustering.engine.n_clients == 6
    np.testing.assert_array_equal(strat.labels, labels0)


def test_signatureless_queue_multibatch_fallback(feds):
    """Without a signature_fn, each batch's newcomers get their OWN
    signatures (the batch's payloads, not the post-drain stack's rows)."""
    (clients, cfg), _ = feds
    full = _port_pacfl(clients[:10], cfg)
    strat = _port_pacfl(clients[:8], cfg)
    q = ChurnQueue()
    q.enqueue_join(clients[8])
    q.enqueue_leave(0)
    q.enqueue_join(clients[9])
    _, _, batches = apply_churn_batches(q, strat, clients[:8])
    assert len(batches) == 2 and batches[0].signatures is None
    U, U_full = strat.clustering.U.numpy(), full.clustering.U.numpy()
    np.testing.assert_allclose(np.abs(U[7]), np.abs(U_full[8]), atol=1e-5)
    np.testing.assert_allclose(np.abs(U[8]), np.abs(U_full[9]), atol=1e-5)


def test_global_strategies_absorb_churn(feds):
    (clients, cfg), _ = feds
    churn = [ChurnEvent(rnd=3, join=clients[10:11], leave=[2])]
    for name in ("fedavg", "ifca", "perfedavg"):
        res = run_federation(name, clients[:10], MLP(128, 10, hidden=(64,)), cfg, seed=0,
                             churn=churn, device="cpu")
        assert len(res.final_accs) == 10 and np.isfinite(res.final_mean)


def test_unsupported_strategy_rejects_churn(feds):
    (clients, cfg), _ = feds
    with pytest.raises(ValueError, match="churn"):
        run_federation("solo", clients[:10], MLP(128, 10, hidden=(64,)), cfg, seed=0,
                       churn=[ChurnEvent(rnd=2, leave=[0])], device="cpu")


# ---------------------------------------------------------------------------
# post-churn local-step refresh
# ---------------------------------------------------------------------------


def _sized(clients, sizes):
    return stack_clients([
        type(c)(c.x_train[:m], c.y_train[:m], c.x_test, c.y_test, c.dataset_name, c.meta)
        for c, m in zip(clients, sizes)
    ])


def test_step_refresh_matches_reference(feds):
    """FedNova's tau follows the post-churn mean size through the same
    bucketed step counts as the reference, memoized per count, and
    Per-FedAvg's rebuild keeps its FO-MAML update."""
    (clients, _), (ref_clients, ref_init, _) = feds
    cfg = FLConfig(local_epochs=2, batch_size=16)
    model = MLP(128, 10, hidden=(64,))
    strat = FedNova(model, lambda s: model.init_params(s, "cpu"), cfg, device="cpu")
    ref = ref_strategies.FedNova(mlp_clf_apply, ref_init, RefFLConfig(local_epochs=2,
                                                                      batch_size=16))
    from repro.fl.client import stack_clients as ref_stack

    strat.setup(0, _sized(clients, [32] * 6))
    ref.setup(jax.random.PRNGKey(0), ref_stack(
        [type(c)(c.x_train[:32], c.y_train[:32], c.x_test, c.y_test) for c in ref_clients[:6]]))
    assert strat._steps == ref._steps
    for sizes in ([128] * 6, [32] * 6, [80] * 6):
        data = _sized(clients, sizes)
        strat.handle_churn(data, None)
        ref.handle_churn(data, None)
        assert strat._steps == ref._steps == bucket_steps(ref._steps_exact)
    assert set(strat._local_cache) == set(ref._local_cache)
    pf = PerFedAvg(model, lambda s: model.init_params(s, "cpu"), cfg, device="cpu")
    pf.setup(0, _sized(clients, [32] * 6))
    pf.handle_churn(_sized(clients, [128] * 6), None)
    assert pf.draw_indices(np.arange(2), torch.Generator().manual_seed(0)).shape == \
        (2, pf._steps, 2, 16)


def test_bucket_steps_equals_reference():
    assert [bucket_steps(s) for s in range(1, 200)] == \
        [ref_strategies.bucket_steps(s) for s in range(1, 200)]
