"""The port's FL strategies on the CPU, held against the JAX reference.

The reference's ``small_fed`` and label-skew configurations
(``tests/test_fl.py``) run through both packages (the port with
``device="cpu"``):

* PACFL labels bitwise equal (eq2 and eq3, and the two-dataset mix);
* communication bytes exactly equal for all ten strategies (sampling and
  model sizes are deterministic);
* every strategy above chance, and each final mean within a band of the
  reference's, derived below from the reference's own seed spread;
* one FedAvg and one PACFL round from converted initial parameters with
  the reference's sampling and minibatch draws: parameters within 1e-4 of
  max|param|.
"""
import jax
import numpy as np
import pytest

from _torch_fl_ref import np_tree, ref_draws, rel_err
from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core.pacfl import PACFLConfig as RefPACFLConfig
from repro.data import make_dataset as ref_make_dataset
from repro.fl import FLConfig as RefFLConfig
from repro.fl import client as ref_client
from repro.fl import label_skew as ref_label_skew
from repro.fl import mix_datasets as ref_mix_datasets
from repro.fl import run_federation as ref_run_federation
from repro.fl import strategies as ref_strategies
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core.pacfl import PACFLConfig
from repro_torch.data import make_dataset
from repro_torch.fl import STRATEGIES, FLConfig, iid_split, label_skew, mix_datasets, run_federation
from repro_torch.fl import strategies
from repro_torch.fl.client import stack_clients
from repro_torch.models.cnn import MLP

PARAM_TOL = 1e-4     # of max|param|


@pytest.fixture(scope="module")
def ds():
    return make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)


@pytest.fixture(scope="module")
def ref_ds():
    return ref_make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)


@pytest.fixture(scope="module")
def small_fed(ds, ref_ds):
    """The reference's ``small_fed`` (tests/test_fl.py), in both packages."""
    cfg_kw = dict(rounds=4, sample_frac=0.34, local_epochs=2, batch_size=16, lr=0.05)
    pac = dict(p=3, beta=20.0, measure="eq2")
    port = (label_skew(ds, 12, rho=0.2, seed=1, test_per_client=80),
            lambda: MLP(ds.dim, ds.n_classes, hidden=(64,)),
            FLConfig(**cfg_kw, pacfl=PACFLConfig(**pac)))
    ref = (ref_label_skew(ref_ds, 12, rho=0.2, seed=1, test_per_client=80),
           lambda key: ref_cnn.init_mlp_clf(key, ref_ds.dim, ref_ds.n_classes, hidden=(64,)),
           RefFLConfig(**cfg_kw, pacfl=RefPACFLConfig(**pac)))
    return port, ref


def _run_port(name, fed, **kw):
    clients, make_model, cfg = fed
    return run_federation(name, clients, make_model(), cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def strategy_runs(small_fed):
    """Every strategy on ``small_fed`` at seed 0, in both packages."""
    port_fed, (ref_clients, ref_init, ref_cfg) = small_fed
    out = {}
    for name in sorted(STRATEGIES):
        ref = ref_run_federation(name, ref_clients, ref_cnn.mlp_clf_apply, ref_init,
                                 ref_cfg, seed=0, eval_every=2)
        out[name] = (_run_port(name, port_fed, seed=0, eval_every=2), ref)
    return out


def test_strategy_sets_match():
    assert sorted(STRATEGIES) == sorted(ref_strategies.STRATEGIES)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_runs_and_learns(strategy_runs, name):
    res, _ = strategy_runs[name]
    assert np.isfinite(res.final_mean)
    assert 0.0 <= res.final_mean <= 1.0
    # better than chance (10 classes) after a few rounds for all methods
    assert res.final_mean > 0.12, (name, res.final_mean)
    assert res.final_accs.shape == (12,)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_communication_bytes_equal_reference(strategy_runs, name):
    """Sampling and model sizes are deterministic, so the byte counters are
    integers equal to the reference's (PACFL's include the signatures)."""
    res, ref = strategy_runs[name]
    assert res.strategy_obj.comm_up == ref.strategy_obj.comm_up
    assert res.strategy_obj.comm_down == ref.strategy_obj.comm_down
    assert [r.rnd for r in res.records] == [r.rnd for r in ref.records]


# The band: the reference's own spread, per strategy.  Its final means on
# small_fed over seeds 0, 1, 2 (CPU, jax 0.9.0), and their range (max - min),
# rounded up at the fourth decimal:
#   fedavg, fedprox, fednova, cfl, pacfl  0.2703 / 0.3262 / 0.3311  0.0608467
#   scaffold                              0.3043 / 0.3370 / 0.2741  0.0629370
#   perfedavg                             0.5642 / 0.6417 / 0.5772  0.0775672
#   solo                                  0.5302 / 0.6126 / 0.5978  0.0824162
#   ifca                                  0.3668 / 0.4257 / 0.3321  0.0935271
#   lg                                    0.3843 / 0.5164 / 0.4206  0.1321539
# (the first five coincide on this 4-round config).  The port draws its own
# minibatches (a different random stream), so its seed-0 run is one more
# draw from that spread: it must lie within its strategy's seed-to-seed
# range of the reference's seed-0 mean.
ACCURACY_BAND = {
    "fedavg": 0.0609, "fedprox": 0.0609, "fednova": 0.0609, "cfl": 0.0609,
    "pacfl": 0.0609, "scaffold": 0.0630, "perfedavg": 0.0776, "solo": 0.0825,
    "ifca": 0.0936, "lg": 0.1322,
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_accuracy_within_band_of_reference(strategy_runs, name):
    res, ref = strategy_runs[name]
    assert abs(res.final_mean - ref.final_mean) <= ACCURACY_BAND[name], (
        name, res.final_mean, ref.final_mean)


def _ref_pacfl_setup(clients, init_fn, cfg):
    strat = ref_strategies.PACFL(ref_cnn.mlp_clf_apply, init_fn, cfg)
    strat.setup(jax.random.PRNGKey(0), ref_client.stack_clients(clients))
    return strat


def _port_pacfl_setup(clients, model, cfg):
    strat = strategies.PACFL(model, lambda s: model.init_params(s, "cpu"), cfg, device="cpu")
    strat.setup(0, stack_clients(clients))
    return strat


def test_pacfl_labels_bitwise_small_fed(small_fed):
    (clients, make_model, cfg), (ref_clients, ref_init, ref_cfg) = small_fed
    port = _port_pacfl_setup(clients, make_model(), cfg)
    ref = _ref_pacfl_setup(ref_clients, ref_init, ref_cfg)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.clustering.signature_bytes == ref.clustering.signature_bytes


@pytest.fixture(scope="module")
def label_skew_fed(ds, ref_ds):
    """``test_pacfl_beats_fedavg_on_label_skew``'s configuration."""
    cfg_kw = dict(rounds=8, sample_frac=0.5, local_epochs=2, batch_size=16, lr=0.05)
    pac = dict(p=3, beta=175.0, measure="eq3")
    return ((label_skew(ds, 16, rho=0.2, seed=2, test_per_client=80),
             lambda: MLP(ds.dim, ds.n_classes, hidden=(64,)),
             FLConfig(**cfg_kw, pacfl=PACFLConfig(**pac))),
            (ref_label_skew(ref_ds, 16, rho=0.2, seed=2, test_per_client=80),
             lambda key: ref_cnn.init_mlp_clf(key, ref_ds.dim, ref_ds.n_classes, hidden=(64,)),
             RefFLConfig(**cfg_kw, pacfl=RefPACFLConfig(**pac))))


def test_pacfl_labels_bitwise_label_skew_eq3(label_skew_fed):
    (clients, make_model, cfg), (ref_clients, ref_init, ref_cfg) = label_skew_fed
    port = _port_pacfl_setup(clients, make_model(), cfg)
    ref = _ref_pacfl_setup(ref_clients, ref_init, ref_cfg)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.clustering.n_clusters > 1


def test_pacfl_beats_fedavg_on_label_skew(label_skew_fed):
    port_fed, _ = label_skew_fed
    r_pacfl = _run_port("pacfl", port_fed, seed=0)
    r_fedavg = _run_port("fedavg", port_fed, seed=0)
    assert r_pacfl.final_mean > r_fedavg.final_mean


def test_pacfl_mix2_two_clusters_bitwise():
    kw = dict(n_train=600, n_test=200, dim=128)
    clients = mix_datasets([make_dataset("cifar10s", **kw), make_dataset("fmnists", **kw)],
                           [5, 5], samples_per_client=120)
    ref_clients = ref_mix_datasets([ref_make_dataset("cifar10s", **kw),
                                    ref_make_dataset("fmnists", **kw)],
                                   [5, 5], samples_per_client=120)
    port = _port_pacfl_setup(clients, MLP(128, 20, hidden=(32,)),
                             FLConfig(pacfl=PACFLConfig(p=3, beta=45.0, measure="eq2")))
    ref = _ref_pacfl_setup(ref_clients,
                           lambda key: ref_cnn.init_mlp_clf(key, 128, 20, hidden=(32,)),
                           RefFLConfig(pacfl=RefPACFLConfig(p=3, beta=45.0, measure="eq2")))
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.clustering.n_clusters == 2
    assert len(set(port.labels[:5])) == 1 and len(set(port.labels[5:])) == 1


def test_pacfl_iid_one_cluster(ds):
    clients = iid_split(ds, 10, seed=3)
    cfg = FLConfig(rounds=1, sample_frac=0.5, local_epochs=1, batch_size=8,
                   lr=0.05, pacfl=PACFLConfig(p=3, beta=20.0, measure="eq2"))
    assert _port_pacfl_setup(clients, MLP(ds.dim, 10, hidden=(32,)), cfg).clustering.n_clusters == 1


def test_pacfl_signature_upload_accounted(strategy_runs, small_fed):
    (clients, _, cfg), _ = small_fed
    strat = strategy_runs["pacfl"][0].strategy_obj
    K, dim, p = len(clients), clients[0].x_train.shape[1], cfg.pacfl.p
    assert strat.clustering.signature_bytes == K * dim * p * 4


def test_ifca_downloads_all_cluster_models(strategy_runs):
    ifca, pacfl = strategy_runs["ifca"][0], strategy_runs["pacfl"][0]
    assert ifca.strategy_obj.comm_down > 1.9 * pacfl.strategy_obj.comm_down


def test_solo_no_communication(strategy_runs):
    strat = strategy_runs["solo"][0].strategy_obj
    assert strat.comm_up == 0 and strat.comm_down == 0


# ---------------------------------------------------------------------------
# one round from converted initial parameters, on the reference's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fedavg", "pacfl"])
def test_one_round_matches_reference(small_fed, label_skew_fed, name):
    fed = small_fed if name == "fedavg" else label_skew_fed
    (clients, make_model, cfg), (ref_clients, ref_init, ref_cfg) = fed
    key = jax.random.PRNGKey(0)
    ref = ref_strategies.STRATEGIES[name](ref_cnn.mlp_clf_apply, ref_init, ref_cfg)
    ref_data = ref_client.stack_clients(ref_clients)
    ref.setup(jax.random.fold_in(key, 0), ref_data)
    model = make_model()
    theta0 = convert.cnn_params_from_numpy("mlp", np_tree(ref_init(jax.random.fold_in(key, 0))),
                                           model=model, device="cpu")
    port = strategies.STRATEGIES[name](model, lambda s: theta0, cfg, device="cpu")
    port.setup(0, stack_clients(clients))
    rng = np.random.default_rng(0)
    K = ref_data.n_clients
    m = max(1, min(K, int(round(cfg.sample_frac * K))))
    sampled = np.sort(rng.choice(K, size=m, replace=False))
    round_key = jax.random.fold_in(key, 1)
    idx = ref_draws(round_key, ref_data.n[sampled], ref._steps, cfg.batch_size)
    ref.run_round(1, sampled, round_key)
    port.run_round(1, sampled, idx)
    if name == "fedavg":
        got, want = port.global_params, ref.global_params
        stacked = False
    else:
        np.testing.assert_array_equal(port.labels, ref.labels)
        got, want = port.cluster_params, ref.cluster_params
        stacked = True
    want = convert.cnn_params_from_numpy("mlp", np_tree(want), stacked=stacked,
                                         model=model, device="cpu")
    assert rel_err(got, want) <= PARAM_TOL
    assert port.comm_up == ref.comm_up and port.comm_down == ref.comm_down
