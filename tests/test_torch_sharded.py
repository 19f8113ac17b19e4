"""The port's ``"sharded"`` proximity backend on the CPU, held against the JAX
reference.

``"sharded"`` is the port of the reference's ``jnp_sharded``: the rows of the
result in contiguous strips, one per device, each strip the proximity
kernel's cross form against the whole stack (on CPU tensors its plain
twin).  Here the strip function ``_proximity_strips`` runs over ``[cpu] * N``
for N = 1-4, so the CPU walks the strip boundaries N cards would.

The reference's own sharded path fails under jax 0.9.0 (its ``shard_map``
output trips ``_hygiene``), so the strips are held against two things that
run: the reference's ``jnp_blocked`` ``proximity_matrix`` /
``cross_proximity`` (as the reference's in-process single-device test
does), and its per-strip function ``_strip_blocks`` (plain ``lax.map``).
Both reshape the two stacks to one rank, so the mixed-rank block (eq2, p =
12 x q = 9) is held against the reference's dense ``jnp`` cross instead.
Without a hygiene pass a client's float32 self-angle is 0.02-0.14 degrees
and differs between the two packages' Gram sums, so raw strips and cross
blocks whose columns repeat their rows are compared off those self pairs.
The tolerance is the reference's ``TOL_DEG`` = 1e-3 degrees.

Also checked: the reference's K = 512 acceptance invariant
(``tests/test_measures_sharded.py``: beta at the 2% quantile, labels from
four strips bitwise those of one strip and of the reference, 1 < clusters <
512), and that ``"sharded"`` reaches every consumer the reference lets
select it: ``one_shot_clustering`` (with and without ``beta_quantile``), a
``ClusterEngine``'s ``admit`` and ``move`` against the full re-cluster
oracle, and a PACFL federation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core import angles as ref_angles
from repro.core.hc import hierarchical_clustering as ref_hc
from repro.core.pacfl import PACFLConfig as RefConfig
from repro.core.pacfl import one_shot_clustering as ref_one_shot
from repro.data import make_dataset as ref_make_dataset
from repro.fl import FLConfig as RefFLConfig
from repro.fl import client as ref_client
from repro.fl import label_skew as ref_label_skew
from repro.fl import strategies as ref_strategies
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core import angles
from repro_torch.core.engine import ClusterEngine, EngineConfig
from repro_torch.core.hc import hierarchical_clustering
from repro_torch.core.pacfl import PACFLConfig, one_shot_clustering
from repro_torch.data import make_dataset
from repro_torch.fl import FLConfig, label_skew, run_federation
from repro_torch.models.cnn import MLP

TOL_DEG = 1e-3
CPU = torch.device("cpu")

# name -> (Ka, Kb, n, p, q, measure, block of _strip_blocks).  Kb None: the
# square; a cross block whose Ub is None below takes Ua's first Kb clients
# (the reference's ragged test, cross_proximity(U[:37], U[:11])).
CASES = {
    "K512-eq3": (512, None, 64, 5, 5, "eq3", 64),
    "K512-eq2": (512, None, 64, 5, 5, "eq2", 64),
    "ragged37-eq3": (37, None, 40, 3, 3, "eq3", 8),
    "ragged37-eq2": (37, None, 40, 3, 3, "eq2", 8),
    "cross37x11-eq3": (37, 11, 40, 3, 3, "eq3", 8),
    "cross37x11-eq2": (37, 11, 40, 3, 3, "eq2", 8),
    "K3-eq3": (3, None, 40, 3, 3, "eq3", 4),
    "K3-eq2": (3, None, 40, 3, 3, "eq2", 4),
    "any-rank-eq2-12x9": (21, 13, 48, 12, 9, "eq2", 8),
    "any-rank-eq3-p12": (21, None, 48, 12, 12, "eq3", 8),
}


def _signatures(K, n, p, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(K)]
    ).astype(np.float32)


def _clustered(K, n=32, p=3, n_bases=4, spread=0.08, seed=0):
    """K orthonormal (n, p) signatures around n_bases planted subspaces."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(np.random.default_rng(1000 + b).standard_normal((n, p)))[0]
             for b in range(n_bases)]
    return np.stack([np.linalg.qr(bases[k % n_bases] + spread * rng.standard_normal((n, p)))[0]
                     for k in range(K)]).astype(np.float32)


def _strips(Ua, Ub, measure, N):
    """The strip function over N strips on the CPU; Ub None is the square."""
    tA = torch.from_numpy(Ua)
    return angles._proximity_strips(
        tA, tA if Ub is None else torch.from_numpy(Ub), measure, [CPU] * N)


def _spy(monkeypatch):
    """Record every call of the strip function (shapes, measure, devices)."""
    calls, real = [], angles._proximity_strips

    def spy(U_a, U_b, measure, devices):
        calls.append((tuple(U_a.shape), tuple(U_b.shape), measure, list(devices)))
        return real(U_a, U_b, measure, devices)

    monkeypatch.setattr(angles, "_proximity_strips", spy)
    return calls


@pytest.fixture(scope="module")
def references():
    """case -> (Ua, Ub or None, the reference's jnp_blocked matrix or block,
    its _strip_blocks over all rows, the self pairs), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            Ka, Kb, n, p, q, measure, bk = CASES[name]
            Ua = _signatures(Ka, n, p, seed=Ka + 7 * p)
            Ub = None
            if Kb is None:
                full = Ua
                want = ref_angles.proximity_matrix(
                    jnp.asarray(Ua), measure, backend="jnp_blocked", block_size=bk)
            elif p == q:
                full = Ua[:Kb]
                want = ref_angles.cross_proximity(
                    jnp.asarray(Ua), jnp.asarray(full), measure, backend="jnp_blocked",
                    block_size=bk)
            else:
                # _strip_blocks, and the jnp_blocked cross built on it, reshape
                # both stacks to one rank: p != q takes the dense jnp cross
                # (measure_pair, its svd solver) in both roles
                full = Ub = _signatures(Kb, n, q, seed=Kb + 3)
                want = ref_angles.cross_proximity(
                    jnp.asarray(Ua), jnp.asarray(Ub), measure, backend="jnp")
            if p == q:
                strip = ref_angles._strip_blocks(
                    ref_angles._pad_rows(jnp.asarray(Ua), bk),
                    ref_angles._pad_rows(jnp.asarray(full), bk), measure, bk, "jacobi")
            else:
                strip = want
            self_pairs = (np.eye(Ka, full.shape[0], dtype=bool) if Ub is None
                          else np.zeros((Ka, full.shape[0]), dtype=bool))
            cache[name] = (Ua, Ub if Kb is None else (Ua[:Kb] if Ub is None else Ub),
                           np.asarray(want), np.asarray(strip)[:Ka, :full.shape[0]], self_pairs)
        return cache[name]

    return get


@pytest.mark.parametrize("N", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_strips_match_reference(references, case, N):
    measure = CASES[case][5]
    square = CASES[case][1] is None
    Ua, Ub, want, want_strip, self_pairs = references(case)
    got = _strips(Ua, None if square else Ub, measure, N).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    off = ~self_pairs
    np.testing.assert_allclose(got[off], want_strip[off], atol=TOL_DEG)
    if square:
        got = angles._hygiene(torch.from_numpy(got)).numpy()
        assert (got == got.T).all() and (np.diag(got) == 0).all()
        np.testing.assert_allclose(got, want, atol=TOL_DEG)
    else:
        np.testing.assert_allclose(got[off], want[off], atol=TOL_DEG)


@pytest.mark.parametrize("Ka,N", [(37, 4), (3, 4), (2, 3), (8, 3)])
def test_strips_split_rows_as_tensor_split(monkeypatch, Ka, N):
    """Strip i takes the rows torch.tensor_split gives it; empty strips are
    skipped (Ka < N), and nothing is padded."""
    import repro_torch.kernels.proximity as kprox

    rows, real = [], kprox.proximity_cross

    def spy(Ua, Ub, measure, out=None):
        rows.append((int(Ua.shape[0]), int(Ub.shape[0])))
        return real(Ua, Ub, measure, out=out)

    monkeypatch.setattr(kprox, "proximity_cross", spy)
    U = _signatures(Ka, 24, 3, seed=Ka)
    _strips(U, None, "eq3", N)
    want = [len(s) for s in torch.tensor_split(torch.arange(Ka), N) if len(s)]
    assert rows == [(r, Ka) for r in want]


@pytest.mark.parametrize("measure", ["eq2", "eq3"])
def test_k512_labels_bitwise(references, measure):
    """The reference's K = 512 acceptance: beta at the 2% quantile, HC labels
    from four strips bitwise those of one strip and of the reference's
    jnp_blocked path, on a partition with 1 < clusters < 512."""
    Ua, _, A_ref, _, _ = references(f"K512-{measure}")
    beta = float(np.quantile(A_ref[A_ref > 0], 0.02))
    ref_labels = ref_hc(A_ref, beta=beta)
    A1 = angles._hygiene(_strips(Ua, None, measure, 1)).numpy()
    A4 = angles._hygiene(_strips(Ua, None, measure, 4)).numpy()
    labels = hierarchical_clustering(A4, beta=beta)
    np.testing.assert_array_equal(labels, hierarchical_clustering(A1, beta=beta))
    np.testing.assert_array_equal(ref_hc(A4, beta=beta), ref_labels)
    np.testing.assert_array_equal(labels, ref_labels)
    assert 1 < int(labels.max()) + 1 < 512


@pytest.mark.parametrize("measure", ["eq2", "eq3"])
def test_backend_on_cpu_is_the_kernel_twin(monkeypatch, measure):
    """On CPU tensors ``"sharded"`` is one strip on the CPU: the ``"kernel"``
    backend's plain twin, bit for bit, square and cross."""
    calls = _spy(monkeypatch)
    U = torch.from_numpy(_clustered(30, seed=3))
    for fn, args in ((angles.proximity_matrix, (U,)), (angles.cross_proximity, (U, U[:7]))):
        got = fn(*args, measure, backend="sharded")
        assert torch.equal(got, fn(*args, measure, backend="kernel"))
    assert [c[3] for c in calls] == [[CPU], [CPU]]


def test_backend_resolution_and_refusals():
    cpu, card = CPU, torch.device("cuda", 0)
    assert angles._resolve_backend("sharded", 8, cpu) == "sharded"
    assert angles._resolve_backend("sharded", 8, card) == "sharded"
    # "auto" never resolves to the sharded backend (opt-in, as in the reference)
    assert {angles._resolve_backend("auto", K, d) for K in (8, 4096, 10**6)
            for d in (cpu, card)} == {"torch", "torch_blocked", "kernel"}
    assert angles._resolve_eq2_solver("auto", "sharded") == "jacobi"
    assert angles._strip_devices(cpu) == [cpu]
    U = torch.from_numpy(_signatures(3, 24, 3, seed=0))
    with pytest.raises(ValueError, match="jacobi"):
        angles.proximity_matrix(U, "eq2", backend="sharded", eq2_solver="svd")
    with pytest.raises(ValueError, match="jacobi"):
        angles.cross_proximity(U, U, "eq2", backend="sharded", eq2_solver="eigh")
    # a strip never leaves the input's kind of device, and there is one at least
    for devices in ([card], [cpu, card], []):
        with pytest.raises(ValueError, match="strips"):
            angles._proximity_strips(U, U, "eq3", devices)
    # nor are operands on two devices moved to one
    with pytest.raises(ValueError, match="operands on"):
        angles._proximity_strips(U, U.to(torch.device("meta")), "eq3", [cpu])


# ---------------------------------------------------------------------------
# the consumers: one-shot clustering, the engine, a PACFL federation
# ---------------------------------------------------------------------------

N_FEAT, RANK, N_BASES = 48, 3, 4


def _federation(seed, n_clients):
    """Ragged clients on N_BASES planted subspaces with a decaying spectrum."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(np.random.default_rng(100 + b).normal(size=(N_FEAT, RANK)))[0]
             for b in range(N_BASES)]
    data = []
    for k in range(n_clients):
        M = int(rng.integers(20, 90))
        Bk = np.linalg.qr(bases[k % N_BASES]
                          + 0.15 / np.sqrt(N_FEAT) * rng.normal(size=(N_FEAT, RANK)))[0]
        coef = np.array([8.0, 3.0, 1.0])[:, None] * rng.normal(size=(RANK, M))
        data.append((Bk @ coef + 0.05 * rng.normal(size=(N_FEAT, M))).astype(np.float32))
    return data


@pytest.mark.parametrize("beta_quantile", [None, 0.2])
@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_one_shot_clustering_through_sharded(monkeypatch, measure, beta_quantile):
    """A reference config naming ``jnp_sharded`` converts to ``"sharded"``
    and clusters as the reference's ``jnp_blocked`` path does."""
    calls = _spy(monkeypatch)
    data = _federation(0, 24)
    kw = dict(p=RANK, measure=measure, svd_method="exact",
              beta=100.0 if measure == "eq3" else 25.0, beta_quantile=beta_quantile)
    cfg = convert.config_from_reference(
        dataclasses.asdict(RefConfig(proximity_backend="jnp_sharded", **kw)))
    assert cfg.proximity_backend == "sharded"
    port = one_shot_clustering(data, cfg, device="cpu")
    ref = ref_one_shot([jnp.asarray(D) for D in data],
                       RefConfig(proximity_backend="jnp_blocked", **kw))
    assert len(calls) == 1 and calls[0][3] == [CPU]
    np.testing.assert_allclose(port.A, np.asarray(ref.A), atol=TOL_DEG)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert 1 < port.n_clusters < 24


def _canon(labels):
    """Canonical relabel by first occurrence (partition comparison)."""
    seen = {}
    return np.array([seen.setdefault(int(x), len(seen)) for x in labels])


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_engine_admit_and_move_through_sharded(monkeypatch, measure):
    """A ``ClusterEngine`` on ``"sharded"``: after every admit and move its
    labels equal a full re-cluster of its store (the reference's engine
    test for jnp_sharded) and the ``"kernel"`` engine's."""
    calls = _spy(monkeypatch)
    U = _clustered(24, seed=5)
    A0 = angles.proximity_matrix(torch.from_numpy(U), measure, backend="torch").numpy()
    cfg = EngineConfig(beta=float(np.quantile(A0[A0 > 0], 0.15)), measure=measure,
                       backend="sharded")
    eng = ClusterEngine.from_signatures(torch.from_numpy(U), cfg, device="cpu")
    twin = ClusterEngine.from_signatures(
        torch.from_numpy(U), dataclasses.replace(cfg, backend="kernel"), device="cpu")
    ops = [("admit", 3), ("move", 2), ("admit", 1), ("move", 4), ("admit", 5)]
    for step, (op, size) in enumerate(ops):
        U_new = torch.from_numpy(_clustered(size, seed=50 + step, spread=0.3))
        before = len(calls)
        for e in (eng, twin):
            if op == "admit":
                e.admit(U_new)
            else:
                ids = np.sort(np.random.default_rng(step).choice(e.ids, size=size,
                                                                replace=False))
                e.move(ids, U_new)
        assert len(calls) > before, op
        oracle = hierarchical_clustering(eng.dense(np.float64), beta=cfg.beta,
                                         linkage=cfg.linkage)
        np.testing.assert_array_equal(_canon(oracle), _canon(eng.canonical_labels))
        np.testing.assert_array_equal(eng.labels, twin.labels)
        np.testing.assert_array_equal(eng.dense(), twin.dense())


def test_pacfl_federation_through_sharded(monkeypatch):
    """The reference's ``small_fed`` (tests/test_fl.py) at 2 rounds: PACFL on
    ``"sharded"`` clusters as the reference's PACFL does and trains as the
    ``"kernel"`` backend's run does, bit for bit on the CPU."""
    ds = make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)
    clients = label_skew(ds, 12, rho=0.2, seed=1, test_per_client=80)
    cfg_kw = dict(rounds=2, sample_frac=0.34, local_epochs=2, batch_size=16, lr=0.05)
    pac = dict(p=3, beta=20.0, measure="eq2")
    runs = {}
    for backend in ("sharded", "kernel"):
        calls = _spy(monkeypatch) if backend == "sharded" else None
        cfg = FLConfig(**cfg_kw, pacfl=PACFLConfig(**pac, proximity_backend=backend))
        runs[backend] = run_federation("pacfl", clients, MLP(ds.dim, ds.n_classes, hidden=(64,)),
                                       cfg, seed=0, device="cpu")
        if calls is not None:
            assert calls, "PACFL never reached the sharded backend"
            monkeypatch.undo()
    got, want = runs["sharded"], runs["kernel"]
    np.testing.assert_array_equal(got.strategy_obj.labels, want.strategy_obj.labels)
    np.testing.assert_array_equal(got.final_accs, want.final_accs)
    assert np.isfinite(got.final_accs).all()

    ref_ds = ref_make_dataset("cifar10s", n_train=1200, n_test=400, dim=128, seed=0)
    ref_clients = ref_label_skew(ref_ds, 12, rho=0.2, seed=1, test_per_client=80)
    ref_cfg = RefFLConfig(**cfg_kw, pacfl=RefConfig(**pac, proximity_backend="jnp_blocked"))
    ref = ref_strategies.PACFL(
        ref_cnn.mlp_clf_apply,
        lambda key: ref_cnn.init_mlp_clf(key, ref_ds.dim, ref_ds.n_classes, hidden=(64,)),
        ref_cfg)
    ref.setup(jax.random.PRNGKey(0), ref_client.stack_clients(ref_clients))
    np.testing.assert_array_equal(got.strategy_obj.labels, ref.labels)
