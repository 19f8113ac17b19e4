"""The port's drift tracker and fused ``move`` on the CPU, held against the
JAX reference.

``repro_torch.core.engine.drift`` is the reference's NumPy module with only
its import paths changed (checked below).  Engines of both packages adopt
the same float32 proximity matrix and signatures, so:

* ``DriftTracker.observe`` gives the reference's report, field for field,
  under all five memory tiers; after a fused ``move`` (whose cross blocks
  each package computes itself, within ``TOL_DEG``) the labels, sizes and
  split / merge candidates are equal and the dispersions within ``TOL_DEG``;
* ``ClusterEngine.move`` meets the reference's ``move_parity`` contract
  (``benchmarks/proximity_scale.py``) under every tier: canonical labels
  equal to the sequential depart-then-admit and to a full re-cluster, every
  tier bitwise equal to the dense one, and labels equal to the reference's;
* an oracle fuzz in the shape of ``tests/test_engine_fuzz.py``: interleaved
  admit / depart / move schedules, checked after every op against the full
  re-cluster oracle and its merge script, all tiers bitwise equal, and the
  drift report tier-independent.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core.engine import ClusterEngine as RefEngine
from repro.core.engine import DriftTracker as RefTracker
from repro.core.engine import EngineConfig as RefEngineConfig
from repro_torch.core.engine import ClusterDrift, ClusterEngine, DriftReport, DriftTracker, EngineConfig
from repro_torch.core.hc import hierarchical_clustering
from repro_torch.kernels.proximity import proximity_plain

ROOT = Path(__file__).resolve().parents[1]
TOL_DEG = 1e-3   # the reference's cross-backend proximity tolerance

MEMORY_TIERS = (
    ("dense", {"memory": "dense"}),
    ("banded", {"memory": "banded", "band_rows": 8}),
    ("condensed_only", {"memory": "condensed_only"}),
    ("spilled", {"memory": "spilled", "memory_budget_bytes": 1 << 12,
                 "spill_segment_rows": 16}),
    ("auto", {"memory": "auto"}),
)


def _clustered(K, n=32, p=3, n_bases=4, spread=0.08, seed=0):
    """K orthonormal (n, p) signatures around n_bases planted subspaces."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(np.random.default_rng(1000 + b).standard_normal((n, p)))[0]
             for b in range(n_bases)]
    out = [np.linalg.qr(bases[k % n_bases] + spread * rng.standard_normal((n, p)))[0]
           for k in range(K)]
    return np.stack(out).astype(np.float32)


def _matrix(U, measure):
    """The float32 proximity matrix both packages' engines adopt."""
    A = proximity_plain(torch.as_tensor(U), torch.as_tensor(U), measure).numpy()
    A = 0.5 * (A + A.T)
    np.fill_diagonal(A, 0.0)
    return A.astype(np.float32)


def _engines(mem_kw, *, K=24, beta=55.0, measure="eq2", **cfg_kw):
    U = _clustered(K)
    A = _matrix(U, measure)
    port = ClusterEngine.from_proximity(
        A, torch.as_tensor(U), EngineConfig(beta=beta, measure=measure, **mem_kw, **cfg_kw),
        device="cpu")
    ref = RefEngine.from_proximity(
        A, jnp.asarray(U), RefEngineConfig(beta=beta, measure=measure, **mem_kw, **cfg_kw))
    return port, ref


def _assert_reports_equal(got, want, exact=True):
    assert (got.version, got.n_clients, got.threshold_deg) == (
        want.version, want.n_clients, want.threshold_deg)
    assert got.split_candidates == want.split_candidates
    assert [(a, b) for a, b, _ in got.merge_candidates] == [
        (a, b) for a, b, _ in want.merge_candidates]
    assert len(got.clusters) == len(want.clusters)
    for cg, cr in zip(got.clusters, want.clusters):
        assert (cg.label, cg.size) == (cr.label, cr.size)
        if exact:   # the two packages' dataclasses: compare their fields
            assert dataclasses.astuple(cg) == dataclasses.astuple(cr)
        else:
            for f in ("mean_intra_deg", "max_intra_deg"):
                assert abs(getattr(cg, f) - getattr(cr, f)) <= TOL_DEG
            assert (cg.delta_mean_deg is None) == (cr.delta_mean_deg is None)
            if cg.delta_mean_deg is not None:
                assert abs(cg.delta_mean_deg - cr.delta_mean_deg) <= 2 * TOL_DEG
    if exact:
        assert got.merge_candidates == want.merge_candidates
    else:
        for (_, _, dg), (_, _, dr) in zip(got.merge_candidates, want.merge_candidates):
            assert abs(dg - dr) <= TOL_DEG


def test_drift_module_is_the_references_with_port_imports():
    port = (ROOT / "src/repro_torch/core/engine/drift.py").read_text()
    ref = (ROOT / "src/repro/core/engine/drift.py").read_text()
    assert port.replace("repro_torch.", "repro.") == ref


def test_exports():
    import repro_torch.core.engine as engine

    for name in ("ClusterDrift", "DriftReport", "DriftTracker"):
        assert name in engine.__all__ and hasattr(engine, name)
    assert ClusterDrift.__module__ == DriftReport.__module__ == "repro_torch.core.engine.drift"


@pytest.mark.parametrize("tier,mem_kw", MEMORY_TIERS, ids=[t for t, _ in MEMORY_TIERS])
def test_observe_equals_reference(tier, mem_kw):
    port, ref = _engines(mem_kw)
    tr, ref_tr = DriftTracker(), RefTracker()
    _assert_reports_equal(tr.observe(port), ref_tr.observe(ref))
    # a threshold under the widest cluster's dispersion flags splits; one
    # above every distance flags every pair for merging
    tight = DriftTracker(threshold_deg=20.0).observe(port)
    loose = DriftTracker(threshold_deg=180.0).observe(port)
    assert tight.split_candidates != ()
    assert len(loose.merge_candidates) == len(loose.clusters) * (len(loose.clusters) - 1) // 2
    _assert_reports_equal(tight, RefTracker(threshold_deg=20.0).observe(ref))
    _assert_reports_equal(loose, RefTracker(threshold_deg=180.0).observe(ref))
    rep2 = tr.observe(port)
    assert all(c.delta_mean_deg == 0.0 for c in rep2.clusters)
    _assert_reports_equal(rep2, ref_tr.observe(ref))


@pytest.mark.parametrize("tier,mem_kw", MEMORY_TIERS, ids=[t for t, _ in MEMORY_TIERS])
def test_observe_after_move_equals_reference(tier, mem_kw):
    """Refreshing two members with noisier signatures widens their cluster;
    both trackers, keyed by stable labels, see the same delta."""
    port, ref = _engines(mem_kw)
    tr, ref_tr = DriftTracker(), RefTracker()
    tr.observe(port)
    ref_tr.observe(ref)
    U_mv = _clustered(2, spread=0.5, seed=77)
    port.move(port.ids[:2], torch.as_tensor(U_mv))
    ref.move(ref.ids[:2], jnp.asarray(U_mv))
    np.testing.assert_array_equal(port.labels, ref.labels)
    got, want = tr.observe(port), ref_tr.observe(ref)
    _assert_reports_equal(got, want, exact=False)
    deltas = [c.delta_mean_deg for c in got.clusters if c.delta_mean_deg is not None]
    assert deltas and any(abs(d) > 0 for d in deltas)


def test_n_clusters_mode_needs_explicit_threshold():
    U = _clustered(16)
    eng = ClusterEngine.from_signatures(
        torch.as_tensor(U), EngineConfig(n_clusters=3, measure="eq2"), device="cpu")
    with pytest.raises(ValueError, match="n_clusters mode"):
        DriftTracker().observe(eng)
    rep = DriftTracker(threshold_deg=50.0).observe(eng)
    assert rep.threshold_deg == 50.0 and len(rep.clusters) == 3
    assert rep.drift_of(rep.clusters[0].label) is rep.clusters[0]
    assert rep.drift_of(10**9) is None


# ---------------------------------------------------------------------------
# the fused move: the reference's move_parity contract
# ---------------------------------------------------------------------------


def test_move_parity_contract_every_tier():
    """``benchmarks/proximity_scale.py::_move_parity_rows`` at a small size
    (K = 48, 6 movers, eq3, beta at the 5% quantile): under every tier the
    fused move's canonical labels equal the sequential depart-then-admit's
    and a full re-cluster's; every tier equals the dense one bitwise; and
    the labels equal the reference's engine given the same matrix."""
    K, B = 48, 6
    movers = np.arange(10, 10 + B, dtype=np.int64)
    U_all = _clustered(K + B, n_bases=8, seed=7)
    U_ref = U_all[K:]
    A = _matrix(U_all[:K], "eq3")
    beta = float(np.quantile(A[A > 0], 0.05))
    results = {}
    for tier, mem_kw in MEMORY_TIERS:
        cfg = EngineConfig(beta=beta, measure="eq3", **mem_kw)
        eng = ClusterEngine.from_proximity(A, torch.as_tensor(U_all[:K]), cfg, device="cpu")
        seq = eng.copy()
        res = eng.move(movers, torch.as_tensor(U_ref))
        seq.depart(movers)
        seq.admit(torch.as_tensor(U_ref))
        oracle = hierarchical_clustering(eng.dense(np.float64), beta=beta, linkage="average")
        np.testing.assert_array_equal(res.canonical, seq.canonical_labels, err_msg=tier)
        np.testing.assert_array_equal(res.canonical, oracle, err_msg=tier)
        results[tier] = (eng.labels.copy(), eng.canonical_labels.copy())
        ref = RefEngine.from_proximity(
            A, jnp.asarray(U_all[:K]), RefEngineConfig(beta=beta, measure="eq3", **mem_kw))
        ref_res = ref.move(movers, jnp.asarray(U_ref))
        np.testing.assert_array_equal(eng.labels, ref.labels, err_msg=tier)
        np.testing.assert_array_equal(res.canonical, ref_res.canonical, err_msg=tier)
        np.testing.assert_array_equal(eng.ids, ref.ids, err_msg=tier)
    for tier, (s, c) in results.items():
        np.testing.assert_array_equal(s, results["dense"][0], err_msg=tier)
        np.testing.assert_array_equal(c, results["dense"][1], err_msg=tier)


# ---------------------------------------------------------------------------
# oracle fuzz (tests/test_engine_fuzz.py's shape)
# ---------------------------------------------------------------------------


def canon(labels):
    """Canonical relabel by first occurrence (partition comparison)."""
    seen = {}
    return np.array([seen.setdefault(int(x), len(seen)) for x in labels])


def _check_oracle_and_script(eng, cfg, ctx):
    """The engine's partition and cached script match a full re-cluster."""
    kw = {"n_clusters": cfg.n_clusters} if cfg.n_clusters is not None else {"beta": cfg.beta}
    oracle = hierarchical_clustering(eng.dense(np.float64), linkage=cfg.linkage, **kw)
    assert (canon(oracle) == canon(eng.canonical_labels)).all(), ctx
    fresh = ClusterEngine.from_proximity(eng.store.dense(), eng.U, cfg, device="cpu")
    assert [(a, b) for a, b, _ in eng._script] == [(a, b) for a, b, _ in fresh._script], ctx
    np.testing.assert_allclose([h for _, _, h in eng._script],
                               [h for _, _, h in fresh._script], rtol=1e-6, err_msg=str(ctx))


def _schedule(rng, n_ops=6):
    kinds = np.array(["admit", "depart", "move"])
    return [(str(kinds[rng.integers(0, 3)]), int(rng.integers(1, 5))) for _ in range(n_ops)]


def _drive(eng, schedule, sig_of, rng):
    """Apply one schedule to one engine; yields after every op."""
    for step, (op, size) in enumerate(schedule):
        if op == "depart" and eng.n_clients > size + 4:
            eng.depart(np.sort(rng.choice(eng.ids, size=size, replace=False)))
        elif op == "move" and eng.n_clients > size + 4:
            ids = np.sort(rng.choice(eng.ids, size=size, replace=False))
            eng.move(ids, sig_of(step, size))
        else:   # admit: also the fallback when the roster is too small
            eng.admit(sig_of(step, size))
        yield step


@pytest.mark.parametrize("linkage", ["average", "complete"])
@pytest.mark.parametrize("mode", ["beta", "n_clusters"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interleaved_schedule_tracks_oracle_all_tiers(seed, mode, linkage):
    U0 = torch.as_tensor(_clustered(20, seed=seed))
    schedule = _schedule(np.random.default_rng(seed))
    mode_kw = ({"beta": 55.0, "measure": "eq2"} if mode == "beta"
               else {"n_clusters": 4, "measure": "eq2"})

    def sig_of(step, size):
        return torch.as_tensor(_clustered(size, seed=100 * (seed + 1) + step))

    per_tier = {}
    for tier, mem_kw in MEMORY_TIERS:
        cfg = EngineConfig(linkage=linkage, **mode_kw, **mem_kw)
        eng = ClusterEngine.from_signatures(U0, cfg, device="cpu")
        rng = np.random.default_rng([seed, 1])   # same draws per tier
        tracker = DriftTracker(threshold_deg=55.0)
        snaps = []
        for step in _drive(eng, schedule, sig_of, rng):
            if tier == "dense":
                _check_oracle_and_script(eng, cfg, (seed, mode, linkage, step))
            rep = tracker.observe(eng)
            snaps.append((eng.labels.copy(), eng.canonical_labels.copy(),
                          rep.split_candidates, [(a, b) for a, b, _ in rep.merge_candidates],
                          [(c.label, c.size) for c in rep.clusters]))
        per_tier[tier] = snaps
    for tier, snaps in per_tier.items():
        for got, want in zip(snaps, per_tier["dense"]):
            np.testing.assert_array_equal(got[0], want[0], err_msg=tier)
            np.testing.assert_array_equal(got[1], want[1], err_msg=tier)
            assert got[2:] == want[2:], tier
