"""The port's AssignmentServer on the CPU, held against the JAX reference.

Both packages adopt the same float32 proximity matrix over the same
seeded signatures, so their engines are bitwise equal; then

* served assignments equal the reference's ``admit_oracle`` flow bitwise
  (``tests/test_serving.py``'s parity contract) and the reference server's
  own answers;
* batch splits, ragged eq2 buckets, the empty engine, snapshot isolation
  across a drain, predicted stable ids and leave-by-stable-id behave as in
  the reference;
* ``python -m repro_torch.launch.assign_serve --device cpu`` runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_ref import one_torch_thread  # noqa: F401 (fixture)
from repro.core.angles import proximity_matrix as ref_proximity_matrix
from repro.core.engine import ClusterEngine as RefEngine
from repro.core.engine import EngineConfig as RefEngineConfig
from repro.serving import AssignmentServer as RefServer
from repro.serving import admit_oracle as ref_admit_oracle
from repro_torch.core.engine import ClusterEngine, EngineConfig
from repro_torch.launch import assign_serve
from repro_torch.serving import AssignmentServer, admit_oracle

N, P = 32, 3


def _signatures(K, n_bases, *, p=P, n=N, spread=0.05, seed=0):
    """K orthonormal (n, p) float32 signatures; client k near base k mod
    n_bases (bases fixed by the seed, noise per call)."""
    bases = np.random.default_rng(1000 + n + p)
    bases = [np.linalg.qr(bases.standard_normal((n, p)))[0] for _ in range(8)]
    rng = np.random.default_rng(seed)
    out = [np.linalg.qr(bases[k % n_bases] + spread * rng.standard_normal((n, p)))[0]
           for k in range(K)]
    return np.stack(out).astype(np.float32)


def _engines(K=60, n_bases=6, measure="eq3"):
    """(port engine, reference engine, query pool, beta) over the same
    float32 matrix; beta sits in the gap between intra- and inter-base
    distances (the reference fixture's regime)."""
    U = _signatures(K, n_bases)
    A = np.asarray(ref_proximity_matrix(jnp.asarray(U), measure, backend="jnp_blocked"))
    base = np.arange(K) % n_bases
    same = base[:, None] == base[None, :]
    off = ~np.eye(K, dtype=bool)
    intra_max, inter_min = float(A[same & off].max()), float(A[~same].min())
    assert intra_max < inter_min, "fixture needs separated clusters"
    beta = 0.5 * (intra_max + inter_min)
    port = ClusterEngine.from_proximity(A, torch.as_tensor(U),
                                        EngineConfig(beta=beta, measure=measure), device="cpu")
    ref = RefEngine.from_proximity(A, jnp.asarray(U), RefEngineConfig(beta=beta, measure=measure))
    np.testing.assert_array_equal(port.labels, ref.labels)
    pool = _signatures(16, n_bases, seed=1)
    return port, ref, pool, beta


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
def test_assignments_bitwise_vs_reference_admit_oracle(measure):
    port_eng, ref_eng, pool, _ = _engines(measure=measure)
    server = AssignmentServer(port_eng, batch_max=8)
    res = server.assign(torch.as_tensor(pool[:12]))
    ref_res = RefServer(ref_eng, batch_max=8).assign(jnp.asarray(pool[:12]))
    np.testing.assert_array_equal(res.labels, ref_res.labels)
    np.testing.assert_array_equal(res.new_cluster, ref_res.new_cluster)
    np.testing.assert_allclose(res.distances, ref_res.distances, atol=1e-3)
    for i in range(12):
        lbl, is_new = ref_admit_oracle(ref_eng, jnp.asarray(pool[i]))
        assert (lbl, is_new) == admit_oracle(port_eng, torch.as_tensor(pool[i]))
        if is_new:
            assert res.new_cluster[i] and res.labels[i] == -1
        else:
            assert not res.new_cluster[i] and int(res.labels[i]) == lbl
    # the live engine is untouched by the oracle
    assert port_eng.n_clients == ref_eng.n_clients == 60


def test_far_query_opens_new_cluster():
    port_eng, ref_eng, _, _ = _engines()
    far = np.linalg.qr(np.random.default_rng(99).standard_normal((N, P)))[0].astype(np.float32)
    res = AssignmentServer(port_eng).assign(torch.as_tensor(far))
    assert admit_oracle(port_eng, torch.as_tensor(far)) == ref_admit_oracle(
        ref_eng, jnp.asarray(far))
    assert ref_admit_oracle(ref_eng, jnp.asarray(far))[1]
    assert bool(res.new_cluster[0]) and res.labels[0] == -1


def test_batched_equals_one_by_one():
    port_eng, _, pool, _ = _engines()
    server = AssignmentServer(port_eng, batch_max=5)   # forces chunking too
    batched = server.assign(torch.as_tensor(pool[:13]))
    for i in range(13):
        single = server.assign(torch.as_tensor(pool[i]))
        assert int(single.labels[0]) == int(batched.labels[i])
        assert bool(single.new_cluster[0]) == bool(batched.new_cluster[i])


def test_ragged_eq2_buckets_in_input_order():
    port_eng, ref_eng, _, _ = _engines(measure="eq2")
    qs = [_signatures(1, 1, seed=41)[0], _signatures(1, 1, p=2, seed=42)[0],
          _signatures(1, 1, seed=43)[0], _signatures(1, 1, p=2, seed=44)[0]]
    server = AssignmentServer(port_eng)
    many = server.assign_many([torch.as_tensor(q) for q in qs])
    ref_many = RefServer(ref_eng).assign_many([jnp.asarray(q) for q in qs])
    np.testing.assert_array_equal(many.labels, ref_many.labels)
    for i, q in enumerate(qs):
        single = server.assign(torch.as_tensor(q))
        assert int(single.labels[0]) == int(many.labels[i])
    with pytest.raises(ValueError, match="ambient"):
        server.assign_many([torch.as_tensor(_signatures(1, 1, n=16, seed=45)[0])])


def test_empty_engine_serves_unassigned():
    server = AssignmentServer(ClusterEngine(EngineConfig(), device="cpu"))
    res = server.assign(torch.as_tensor(_signatures(3, 3)))
    assert np.array_equal(res.labels, np.full(3, -1))
    assert res.new_cluster.all() and np.isinf(res.distances).all()


def test_snapshot_isolation_across_drain():
    port_eng, ref_eng, pool, _ = _engines()
    servers = (AssignmentServer(port_eng), RefServer(ref_eng))
    queries = pool[:6]
    joins = [_signatures(1, 1, seed=50 + i)[0] for i in range(3)]
    out = []
    for server, conv in zip(servers, (torch.as_tensor, jnp.asarray)):
        snap0 = server.snapshot
        res0 = server.assign(conv(queries))
        predicted = [server.submit_join(conv(j)) for j in joins]
        # nothing applied yet: the live snapshot still answers epoch 0
        assert server.assign(conv(queries)).epoch == snap0.epoch
        report = server.drain()
        assert report.joins == 3 and report.pending == 0
        assert server.epoch == snap0.epoch + 1
        assert predicted == [int(i) for i in server._write.ids[-3:]]
        # the held snapshot answers bitwise as before the drain
        held = server.assign(conv(queries), snapshot=snap0)
        assert held.epoch == snap0.epoch
        assert np.array_equal(held.labels, res0.labels)
        out.append((predicted, server.assign(conv(queries)).labels,
                    np.asarray(server._write.labels)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])


def test_submit_leave_by_stable_id():
    port_eng, ref_eng, _, _ = _engines()
    for eng, server in ((port_eng, AssignmentServer(port_eng)), (ref_eng, RefServer(ref_eng))):
        victim = int(eng.ids[4])
        server.submit_leave(victim)
        report = server.drain()
        assert report.leaves == 1
        assert victim not in eng.ids.tolist()
        with pytest.raises(KeyError):
            server.submit_leave(victim)
    np.testing.assert_array_equal(port_eng.ids, ref_eng.ids)
    np.testing.assert_array_equal(port_eng.labels, ref_eng.labels)


def test_leave_of_predicted_join_id():
    port_eng, _, _, _ = _engines()
    server = AssignmentServer(port_eng)
    K0 = port_eng.n_clients
    cid = server.submit_join(torch.as_tensor(_signatures(1, 1, seed=60)[0]))
    server.submit_leave(cid)   # join + leave of the same queued client
    server.drain()
    assert port_eng.n_clients == K0 and cid not in port_eng.ids.tolist()


def test_representative_cache_reused_across_epochs():
    port_eng, _, _, _ = _engines()
    server = AssignmentServer(port_eng)
    C = server.reps.rep_labels.size
    rebuilt0 = server.reps.rebuilt
    server.submit_join(torch.as_tensor(_signatures(1, 1, seed=61)[0]))
    server.drain()
    assert server.reps.reused >= C - 1
    assert server.reps.rebuilt <= rebuilt0 + 2


def test_assign_serve_launcher_cpu(capsys):
    out = assign_serve.main(["--clients", "48", "--queries", "16", "--batch", "8",
                             "--n-bases", "6", "--churn", "4", "--device", "cpu"])
    assert out["p50_ms"] > 0 and out["clusters"] >= 1
    assert out["drain"].joins == 4 and out["drain"].epoch == 1
    assert "held pre-drain snapshot still answers epoch 0" in capsys.readouterr().out
