"""The port's slice as a whole on the CPU, held against the JAX reference.

One-shot clustering -> PME admission -> assignment serving, at a small size
(K = 24 ragged clients, n = 48, p = 3).  Inputs are made with numpy from a
seed and fed to both packages; ``repro_torch.convert`` carries the
reference's state (config, proximity matrix, signatures) across.

* proximity entries agree within ``TOL_DEG`` = 1e-3 degrees (the
  reference's cross-backend tolerance) and cluster labels are equal;
* engines adopting the **same** float32 matrix give bitwise-equal labels
  and merge scripts under every memory tier (the engine is NumPy code
  copied verbatim);
* the port imports without JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ClusterEngine as RefEngine
from repro.core.pacfl import PACFLConfig as RefConfig
from repro.core.pacfl import engine_config as ref_engine_config
from repro.core.pacfl import one_shot_clustering as ref_one_shot
from repro.serving import RepresentativeCache as RefCache
from repro.serving import serve_assign as ref_serve_assign
from repro_torch import convert
from repro_torch.core.pacfl import compute_signatures, one_shot_clustering
from repro_torch.serving import RepresentativeCache, pow2_bucket, serve_assign

ROOT = Path(__file__).resolve().parents[1]
TOL_DEG = 1e-3
N, P, K, N_BASES = 48, 3, 24, 4
MEMORY_TIERS = ("dense", "banded", "condensed_only", "spilled", "auto")


def _federation(seed, n_clients, clusters=None):
    """Ragged clients on N_BASES planted subspaces with a decaying spectrum
    (distinct singular values keep eq3's identically ordered pairs stable)."""
    rng = np.random.default_rng(seed)
    bases = [np.linalg.qr(np.random.default_rng(100 + b).normal(size=(N, P)))[0]
             for b in range(N_BASES)]
    clusters = [k % N_BASES for k in range(n_clients)] if clusters is None else clusters
    data = []
    for c in clusters:
        M = int(rng.integers(20, 90))
        Bk = np.linalg.qr(bases[c] + 0.15 / np.sqrt(N) * rng.normal(size=(N, P)))[0]
        coef = np.array([8.0, 3.0, 1.0])[:, None] * rng.normal(size=(P, M))
        data.append((Bk @ coef + 0.05 * rng.normal(size=(N, M))).astype(np.float32))
    return data, clusters


def _configs(measure, **kw):
    # planted: within-cluster eq3 ~30-60 deg, eq2 ~8-11; between >= 230 / 55
    beta = 100.0 if measure == "eq3" else 25.0
    ref = RefConfig(p=P, measure=measure, svd_method="exact", beta=beta, **kw)
    return ref, convert.config_from_reference(dataclasses.asdict(ref))


@pytest.mark.parametrize("measure", ["eq3", "eq2"])
class TestOneShotPipeline:
    def test_proximity_and_labels_match_reference(self, measure):
        data, truth = _federation(0, K)
        ref_cfg, cfg = _configs(measure)
        ref = ref_one_shot([jnp.asarray(D) for D in data], ref_cfg)
        port = one_shot_clustering(data, cfg, device="cpu")
        assert port.U.shape == (K, N, P) and port.U.device.type == "cpu"
        np.testing.assert_allclose(port.A, np.asarray(ref.A), atol=TOL_DEG)
        np.testing.assert_array_equal(port.labels, ref.labels)
        assert port.n_clusters == N_BASES
        assert port.signature_bytes == ref.signature_bytes

    def test_beta_quantile_branch_matches_reference(self, measure):
        data, _ = _federation(1, K)
        ref_cfg, cfg = _configs(measure, beta_quantile=0.2)
        ref = ref_one_shot([jnp.asarray(D) for D in data], ref_cfg)
        port = one_shot_clustering(data, cfg, device="cpu")
        np.testing.assert_array_equal(port.labels, ref.labels)

    def test_extend_and_serve_match_reference(self, measure):
        data, _ = _federation(2, K)
        ref_cfg, cfg = _configs(measure)
        ref = ref_one_shot([jnp.asarray(D) for D in data], ref_cfg)
        port = one_shot_clustering(data, cfg, device="cpu")
        new_data, _ = _federation(3, 4, clusters=[2, 0, 3, 1])
        U_new = np.asarray(compute_signatures(new_data, cfg, device="cpu"))
        ref_ext = ref.extend(jnp.asarray(U_new))
        port_ext = port.extend(torch.from_numpy(U_new))
        np.testing.assert_array_equal(port_ext.labels, ref_ext.labels)
        np.testing.assert_allclose(port_ext.A, np.asarray(ref_ext.A), atol=TOL_DEG)

        q_data, _ = _federation(4, 6, clusters=[0, 1, 2, 3, 1, 2])
        U_q = np.asarray(compute_signatures(q_data, cfg, device="cpu"))
        ref_cache, cache = RefCache("medoid"), RepresentativeCache("medoid")
        ref_cache.refresh(ref_ext.engine)
        cache.refresh(port_ext.engine)
        np.testing.assert_array_equal(cache.rep_labels, ref_cache.rep_labels)
        ref_idx, ref_d = ref_serve_assign(jnp.asarray(U_q), ref_cache.rep_stack, measure)
        idx, d = serve_assign(torch.from_numpy(U_q), cache.rep_stack, measure)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=TOL_DEG)


@pytest.mark.parametrize("tier", MEMORY_TIERS)
def test_engine_from_numpy_bitwise_across_tiers(tier, tmp_path):
    """Same float32 A into both engines: bitwise labels and merge scripts,
    also after a departure, then parity after a shared admission and
    serving from identical representatives."""
    data, _ = _federation(5, K)
    ref_cfg, _ = _configs("eq3")
    ref_once = ref_one_shot([jnp.asarray(D) for D in data], ref_cfg)
    U, A = np.asarray(ref_once.U), np.asarray(ref_once.A, np.float32)
    spill = (
        {"memory_budget_bytes": 1 << 11, "memory_spill_segment_rows": 8,
         "memory_spill_dir": str(tmp_path)}
        if tier == "spilled" else {}
    )
    ref_cfg = dataclasses.replace(ref_cfg, memory=tier, memory_band_rows=8, **spill)
    cfg = convert.config_from_reference(dataclasses.asdict(ref_cfg))
    ref = RefEngine.from_proximity(A, jnp.asarray(U), ref_engine_config(ref_cfg))
    port = convert.engine_from_numpy(A, U, cfg, device="cpu")

    def same(a, b):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.canonical_labels, b.canonical_labels)
        assert a._script == b._script
        np.testing.assert_array_equal(a.ids, b.ids)

    same(port, ref)
    ref.depart(np.array([3, 10]))
    port.depart(np.array([3, 10]))
    same(port, ref)
    np.testing.assert_array_equal(port.U.numpy(), np.asarray(ref.U))

    new_data, _ = _federation(6, 3, clusters=[1, 3, 0])
    U_new = np.asarray(compute_signatures(new_data, cfg, device="cpu"))
    ref_res = ref.admit(jnp.asarray(U_new))
    res = port.admit(torch.from_numpy(U_new))
    np.testing.assert_array_equal(res.labels, ref_res.labels)
    np.testing.assert_array_equal(res.newcomer_labels, ref_res.newcomer_labels)
    np.testing.assert_allclose(port.dense(), ref.dense(), atol=TOL_DEG)

    ref_cache, cache = RefCache("medoid"), RepresentativeCache("medoid")
    ref_cache.refresh(ref)
    cache.refresh(port)
    np.testing.assert_array_equal(cache.rep_labels, ref_cache.rep_labels)
    for lbl in cache.rep_labels:
        assert cache.representative(lbl).medoid_id == ref_cache.representative(lbl).medoid_id
    q_data, _ = _federation(9, 5, clusters=[3, 2, 1, 0, 3])
    U_q = np.asarray(compute_signatures(q_data, cfg, device="cpu"))
    ref_idx, ref_d = ref_serve_assign(jnp.asarray(U_q), ref_cache.rep_stack, "eq3")
    idx, d = serve_assign(torch.from_numpy(U_q), cache.rep_stack, "eq3")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=TOL_DEG)


def test_centroid_representatives_and_serving_shapes():
    data, _ = _federation(7, 12)
    _, cfg = _configs("eq2")
    cl = one_shot_clustering(data, cfg, device="cpu")
    cache = RepresentativeCache("centroid")
    cache.refresh(cl.engine)
    R = cache.rep_stack
    assert R.shape == (cl.n_clusters, N, P)
    eye = torch.eye(P).expand(R.shape[0], P, P)
    torch.testing.assert_close(R.transpose(1, 2) @ R, eye, atol=1e-5, rtol=0)
    # eq2 takes rectangular pairs: p = 2 queries against p = 3 representatives
    idx, d = serve_assign(cl.U[:5, :, :2], R, "eq2")
    assert idx.shape == d.shape == (5,) and torch.isfinite(d).all()
    assert [pow2_bucket(x) for x in (0, 1, 2, 3, 5, 32, 33)] == [1, 1, 2, 4, 8, 32, 64]
    with pytest.raises(ValueError, match="equal basis"):
        serve_assign(cl.U[:5, :, :2], R, "eq3")


def test_config_conversion_and_device_rules():
    ref = RefConfig(proximity_backend="pallas", memory="banded", beta=12.5)
    cfg = convert.config_from_reference(dataclasses.asdict(ref))
    assert cfg.proximity_backend == "kernel" and cfg.memory == "banded" and cfg.beta == 12.5
    for backend, want in (("jnp", "torch"), ("jnp_blocked", "torch_blocked"), ("auto", "auto"),
                          ("jnp_sharded", "sharded")):
        got = convert.config_from_reference(dataclasses.asdict(RefConfig(proximity_backend=backend)))
        assert got.proximity_backend == want
    with pytest.raises(ValueError, match="no counterpart"):
        convert.config_from_reference(dataclasses.asdict(RefConfig(proximity_backend="bogus")))
    U = convert.signatures_from_numpy(np.zeros((2, 8, 3)), device="cpu")
    assert U.dtype == torch.float32 and U.device.type == "cpu"
    if not torch.cuda.is_available():
        # device=None means CUDA: without a card it raises, never runs on the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.signatures_from_numpy(np.zeros((2, 8, 3)))
        with pytest.raises(RuntimeError, match="CUDA"):
            one_shot_clustering(_federation(8, 4)[0], cfg)


def test_port_imports_without_jax():
    """Every repro_torch module imports with ``jax`` blocked."""
    script = (
        "import sys, pkgutil, importlib, json\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'repro' or k.startswith(('repro.', 'jax.')))\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, check=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for required in (
        "repro_torch.core.measures", "repro_torch.core.angles", "repro_torch.core.svd",
        "repro_torch.core.pacfl", "repro_torch.core.engine.engine",
        "repro_torch.kernels.proximity.proximity", "repro_torch.kernels.tsgemm.tsgemm",
        "repro_torch.serving.dispatch", "repro_torch.convert",
        "repro_torch.optim", "repro_torch.ckpt", "repro_torch.launch.train",
        "repro_torch.kernels.flash_attention.flash_attention_bwd",
    ):
        assert required in res["mods"]
