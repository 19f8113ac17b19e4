#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card, its power limit, the float32 matmul settings;
2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) into ``build/kernels/``;
3. kernels vs plain: each kernel against its plain PyTorch twin on the card,
   at the main path's shapes plus ragged, cross and bfloat16 cases;
4. main path: one-shot PACFL clustering of K = 1024 synthetic clients at
   CIFAR-10 geometry (n = 3072 features, p = 3, 300-700 samples each, 16
   planted subspace clusters), PME admission of 64 newcomers, and 256
   assignment queries in batches of 32 through the medoid representative
   cache — checking that the planted clusters are recovered and every
   newcomer and query lands in its own, and that both kernels ran;
5. timings: each kernel's median time at the main-path shape beside its
   bound at the card's peak rates, its plain twin and the library call.

The second-to-last line is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``.  Nothing of the JAX package is imported.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor flop/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

N_FEATURES = 3072          # flattened 32x32x3 CIFAR-10 image
RANK = 3                   # PACFLConfig.p default
N_CLIENTS = 1024
N_CLUSTERS = 16
M_RANGE = (300, 700)       # samples per client -> pow2 buckets 512 and 1024
N_NEWCOMERS = 64
N_QUERIES = 256
QUERY_BATCH = 32
BETA_DEG = 30.0            # planted within-cluster eq3 ~5-12 deg, between ~266
SPECTRUM = (20.0, 6.0, 2.0)
BASIS_JITTER = 0.02
NOISE = 0.02
SEED = 0

PROX_TOL_DEG = 1e-3        # the reference's TOL_DEG
F32_RTOL, BF16_RTOL = 1e-5, 2e-2   # tests/test_kernels.py, atol = 10 * rtol


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------
# synthetic federation (generated on the device from a seeded generator)
# --------------------------------------------------------------------------


class Federation:
    """Clients drawn from N_CLUSTERS planted p-dim subspaces of R^n."""

    def __init__(self, torch, device, p=RANK, seed=SEED):
        self.torch, self.device, self.n, self.p = torch, device, N_FEATURES, p
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.bases = torch.linalg.qr(self._randn(N_CLUSTERS, self.n, p))[0]
        self.spectrum = torch.tensor(SPECTRUM[:p], device=device)

    def _randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen, device=self.device)

    def clients(self, clusters):
        """One (n, M_k) data matrix per planted cluster id in ``clusters``."""
        torch = self.torch
        m_range = M_RANGE
        jitter = BASIS_JITTER * self._randn(len(clusters), self.n, self.p) / self.n**0.5
        Bk = torch.linalg.qr(self.bases[torch.as_tensor(clusters, device=self.device)] + jitter)[0]
        sizes = torch.randint(m_range[0], m_range[1] + 1, (len(clusters),),
                              generator=self.gen, device=self.device).tolist()
        data = []
        for k, M in enumerate(sizes):
            coef = self.spectrum[:, None] * self._randn(self.p, M)
            data.append(Bk[k] @ coef + NOISE * self._randn(self.n, M))
        return data

    def signatures(self, clusters):
        """Orthonormal (K, n, p) stack near the planted bases (kernel checks)."""
        jitter = BASIS_JITTER * self._randn(len(clusters), self.n, self.p) / self.n**0.5
        idx = self.torch.as_tensor(clusters, device=self.device)
        return self.torch.linalg.qr(self.bases[idx] + jitter)[0].contiguous()


def planted(K):
    return [k % N_CLUSTERS for k in range(K)]


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def same_partition(labels, truth) -> bool:
    """Labels induce exactly the planted partition (a bijection of ids)."""
    pairs = set(zip((int(x) for x in labels), (int(x) for x in truth)))
    return len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def time_ms(torch, fn, *, warmup=3, iters=15) -> float:
    """Median device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(torch) -> dict:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name} x{count}; matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(["proximity", "tsgemm"])
    for name in ("proximity", "tsgemm"):
        _build.load(name)
    log("build", f"proximity.cu + tsgemm.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR.relative_to(ROOT)}")


def check_proximity(torch, fed, errs: list) -> None:
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    def compare(label, Ua, Ub, measure, square):
        got = proximity_cuda(Ua, Ub, measure)
        want = proximity_plain(Ua, Ub, measure)
        if square:
            got, want = _hygiene(got), _hygiene(want)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        log("kernels", f"proximity {label} {measure}: shape {tuple(got.shape)} "
            f"max|kernel - plain| = {err:.3e} deg (limit {PROX_TOL_DEG})")
        require(finite and err <= PROX_TOL_DEG, f"proximity {label} {measure}: err {err}")
        errs.append(err)

    U3 = fed.signatures(planted(N_CLIENTS))
    fed5 = Federation(torch, fed.device, p=5, seed=SEED + 1)
    U5 = fed5.signatures(planted(N_CLIENTS))
    newcomers = fed.signatures(planted(37))
    for measure in ("eq3", "eq2"):
        compare("square K=1024 p=3", U3, U3, measure, True)
        compare("square K=1024 p=5", U5, U5, measure, True)
        compare("square ragged K=1000 p=3", U3[:1000], U3[:1000], measure, True)
        compare("cross 1024x37 p=3", U3, newcomers, measure, False)
    compare("cross 1024x1024 p=3 x q=5", U3, U5, "eq2", False)
    compare("cross 37x1024 p=3 x q=5", newcomers, U5, "eq2", False)


def check_tsgemm(torch, device, errs: list) -> None:
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def compare(label, A, B, rtol):
        got = tsgemm_cuda(A, B)
        want = tsgemm_plain(A, B)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - (10 * rtol + rtol * want.abs())).max().item()
        log("kernels", f"tsgemm {label}: {tuple(A.shape)} @ {tuple(B.shape)} "
            f"strides {A.stride()} max|kernel - plain| = {err:.3e} "
            f"(rtol {rtol}, atol {10 * rtol})")
        require(bool(torch.isfinite(got).all()) and excess <= 0, f"tsgemm {label}")
        if A.dtype == torch.float32:
            errs.append(err)

    ell = RANK + 8
    D = randn(64, N_FEATURES, 512)
    omega = randn(64, 512, ell)
    Q = torch.linalg.qr(tsgemm_plain(D, omega))[0]
    Z = torch.linalg.qr(tsgemm_plain(D.transpose(1, 2), Q))[0]
    compare("D @ Omega", D, omega, F32_RTOL)
    compare("D^T @ Q (strided)", D.transpose(1, 2), Q, F32_RTOL)
    compare("D @ Z", D, Z, F32_RTOL)
    compare("Q^T @ D (strided, wide B)", Q.transpose(1, 2), D, F32_RTOL)
    compare("ragged", randn(3, 1000, 300), randn(3, 300, 13), F32_RTOL)
    compare("ragged strided", randn(3, 300, 1001).transpose(1, 2), randn(3, 300, 7), F32_RTOL)
    compare("bf16 D @ Omega", D.to(torch.bfloat16), omega.to(torch.bfloat16), BF16_RTOL)


def phase_main_path(torch, fed) -> dict:
    from repro_torch.core.pacfl import PACFLConfig, compute_signatures, one_shot_clustering
    from repro_torch.kernels import _build
    from repro_torch.serving import RepresentativeCache, serve_assign

    truth = planted(N_CLIENTS)
    data = fed.clients(truth)
    new_truth = [(3 * t + 1) % N_CLUSTERS for t in range(N_NEWCOMERS)]
    new_data = fed.clients(new_truth)
    q_truth = [(5 * t + 2) % N_CLUSTERS for t in range(N_QUERIES)]
    q_data = fed.clients(q_truth)
    sync(torch, fed.device)
    config = PACFLConfig(p=RANK, measure="eq3", beta=BETA_DEG,
                         svd_method="randomized_tsgemm", proximity_backend="auto")
    log("main", f"K={N_CLIENTS} clients n={N_FEATURES} p={RANK}, M_k in {M_RANGE}, "
        f"{N_CLUSTERS} planted clusters; {config}")

    _build.reset_launches()
    t0 = time.perf_counter()
    clustering = one_shot_clustering(data, config, seed=SEED, device=fed.device)
    sync(torch, fed.device)
    t1 = time.perf_counter()
    U_new = compute_signatures(new_data, config, seed=SEED + 10, device=fed.device)
    extended = clustering.extend(U_new)
    t2 = time.perf_counter()
    cache = RepresentativeCache("medoid")
    cache.refresh(extended.engine)
    assigned = []
    for lo in range(0, N_QUERIES, QUERY_BATCH):
        U_q = compute_signatures(q_data[lo:lo + QUERY_BATCH], config,
                                 seed=SEED + 100 + lo, device=fed.device)
        idx, dmin = serve_assign(U_q, cache.rep_stack, config.measure)
        require(bool(torch.isfinite(dmin).all()), "non-finite serving distance")
        assigned.append(idx.cpu())
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    log("main", f"one-shot {t1 - t0:.2f} s, extend {t2 - t1:.2f} s, "
        f"serve {t3 - t2:.2f} s; kernel launches {launches}")

    labels = clustering.labels
    require(clustering.U.shape == (N_CLIENTS, N_FEATURES, RANK), "signature shape")
    A = clustering.A
    require(bool((A == A.T).all()) and float(abs(A.diagonal()).max()) == 0.0, "hygiene")
    require(same_partition(labels, truth),
            f"planted clusters not recovered: {clustering.n_clusters} clusters")
    label_of = {truth[k]: int(labels[k]) for k in range(N_CLIENTS)}
    new_labels = extended.labels[N_CLIENTS:]
    require([label_of[c] for c in new_truth] == [int(x) for x in new_labels],
            "a newcomer left its planted cluster")
    require(extended.n_clusters == N_CLUSTERS, "admission changed the cluster count")
    served = cache.rep_labels[torch.cat(assigned).numpy()]
    require([label_of[c] for c in q_truth] == [int(x) for x in served],
            "a query was served the wrong cluster")
    for name in ("proximity", "tsgemm"):
        require(launches.get(name, 0) > 0, f"the {name} kernel never ran on the main path")
    log("main", f"recovered {clustering.n_clusters} planted clusters; "
        f"{N_NEWCOMERS} newcomers and {N_QUERIES} queries in their clusters")
    return launches


def phase_timings(torch, fed, launches, errs) -> list:
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    K, n, p = N_CLIENTS, N_FEATURES, RANK
    U = fed.signatures(planted(K))
    rows = []
    for measure in ("eq3", "eq2"):
        ms = time_ms(torch, lambda: proximity_cuda(U, U, measure))
        plain_ms = time_ms(torch, lambda: proximity_plain(U, U, measure), iters=5)
        gram = p if measure == "eq3" else p * p
        b_ms, b_by = bound(K * n * p * 4 + K * K * 4, 2.0 * K * K * n * gram)
        log("time", f"proximity {measure} K={K} n={n} p={p}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if measure == "eq3":
            rows.append({
                "name": "proximity", "route": "cuda",
                "source": "src/repro_torch/csrc/proximity.cu",
                "replaces": "src/repro/kernels/proximity/proximity.py:55",
                "launches": launches.get("proximity", 0),
                "max_abs_err": max(errs["proximity"]), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
    gen = torch.Generator(device=fed.device).manual_seed(SEED + 3)
    D = torch.randn((64, n, 512), generator=gen, device=fed.device)
    omega = torch.randn((64, 512, p + 8), generator=gen, device=fed.device)
    Q = torch.linalg.qr(D @ omega)[0]
    cases = [("D @ Omega", D, omega), ("D^T @ Q", D.transpose(1, 2), Q)]
    for label, A, B in cases:
        ms = time_ms(torch, lambda: tsgemm_cuda(A, B))
        plain_ms = time_ms(torch, lambda: tsgemm_plain(A, B))
        lib_ms = time_ms(torch, lambda: torch.matmul(A, B))
        Bt, m, k = A.shape
        pp = B.shape[-1]
        b_ms, b_by = bound(4.0 * (Bt * m * k + Bt * k * pp + Bt * m * pp),
                           2.0 * Bt * m * k * pp)
        log("time", f"tsgemm {label} {tuple(A.shape)} @ {tuple(B.shape)}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if label == "D @ Omega":
            rows.append({
                "name": "tsgemm", "route": "cuda",
                "source": "src/repro_torch/csrc/tsgemm.cu",
                "replaces": "src/repro/kernels/tsgemm/tsgemm.py:51",
                "launches": launches.get("tsgemm", 0),
                "max_abs_err": max(errs["tsgemm"]), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
            })
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    device = phase_device(torch)
    phase_build()
    fed = Federation(torch, torch.device("cuda"))
    errs = {"proximity": [], "tsgemm": []}
    check_proximity(torch, fed, errs["proximity"])
    check_tsgemm(torch, fed.device, errs["tsgemm"])
    launches = phase_main_path(torch, fed)
    rows = phase_timings(torch, fed, launches, errs)
    print(device["smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
