#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card, its power limit, the float32 matmul settings;
2. build: compiles the port's four CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) into ``build/kernels/``, printing
   each source's ``nvcc`` time and the count of tensor-core (``HMMA``)
   instructions in the SASS of the bfloat16 flash-attention kernel;
3. kernels vs plain: each kernel against its plain PyTorch twin on the card,
   at the main paths' shapes plus ragged, cross, windowed, high-rank,
   split-KV / split-K and bfloat16 cases;
4. PACFL main path: one-shot clustering of K = 1024 synthetic clients at
   CIFAR-10 geometry (n = 3072 features, p = 3, 300-700 samples each, 16
   planted subspace clusters), PME admission of 64 newcomers, and 256
   assignment queries in batches of 32 through the medoid representative
   cache — checking that the planted clusters are recovered and every
   newcomer and query lands in its own, and that the proximity and tsgemm
   kernels ran;
5. LM serving main path: full-width tinyllama-1.1b, then rwkv6-1.6b, in
   bfloat16 through ``repro_torch.launch.serve`` (batch 4, prompt 1024, 32
   greedy tokens: one prefill and 31 decode forwards), checking that every
   attention call launched the flash kernel and every WKV call the WKV
   kernel, and timing the prefill and one decode step replayed from a CUDA
   graph beside their host-clock times;
6. whole model in float32 at full width: last-position logits of a prefill
   and 8 teacher-forced decode steps through the kernels on the card against
   the plain twins (the same model on the CPU);
7. timings: each kernel's median time at its main-path shape beside its
   bound at the card's peak rates, its plain twin and the library call
   (flash attention also at llama3.2-3b's heads; tsgemm also at Q^T @ D and
   the M = 1024 bucket).

The second-to-last line is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``.  Nothing of the JAX package is imported.

    python3 chip_smoke.py --time-kernels SRC

builds only the flash-attention and tsgemm kernels of the ``repro_torch``
under the directory SRC, times them at phase 7's main-path shapes with
phase 7's timers and prints one JSON line of milliseconds.  Two commits are
compared on one card by running it on both trees in turns in one session,
e.g. on a parent unpacked with ``git archive`` into ``build/parent``:

    for s in build/parent/src src src build/parent/src; do
        python3 chip_smoke.py --time-kernels $s; done
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor and
# bfloat16 dense tensor-core flop/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

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
FLASH_F32_TOL, FLASH_BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py
# bfloat16 flash attention is held, besides, to max|kernel - plain| <= this
# share of max|plain| in each case.  Both round the output to bfloat16 once
# (2^-8 relative) and the kernel also rounds P; one bfloat16 step of the
# largest output is at most 2^-7 of it.  The absolute 3e-2 alone is ~60% of
# a decode output's scale; phase 3 prints beside each case how far a
# one-key shift of the mask moves the plain twin, against this limit.
FLASH_BF16_REL_TOL = 1e-2
WKV_REL_TOL = 1e-5         # of max |out| and max |state|

# LM serving (phase 5): tinyllama-1.1b's attention and rwkv6-1.6b's WKV.
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 1024, 32
LM_ARCHS = (("tinyllama-1.1b", "flash_attention"), ("rwkv6-1.6b", "wkv"))
# Whole-model float32 check (phase 6): the CPU side runs the plain twins at
# full width, so the prompt is shorter than phase 5's.
F32_BATCH, F32_PROMPT, F32_DECODE = 2, 128, 8
# Limits on max|kernels - plain| / max|logits|.  Both sides are float32 and
# differ only in summation order (cuBLAS vs the CPU's BLAS, the kernel's
# online softmax and on-chip recurrence vs the dense / stepwise twins), ~1e-6
# relative per operation; a wrong mask, head mapping or state moves the
# logits by ~1e-1 of their scale.  How far the model amplifies rounding is
# measured beside each check (the "floor": the kernels' logits again after
# every weight moves by one float32 ulp).  tinyllama amplifies little;
# rwkv6 at its random init (decay ~0.9975, so the WKV state sums nearly all
# past k v^T before the per-head group norm) amplifies rounding ~700x more,
# hence its wider limit.
LOGIT_REL_TOL = {"tinyllama-1.1b": 1e-4, "rwkv6-1.6b": 1e-2}

# The revision in which the flash-attention and tsgemm kernels were redesigned
# (their earlier times are in PERF.md section 6).
REDESIGNED_IN = 13


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


# Device cycles to sleep before each timed sample (~0.6 ms at 1.7 GHz).
SLEEP_CYCLES = 1_000_000


def time_ms(torch, fn, *, warmup=3, iters=15) -> float:
    """Median device time of ``fn()`` over ``iters`` samples (CUDA events).
    The device sleeps before each sample while the host enqueues it, so the
    wrapper's Python prologue is not in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, *, reps=1, iters=10) -> float:
    """Median device time of one ``fn()`` replayed from a CUDA graph that
    holds ``reps`` calls: the host's launch gaps are not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, iters=iters) / reps


def bound(bytes_moved: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(torch) -> dict:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products accumulate in float32 (the reference's policy)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name} x{count}; matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return {"kind": name, "count": count, "smi": smi}


def count_hmma(lib_path, function_substring: str) -> int:
    """Tensor-core instructions (HMMA / HGMMA) in the SASS of the functions
    of a built library whose names contain ``function_substring``."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function_substring in line
        elif inside and ("HMMA" in line or "HGMMA" in line):
            count += 1
    return count


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    log("build", f"{', '.join(n + '.cu' for n in _build.KERNELS)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR.relative_to(ROOT)}")
    log("build", "nvcc seconds per source: " + ", ".join(
        f"{name}.cu {sec:.1f}" for name, sec in _build.BUILD_SECONDS.items()))
    hmma = count_hmma(_build.library_path("flash_attention"), "flash_fwd_tc")
    log("build", f"flash_attention bf16 kernel (flash_fwd_tc): {hmma} HMMA instructions in its SASS")
    require(hmma > 0, "the bf16 flash-attention kernel has no tensor-core instructions")


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
    # ranks above the templates' 8: the runtime-rank path
    fed12 = Federation(torch, fed.device, p=12, seed=SEED + 4)
    U12 = fed12.signatures(planted(256))
    for measure in ("eq3", "eq2"):
        compare("square K=256 p=12", U12, U12, measure, True)
    compare("cross 1024x256 p=3 x q=12", U3, U12, "eq2", False)


def check_tsgemm(torch, device, errs: list) -> None:
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def compare(label, A, B, rtol):
        got = tsgemm_cuda(A, B)
        want = tsgemm_plain(A, B)
        exact = A.double() @ B.double()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - (10 * rtol + rtol * want.abs())).max().item()
        log("kernels", f"tsgemm {label}: {tuple(A.shape)} @ {tuple(B.shape)} "
            f"strides {A.stride()} max|kernel - plain| = {err:.3e} "
            f"(rtol {rtol}, atol {10 * rtol}); against float64: kernel "
            f"{(got - exact).abs().max().item():.3e}, plain {(want - exact).abs().max().item():.3e}")
        require(bool(torch.isfinite(got).all()) and excess <= 0, f"tsgemm {label}")
        if A.dtype == torch.float32:
            errs.append(err)

    ell = RANK + 8
    D = randn(64, N_FEATURES, 512)
    omega = randn(64, 512, ell)
    Q = torch.linalg.qr(tsgemm_plain(D, omega))[0]
    Z = torch.linalg.qr(tsgemm_plain(D.transpose(1, 2), Q))[0]
    compare("D @ Omega", D, omega, F32_RTOL)
    compare("D^T @ Q (strided, split-K)", D.transpose(1, 2), Q, F32_RTOL)
    compare("D @ Z", D, Z, F32_RTOL)
    compare("Q^T @ D (strided, wide B, split-K)", Q.transpose(1, 2), D, F32_RTOL)
    # the SVD's operands: D^T against Q with orthonormal columns
    D3 = randn(64, 3000, 512)
    Q3 = torch.linalg.qr(randn(64, 3000, ell))[0]
    compare("split-K, k = 3000 no multiple of the split", D3.transpose(1, 2), Q3, F32_RTOL)
    del D3, Q3
    compare("ragged", randn(3, 1000, 300), randn(3, 300, 13), F32_RTOL)
    compare("ragged strided", randn(3, 300, 1001).transpose(1, 2), randn(3, 300, 7), F32_RTOL)
    bf16 = torch.bfloat16
    compare("bf16 D @ Omega", D.to(bf16), omega.to(bf16), BF16_RTOL)
    compare("bf16 D^T @ Q (strided, vector path, split-K)",
            D.to(bf16).transpose(1, 2), Q.to(bf16), BF16_RTOL)
    compare("bf16 ragged strided (element path)",
            randn(3, 300, 1001, dtype=bf16).transpose(1, 2), randn(3, 300, 7, dtype=bf16),
            BF16_RTOL)
    # D^T against a Gaussian B: sums of 3000 products of unit normals (|C|
    # up to ~250), where float32 rounding alone exceeds the elementwise atol
    # between any two summation orders.  Both products are held to float64
    # instead: the kernel's error may be at most twice cuBLAS's.
    A, B = randn(64, 3000, 512).transpose(1, 2), randn(64, 3000, ell)
    exact = A.double() @ B.double()
    e_kernel = (tsgemm_cuda(A, B) - exact).abs().max().item()
    e_plain = (tsgemm_plain(A, B) - exact).abs().max().item()
    log("kernels", f"tsgemm split-K, k = 3000, Gaussian B: {tuple(A.shape)} @ {tuple(B.shape)} "
        f"against float64: kernel {e_kernel:.3e}, plain (cuBLAS) {e_plain:.3e} (limit 2x plain)")
    require(e_kernel <= 2 * e_plain, f"tsgemm Gaussian k = 3000: {e_kernel} vs {e_plain}")


def check_flash(torch, device, errs: dict) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.flash_attention.flash_attention import split_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    tinyllama, llama3b = (32, 4, 64), (24, 8, 128)   # (Hq, Hkv, hd)

    def compare(label, B, Sq, Skv, dtype, causal=True, window=None, q_offset=0,
                heads=tinyllama):
        Hq, Hkv, hd = heads
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device=device).to(dtype)
        k = torch.randn((B, Skv, Hkv, hd), generator=gen, device=device).to(dtype)
        v = torch.randn((B, Skv, Hkv, hd), generator=gen, device=device).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        ok = bool(torch.isfinite(got).all()) and got.dtype == dtype and err <= tol
        line = f"max|kernel - plain| = {err:.3e} (limit {tol})"
        if dtype == torch.bfloat16:
            scale = want.abs().max().item()
            # the plain twin with each query one position earlier: one key
            # fewer at the causal edge, the window's edge one key back
            shifted = flash_attention_plain(q, k, v, **{**kw, "q_offset": q_offset - 1})
            moved = (shifted.float() - want).abs().max().item()
            ok = ok and err <= FLASH_BF16_REL_TOL * scale
            line += (f", {err / scale:.3e} of max|plain| {scale:.4f} (limit "
                     f"{FLASH_BF16_REL_TOL}; a one-key mask shift moves the plain twin by "
                     f"{moved / scale:.3e})")
        split = split_plan(B, Sq, Skv, Hq, Hkv, hd) if dtype == torch.bfloat16 else (1, Skv)
        log("kernels", f"flash {label} {str(dtype)[6:]}: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"{kw} (nsplit, split_len) {split} {line}")
        require(ok, f"flash {label} {dtype}: err {err}")
        errs[dtype].append(err)

    cache_len = LM_PROMPT + LM_TOKENS
    for dtype in (torch.float32, torch.bfloat16):
        compare("prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, dtype)
        compare("decode", LM_BATCH, 1, cache_len, dtype, q_offset=cache_len - 16)
        compare("windowed ragged", 2, 1000, 1000, dtype, window=128)
        compare("ragged suffix", 2, 77, 1111, dtype, q_offset=1034)
        compare("prefill, llama3.2-3b heads", LM_BATCH, LM_PROMPT, LM_PROMPT, dtype,
                heads=llama3b)
        compare("decode, Skv no multiple of the split", LM_BATCH, 1, 1000, dtype, q_offset=999)
        compare("decode, trailing splits empty", LM_BATCH, 1, cache_len, dtype, q_offset=300)
        compare("windowed decode, early splits masked", LM_BATCH, 1, cache_len, dtype,
                window=200, q_offset=cache_len - 1)
        compare("decode, no valid key in any split", LM_BATCH, 1, cache_len, dtype,
                window=100, q_offset=cache_len + 300)
    compare("non-causal windowed, rows past the window", 1, 5, 40, torch.float32,
            causal=False, window=7, q_offset=50)


def wkv_inputs(torch, gen, B, S, H, hd, device):
    """r, k, v, w, u at the model's scales: decay w = exp(-exp(-6 + noise))."""
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=device) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * torch.randn((B, S, H, hd), generator=gen,
                                                       device=device)))
    u = 0.1 * torch.randn((H, hd), generator=gen, device=device)
    return r, k, v, w, u


def check_wkv(torch, device, errs: list) -> None:
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    H, hd = 32, 64   # rwkv6-1.6b

    def compare(label, ops, state0):
        out, st = wkv_cuda(*ops, state0)
        want_out, want_st = wkv_plain(*ops, state0)
        torch.cuda.synchronize()
        e_out = ((out - want_out).abs().max() / want_out.abs().max()).item()
        e_st = ((st - want_st).abs().max() / want_st.abs().max()).item()
        log("kernels", f"wkv {label}: r {tuple(ops[0].shape)} max|kernel - plain| / max|plain| "
            f"= {e_out:.3e} (out), {e_st:.3e} (state) (limit {WKV_REL_TOL})")
        require(bool(torch.isfinite(out).all()) and max(e_out, e_st) <= WKV_REL_TOL,
                f"wkv {label}: {e_out}, {e_st}")
        errs.append(max((out - want_out).abs().max().item(), (st - want_st).abs().max().item()))
        return st

    ops = wkv_inputs(torch, gen, LM_BATCH, LM_PROMPT, H, hd, device)
    compare("prefill", ops, None)
    state = compare("prefill with state0", ops,
                    0.1 * torch.randn((LM_BATCH, H, hd, hd), generator=gen, device=device))
    step = wkv_inputs(torch, gen, LM_BATCH, 1, H, hd, device)
    compare("decode S=1, carried state", step, state)


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


def phase_lm_serving(torch, device) -> dict:
    """Phase 5: each architecture served at full width in bfloat16; the
    launch counts are set to 0 just before and read just after each run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    launches = {}
    for arch, kernel in LM_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=device)
        prompt = serve.random_prompt(cfg, LM_BATCH, LM_PROMPT, seed=SEED, device=device)
        sync(torch, device)
        n_params = sum(p.numel() for p in params.parameters())
        log("lm", f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B parameters in bfloat16, built in "
            f"{time.perf_counter() - t0:.1f} s")
        serve.generate(params, prompt, 2)   # warm-up: cuBLAS plans, allocator
        _build.reset_launches()
        toks, times = serve.generate(params, prompt, LM_TOKENS)
        counts = dict(_build.LAUNCHES)
        total = times["prefill_s"] + times["decode_s"]
        log("lm", f"{arch}: batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_TOKENS} tokens: "
            f"prefill {times['prefill_s']:.4f} s, {LM_TOKENS - 1} decode steps "
            f"{times['decode_s']:.4f} s ({LM_BATCH * LM_TOKENS / total:.1f} tok/s, "
            f"decode {LM_BATCH * (LM_TOKENS - 1) / times['decode_s']:.1f} tok/s); "
            f"kernel launches {counts}")
        expected = cfg.n_layers * LM_TOKENS
        require(counts.get(kernel, 0) == expected,
                f"{arch}: {counts.get(kernel, 0)} {kernel} launches, expected {expected}")
        require(tuple(toks.shape) == (LM_BATCH, LM_TOKENS)
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_padded,
                f"{arch}: generated tokens out of range")
        with torch.inference_mode():
            prefill = lm.make_prefill_step(LM_PROMPT + LM_TOKENS)
            logits, cache = prefill(params, prompt)
            require(bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits")
            tok = logits.argmax(-1)[:, None]
            step = lm.make_serve_step()
            dev_ms = graph_ms(torch, lambda: step(params, cache, tok, LM_PROMPT))
            pre_ms = graph_ms(torch, lambda: prefill(params, prompt), iters=5)
        host_ms = times["decode_s"] / (LM_TOKENS - 1) * 1e3
        pre_host_ms = times["prefill_s"] * 1e3
        log("lm", f"{arch}: prefill {pre_host_ms:.3f} ms on the host clock, {pre_ms:.3f} ms "
            f"replayed from a CUDA graph (device idle {1 - pre_ms / pre_host_ms:.1%})")
        log("lm", f"{arch}: one decode step {host_ms:.3f} ms on the host clock, "
            f"{dev_ms:.3f} ms replayed from a CUDA graph (device idle "
            f"{1 - dev_ms / host_ms:.1%} of a host-driven step)")
        log("lm", f"{arch}: sample {toks[0, :12].tolist()}")
        launches[kernel] = counts[kernel]
        del params, prompt, toks, logits, cache, tok
        torch.cuda.empty_cache()
    return launches


def _teacher_forced(torch, params, prompt, teacher):
    """Last-position logits of a prefill and one decode step per teacher token."""
    from repro_torch.models import lm

    B, S = prompt.shape
    out = []
    with torch.inference_mode():
        logits, cache = lm.make_prefill_step(max_len=S + teacher.shape[1])(params, prompt)
        out.append(logits.float())
        step = lm.make_serve_step()
        for t in range(teacher.shape[1]):
            logits, cache = step(params, cache, teacher[:, t:t + 1], S + t)
            out.append(logits.float())
    return torch.stack(out, dim=1)


def _ulp_perturbed(torch, params):
    """A copy of ``params`` with every float32 weight moved by one ulp,
    up or down at random (seeded)."""
    noisy = copy.deepcopy(params)
    gen = torch.Generator(device=params.embed.device).manual_seed(SEED + 3)
    with torch.no_grad():
        for p in noisy.parameters():
            up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
            p.mul_(torch.where(up, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24))
    return noisy


def phase_lm_float32(torch, device) -> None:
    """Phase 6: the full-width model in float32 through the kernels on the
    card against the same model through the plain twins on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    for arch, kernel in LM_ARCHS:
        cfg = get_config(arch)
        params = lm.init_params(cfg, seed=SEED + 1, dtype=torch.float32, device=device)
        prompt = serve.random_prompt(cfg, F32_BATCH, F32_PROMPT, seed=SEED + 1, device=device)
        teacher = serve.random_prompt(cfg, F32_BATCH, F32_DECODE, seed=SEED + 2, device=device)
        _build.reset_launches()
        t0 = time.perf_counter()
        got = _teacher_forced(torch, params, prompt, teacher).cpu()
        t1 = time.perf_counter()
        require(_build.LAUNCHES[kernel] == cfg.n_layers * (1 + F32_DECODE),
                f"{arch} float32: {dict(_build.LAUNCHES)}")
        floor = (_teacher_forced(torch, _ulp_perturbed(torch, params), prompt, teacher).cpu()
                 - got).abs().max().item()
        torch.cuda.empty_cache()
        params = params.to("cpu")
        want = _teacher_forced(torch, params, prompt.cpu(), teacher.cpu())
        t2 = time.perf_counter()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        limit = LOGIT_REL_TOL[arch]
        log("lm32", f"{arch} float32 batch {F32_BATCH}, prompt {F32_PROMPT}, "
            f"{F32_DECODE} teacher-forced steps: max|kernels - plain| = {err:.3e}, "
            f"max|logits| = {scale:.3f}, relative {err / scale:.3e} (limit {limit}); "
            f"one-ulp weight floor {floor / scale:.3e} relative; argmax agreement "
            f"{same:.4f}; card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")
        require(bool(torch.isfinite(got).all()) and err <= limit * scale,
                f"{arch} float32 logits: {err} vs scale {scale}")
        del params, got, want


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
    cases = []
    for M in (512, 1024):   # the two pow2 buckets of the main path
        D = torch.randn((64, n, M), generator=gen, device=fed.device)
        omega = torch.randn((64, M, p + 8), generator=gen, device=fed.device)
        Q = torch.linalg.qr(D @ omega)[0]
        tag = "" if M == 512 else f"M={M} "
        cases += [(tag + "D @ Omega", D, omega), (tag + "D^T @ Q", D.transpose(1, 2), Q)]
        if M == 512:
            cases.append(("Q^T @ D", Q.transpose(1, 2), D))
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
                "library_ms": lib_ms, "redesigned": REDESIGNED_IN,
            })
    return rows


def lm_kernel_timings(torch, device, launches, errs) -> list:
    """Flash attention at tinyllama's prefill and decode shapes, WKV at
    rwkv6's, in the main path's types (bfloat16 attention, float32 WKV)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    B, S, Hq, Hkv, hd = LM_BATCH, LM_PROMPT, 32, 4, 64
    bf16 = torch.bfloat16
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    # prefill: causal, S x S
    q, k, v = randn(B, S, Hq, hd).to(bf16), randn(B, S, Hkv, hd).to(bf16), randn(B, S, Hkv, hd).to(bf16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v))
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v), iters=5)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = S * (S + 1) / 2
    b_ms, b_by = bound(2.0 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * Hq * hd * pairs,
                       PEAK_BF16_FLOPS)
    log("time", f"flash prefill q {tuple(q.shape)} k {tuple(k.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
        "launches": launches.get("flash_attention", 0),
        # the timed kernel is the bfloat16 one; the float32 one's error beside it
        "max_abs_err": max(errs["flash_attention"][bf16]),
        "max_abs_err_f32": max(errs["flash_attention"][torch.float32]),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "redesigned": REDESIGNED_IN,
    })

    # prefill at llama3.2-3b's heads: hd 128, G = 3
    Hq3, Hkv3, hd3 = 24, 8, 128
    q3, k3, v3 = (randn(B, S, h, hd3).to(bf16) for h in (Hq3, Hkv3, Hkv3))
    q3t, k3t, v3t = (x.transpose(1, 2) for x in (q3, k3, v3))
    ms3 = time_ms(torch, lambda: flash_attention_cuda(q3, k3, v3))
    plain3 = time_ms(torch, lambda: flash_attention_plain(q3, k3, v3), iters=5)
    lib3 = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q3t, k3t, v3t, is_causal=True, enable_gqa=True))
    b3, b3_by = bound(2.0 * (2 * q3.numel() + 2 * k3.numel()), 4.0 * B * Hq3 * hd3 * pairs,
                      PEAK_BF16_FLOPS)
    log("time", f"flash prefill q {tuple(q3.shape)} k {tuple(k3.shape)} bf16 causal "
        f"(llama3.2-3b heads): kernel {ms3:.4f} ms, plain {plain3:.4f} ms, SDPA {lib3:.4f} ms, "
        f"bound {b3:.4f} ms ({b3_by})")
    del q3, k3, v3, q3t, k3t, v3t

    # decode: one query per sequence against the cache, keys up to pos valid
    cache_len = LM_PROMPT + LM_TOKENS
    pos = cache_len - 1
    q1 = randn(B, 1, Hq, hd).to(bf16)
    kc, vc = randn(B, cache_len, Hkv, hd).to(bf16), randn(B, cache_len, Hkv, hd).to(bf16)
    # decode-sized calls are timed as CUDA-graph replays: the host's launch
    # gaps would otherwise exceed the kernels themselves
    ms = graph_ms(torch, lambda: flash_attention_cuda(q1, kc, vc, q_offset=pos), reps=20)
    plain_ms = graph_ms(torch, lambda: flash_attention_plain(q1, kc, vc, q_offset=pos), reps=20)
    q1t, kct, vct = (x.transpose(1, 2) for x in (q1, kc, vc))
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q1t, kct[:, :, :pos + 1], vct[:, :, :pos + 1], enable_gqa=True), reps=20)
    keys = pos + 1
    b_ms, b_by = bound(2.0 * (2 * q1.numel() + 2 * B * keys * Hkv * hd),
                       4.0 * B * Hq * hd * keys, PEAK_BF16_FLOPS)
    log("time", f"flash decode q {tuple(q1.shape)} cache {tuple(kc.shape)} pos {pos} bf16 "
        f"(graph replay): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")

    # WKV: prefill over the prompt, then one decode step with a carried state
    H = 32
    ops = wkv_inputs(torch, gen, B, S, H, hd, device)
    ms = time_ms(torch, lambda: wkv_cuda(*ops))
    plain_ms = time_ms(torch, lambda: wkv_plain(*ops), warmup=1, iters=3)
    n = B * S * H * hd
    b_ms, b_by = bound(4.0 * (5 * n + H * hd + B * H * hd * hd), 7.0 * n * hd)
    log("time", f"wkv prefill r {tuple(ops[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by})")
    rows.append({
        "name": "wkv", "route": "cuda", "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv/wkv.py:53",
        "launches": launches.get("wkv", 0), "max_abs_err": max(errs["wkv"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    step = wkv_inputs(torch, gen, B, 1, H, hd, device)
    state = randn(B, H, hd, hd)
    ms = graph_ms(torch, lambda: wkv_cuda(*step, state), reps=20)
    plain_ms = graph_ms(torch, lambda: wkv_plain(*step, state), reps=20)
    n1 = B * H * hd
    b_ms, b_by = bound(4.0 * (5 * n1 + H * hd + 2 * B * H * hd * hd), 7.0 * n1 * hd)
    log("time", f"wkv decode r {tuple(step[0].shape)} state {tuple(state.shape)} f32 "
        f"(graph replay): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return rows


def time_kernels(torch) -> dict:
    """Milliseconds of the imported ``repro_torch``'s tsgemm and bfloat16
    flash-attention wrappers at phase 7's main-path shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tsgemm import tsgemm_cuda

    _build.build_all(["tsgemm", "flash_attention"])
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED + 8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    ms = {}
    D, omega = randn(64, N_FEATURES, 512), randn(64, 512, RANK + 8)
    Q = torch.linalg.qr(D @ omega)[0]
    for label, A, B in (("tsgemm D @ Omega", D, omega), ("tsgemm D^T @ Q", D.transpose(1, 2), Q),
                        ("tsgemm Q^T @ D", Q.transpose(1, 2), D)):
        ms[label] = time_ms(torch, lambda: tsgemm_cuda(A, B))
    del D, omega, Q
    bf16 = torch.bfloat16
    for Hq, Hkv, hd in ((32, 4, 64), (24, 8, 128)):
        q, k, v = (randn(LM_BATCH, LM_PROMPT, h, hd, dtype=bf16) for h in (Hq, Hkv, Hkv))
        ms[f"flash prefill hd {hd}"] = time_ms(torch, lambda: flash_attention_cuda(q, k, v))
    cache_len = LM_PROMPT + LM_TOKENS
    q1 = randn(LM_BATCH, 1, 32, 64, dtype=bf16)
    kc, vc = (randn(LM_BATCH, cache_len, 4, 64, dtype=bf16) for _ in range(2))
    ms["flash decode (graph replay)"] = graph_ms(
        torch, lambda: flash_attention_cuda(q1, kc, vc, q_offset=cache_len - 1), reps=20)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--time-kernels", metavar="SRC",
                    help="only time the tsgemm and flash-attention kernels of SRC/repro_torch")
    args = ap.parse_args(argv)
    src = Path(args.time_kernels).resolve() if args.time_kernels else ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: {src}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    device = phase_device(torch)
    if args.time_kernels:
        print(json.dumps({"src": args.time_kernels, "device": device["smi"],
                          "ms": time_kernels(torch)}))
        return 0
    phase_build()
    fed = Federation(torch, torch.device("cuda"))
    errs = {"proximity": [], "tsgemm": [], "wkv": [],
            "flash_attention": {torch.float32: [], torch.bfloat16: []}}
    check_proximity(torch, fed, errs["proximity"])
    check_tsgemm(torch, fed.device, errs["tsgemm"])
    check_flash(torch, fed.device, errs["flash_attention"])
    check_wkv(torch, fed.device, errs["wkv"])
    launches = phase_main_path(torch, fed)
    lm_launches = phase_lm_serving(torch, fed.device)
    phase_lm_float32(torch, fed.device)
    rows = phase_timings(torch, fed, launches, errs)
    rows += lm_kernel_timings(torch, fed.device, lm_launches, errs)
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
