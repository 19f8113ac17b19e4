#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card, its power limit, the float32 matmul settings;
2. build: compiles the port's four CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) into ``build/kernels/``, printing
   each source's ``nvcc`` time, the count of tensor-core instructions in
   the SASS of the bfloat16 flash-attention kernel (``HMMA``) and of the
   eq3 and eq2 proximity kernels (``DMMA``; also of each instantiation the
   p = 16 routes of phase 4b launch, with its registers and stack), and
   the registers and stack of the main paths' eq2, the any-rank eq2 reduce
   (``eq2_form_any``, ``eq2_jacobi_any``) and WKV decode (no stack allowed);
3. kernels vs plain: each kernel against its plain PyTorch twin on the card,
   at the main paths' shapes plus ragged, cross, windowed, high-rank,
   split-KV / split-K, bfloat16 and fast-decay cases, and the square
   proximity (upper-triangle tiles) against the full rectangle; eq2 also at
   its plan's cases (printed): mix4's K = 97 square (split over n), the
   churn admission's cross block and square, K = 1024 (no split), each
   launched twice and required bitwise equal; eq3 and eq2 at the signature
   families' dimensions (n = 256, 192 and a ragged 200) at K = 97 and 100,
   each launched twice and required bitwise equal; the any-rank route
   (p or q > 8) at p = 9, 12, 16, ragged K, 3 x 12 and 12 x 3 cross blocks
   and column views of a p = 20 stack, each launched twice and required
   bitwise equal, and the p = 16 square against the full rectangle; the
   recurrent WKV kernel (decode) at S = 1, 16 and 32 from a carried state;
4. PACFL main path: one-shot clustering of K = 1024 synthetic clients at
   CIFAR-10 geometry (n = 3072 features, p = 3, 300-700 samples each, 16
   planted subspace clusters), PME admission of 64 newcomers, and 256
   assignment queries in batches of 32 through the medoid representative
   cache — checking that the planted clusters are recovered and every
   newcomer and query lands in its own, and that the proximity and tsgemm
   kernels ran;
4b. PACFL at p = 16: phase 4's path on rank-16 planted clusters (16
   singular values from 40 down to 1), once under eq3 and once under eq2,
   each required to recover the clusters, place every newcomer and query
   in its own and launch the proximity kernel's any-rank route;
5. federated-learning main path and the assignment server (at most 120 s),
   every federation through ``run_federation`` (float32 convolutions, the
   entry point's own setting): mix4 at CIFAR-10 geometry
   (``launch/fl_train.py``'s ``build_clients("mix4", 100, 3072, 3000)``: 97
   clients of 300 samples), LeNet-5 at 32x32x3 with 40 classes, PACFL with
   beta 50, eq2, exact SVD: exactly the reference's three clusters
   {cifar10s + svhns}, {fmnists}, {uspss} through at least one eq2
   proximity launch, then 20 rounds with the launcher's settings (sample 0.1,
   3 local epochs, batch 20, lr 0.05), each followed by an evaluation, to a
   finite accuracy above chance; label20 (100 clients, eq3, beta 175):
   PACFL's final mean above FedAvg's after 20 rounds each, PACFL through
   the eq3 kernel; all ten strategies 3 rounds each on label20, finite,
   every one but SOLO with nonzero communication; a mix4 PACFL run in which
   8 fmnists newcomers join and 4 clients leave, each newcomer landing in
   the fmnists cluster through more proximity launches than the mix4 run's;
   and an ``AssignmentServer`` over phase 4's engine whose ``assign_many``
   of the 256 queries equals phase 4's dispatch (and ``admit_oracle`` on
   16), whose ``assign`` and ``drain`` launch the proximity kernel, and
   whose 64 submitted joins drain into their planted clusters with the
   epoch advanced.  mix4 runs twice more for 3 rounds with the same seed:
   the two must give bitwise-equal labels, round accuracies and final
   parameters, and their round accuracies must equal the 20-round run's
   first three.  It prints the mix4 call's time, its 20 rounds' window
   from the entry point's records with the first round apart, a warm
   round's host time beside its device time by kernel (torch.profiler), the
   evaluation time and the server's per-batch latency;
6. LM serving main path: full-width tinyllama-1.1b, then rwkv6-1.6b, in
   bfloat16 through ``repro_torch.launch.serve`` (batch 4, prompt 1024, 32
   greedy tokens: one prefill and 31 decode forwards), checking that every
   attention call launched the flash kernel and every WKV call the WKV
   kernel, and timing the prefill and one decode step replayed from a CUDA
   graph beside their host-clock times;
7. whole model in float32 at full width: last-position logits of a prefill
   and 8 teacher-forced decode steps through the kernels on the card against
   the plain twins (the same model on the CPU);
8. timings: each kernel's median time at its main-path shape beside its
   bound at the card's peak rates, its plain twin and the library call
   (flash attention also at llama3.2-3b's heads; tsgemm also at Q^T @ D and
   the M = 1024 bucket; proximity eq2 also at mix4's K = 97, eq3 at
   label20's K = 100, and the any-rank route, eq3 and eq2, at K = 1024, p =
   16 and 12 and the 1024 x 256 cross block at p = 3 x q = 12; WKV decode
   replayed from a CUDA graph, and prefill also with float32 r, k, v);
9. model-based signature families (run after phase 5, at most 150 s):
   ``weight_delta`` (sketch n = 256) and ``inference`` (probe n = 192) on
   phase 5's mix4 clients with LeNet-5 at 32x32x3, the experiment suite's
   settings (``beta_quantile`` 0.1, eq2): per family the one-shot
   signatures (timed, and twice bitwise equal), ``one_shot_clustering``
   and a 10-round ``run_federation``, each through eq2; the first 16
   clients on the card against the CPU from one set of CPU draws; a
   3-round ``weight_delta`` run with phase 5's churn event; a
   ``DriftTracker`` observation of phase 4's engine after a fused ``move``,
   and the Table-6 distances (BD, KL, MMD) at d = 256, each against the CPU.

Launch counts are set to 0 just before each main path (phase 4, each
measure of 4b, each federation and each server call of phase 5, each
architecture of 6, each family call, federation and the move of 9) and read
just after; launches that only check a result (phase 5's ``admit_oracle``
and its newcomers' signatures, phase 9's repeats and card-against-CPU work)
fall outside every window. The kernels line sums phases 4, 4b, 5 and 9's
windows and splits the proximity launches by route (eq3, eq2 and, above
rank 8, eq3_any_rank, eq2_any_rank). The second-to-last line is the
``{"kernels": [...]}`` record, the last ``{"ok": true, "device": {...}}``.
Nothing of the JAX package is imported.

    python3 chip_smoke.py --time-kernels SRC

builds the four kernels of the ``repro_torch`` under the directory SRC,
times tsgemm, flash attention, WKV (prefill and decode) and proximity (eq3
and eq2 at K = 1024, eq2 at K = 97, eq3 at K = 100, the any-rank route at
p = 16 and 12 and at 3 x 12) at phase 8's shapes with phase 8's timers and
prints one JSON line of milliseconds, with each source's ``nvcc`` seconds
where this call built it.

    python3 chip_smoke.py --time-fl SRC

runs phase 5's federations (mix4 20 rounds, label20 PACFL and FedAvg 20
rounds, the ten strategies 3 rounds) through SRC's ``run_federation`` and
prints one JSON line of their times and the mix4 round times.  Two commits
are compared on one card by running both on both trees in turns in one
session, e.g. on a parent unpacked with ``git archive`` into
``build/parent``:

    for s in build/parent/src src src build/parent/src; do
        python3 chip_smoke.py --time-kernels $s; python3 chip_smoke.py --time-fl $s; done

    python3 chip_smoke.py --sweep-wkv
    python3 chip_smoke.py --sweep-eq2
    python3 chip_smoke.py --sweep-any-rank

time WKV by chunk length and by route at short sequences, eq2 at mix4's
K = 97 by split count, and eq2 at K = 1024, p = 16 by Gram piece shape,
reduce job count and workspace cap, each with its device time by kernel:
the numbers behind ``wkv_plan``'s constants, ``eq2_plan``'s one-wave split
and its any-rank pieces; each prints one JSON line.
"""
from __future__ import annotations

import argparse
import collections
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
# PACFL at p = 16 (phase 4b): the proximity kernel's any-rank route.  Its
# planted clusters get 16 singular values from 40 down to 1 (each 0.78 of the
# last, so every direction stands well apart from its neighbours and from
# the noise); planted within-cluster eq3 ~150-250 deg, eq2 ~1.5, between
# ~1420 and ~81 (CPU sizing at K = 48).
ANY_RANK_P = 16
ANY_RANK_SPECTRUM = tuple(40.0 * (1.0 / 40.0) ** (r / 15) for r in range(16))
ANY_RANK_BETA = {"eq3": 700.0, "eq2": 30.0}
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

# LM serving (phase 6): tinyllama-1.1b's attention and rwkv6-1.6b's WKV.
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 1024, 32
LM_ARCHS = (("tinyllama-1.1b", "flash_attention"), ("rwkv6-1.6b", "wkv"))
# Whole-model float32 check (phase 7): the CPU side runs the plain twins at
# full width, so the prompt is shorter than phase 6's.
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

# The revision in which each hand-written kernel was last redesigned (earlier
# times are in PERF.md section 6).
REDESIGNED_IN = {"flash_attention": 13, "tsgemm": 13,
                 "wkv": {"prefill": 14, "decode": 16},
                 "proximity": {"eq3": 14, "eq2": 16, "any_rank": 18}}


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

    def __init__(self, torch, device, p=RANK, seed=SEED, spectrum=SPECTRUM):
        self.torch, self.device, self.n, self.p = torch, device, N_FEATURES, p
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.bases = torch.linalg.qr(self._randn(N_CLUSTERS, self.n, p))[0]
        self.spectrum = torch.tensor(spectrum[:p], device=device)

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


def profile_ms(torch, fn, *, iters=10) -> dict:
    """Device milliseconds per call of each CUDA kernel that ``fn()``
    launches, by kernel name (``torch.profiler``, after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    def short(key):
        return key.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")

    out: dict = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_time_total > 0:   # names that shorten alike add up
            out[short(e.key)] += e.device_time_total / iters / 1e3
    return dict(out)


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


def count_mma(lib_path, function_substring: str, opcodes=("HMMA", "HGMMA")) -> int:
    """Tensor-core instructions (``opcodes``) in the SASS of the functions of
    a built library whose names contain ``function_substring``."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function_substring in line
        elif inside and any(op in line for op in opcodes):
            count += 1
    return count


def resource_usage(lib_path, mangled_substring: str):
    """(registers, stack bytes) of the first function of a built library
    whose mangled name contains ``mangled_substring``
    (``cuobjdump --dump-resource-usage``), or None if none is listed."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    usage = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib_path)],
                           capture_output=True, text=True, timeout=300, check=True).stdout
    inside = False
    for line in usage.splitlines():
        if "Function" in line:
            inside = mangled_substring in line
        elif inside and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            return int(fields["REG"]), int(fields.get("STACK", "0"))
    return None


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
    hmma = count_mma(_build.library_path("flash_attention"), "flash_fwd_tc")
    log("build", f"flash_attention bf16 kernel (flash_fwd_tc): {hmma} HMMA instructions in its SASS")
    require(hmma > 0, "the bf16 flash-attention kernel has no tensor-core instructions")
    for kernel in ("eq3_tc", "eq2_tc"):
        dmma = count_mma(_build.library_path("proximity"), kernel, ("DMMA",))
        log("build", f"proximity kernel {kernel}: {dmma} DMMA instructions in its SASS")
        require(dmma > 0, f"the proximity kernel {kernel} has no FP64 tensor-core instructions")
    # the instantiations the p = 16 routes launch (phase 4b): eq3's column
    # chunks and eq2's Gram pieces, each with FP64 tensor-core instructions
    for label, mangled in any_rank_instantiations():
        dmma = count_mma(_build.library_path("proximity"), mangled, ("DMMA",))
        usage = resource_usage(_build.library_path("proximity"), mangled)
        log("build", f"p={ANY_RANK_P} route's {label}: {dmma} DMMA instructions; "
            f"{usage[0]} registers a thread, {usage[1]} bytes of stack")
        require(dmma > 0, f"{label} has no FP64 tensor-core instructions")
    # the main paths' instantiations (and the any-rank reduce, whose q x q
    # matrices live in shared memory) keep their state off the stack
    for name, label, mangled in (("proximity", "eq2_tc<3, 3>", "eq2_tcILi3ELi3E"),
                                 ("proximity", "eq2_reduce_ws<3, 3>", "eq2_reduce_wsILi3ELi3E"),
                                 ("proximity", "eq2_form_any", "eq2_form_any"),
                                 ("proximity", "eq2_jacobi_any", "eq2_jacobi_any"),
                                 ("wkv", "wkv_step<64, bf16>", "wkv_stepILi64E13__nv_bfloat16E")):
        usage = resource_usage(_build.library_path(name), mangled)
        if usage is None:
            log("build", f"{label}: not in cuobjdump's resource usage")
            continue
        log("build", f"{label}: {usage[0]} registers a thread, {usage[1]} bytes of stack")
        require(usage[1] == 0, f"{label} spills to the stack ({usage[1]} bytes)")


def any_rank_instantiations() -> list:
    """(label, mangled-name substring) of the kernel templates that eq3 and
    eq2 launch at K = 1024, n = 3072, p = ANY_RANK_P: eq3_tc on chunks of
    8 columns (and the rest), eq2_tc on the plan's Gram pieces."""
    from repro_torch.kernels.proximity.proximity import MAX_TC_RANK, eq2_plan

    chunks = {min(MAX_TC_RANK, ANY_RANK_P - r0) for r0 in range(0, ANY_RANK_P, MAX_TC_RANK)}
    plan = eq2_plan(N_CLIENTS, N_CLIENTS, N_FEATURES, ANY_RANK_P, ANY_RANK_P, True)
    out = [(f"eq3_tc<{w}>", f"eq3_tcILi{w}E") for w in sorted(chunks)]
    out += [(f"eq2_tc<{pc.rows}, {pc.cols}>", f"eq2_tcILi{pc.rows}ELi{pc.cols}E")
            for pc in plan.pieces()]
    return out


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
    # ranks above the templates' 8: the any-rank route (eq3 in column chunks,
    # eq2 in Gram pieces) at p = 9, 12, 16, ragged K, mixed ranks and
    # column views of a wider stack (16-byte row quads at offset 4, element
    # copies at offset 2); each launched twice, bitwise equal
    fed12 = Federation(torch, fed.device, p=12, seed=SEED + 4)
    U12 = fed12.signatures(planted(256))
    U16 = Federation(torch, fed.device, p=16, seed=SEED + 5).signatures(planted(N_CLIENTS))
    U20 = Federation(torch, fed.device, p=20, seed=SEED + 6).signatures(planted(200))
    U9 = Federation(torch, fed.device, p=9, seed=SEED + 12).signatures(planted(256))
    high = [(f"square K=256 p={p}", U, U) for p, U in ((9, U9), (12, U12), (16, U16[:256]))]
    high += [("square ragged K=250 p=12", U12[:250], U12[:250]),
             ("square K=200 p=16 column view [4:20] of p=20", U20[:, :, 4:], U20[:, :, 4:]),
             ("square K=200 p=16 column view [2:18] of p=20", U20[:, :, 2:18], U20[:, :, 2:18]),
             ("cross 200x37 p=16 column views", U20[:, :, 4:], U20[:37, :, 2:18])]
    for label, Ua, Ub in high:
        for measure in ("eq3", "eq2"):
            compare(label, Ua, Ub, measure, Ua is Ub)
            first, second = proximity_cuda(Ua, Ub, measure), proximity_cuda(Ua, Ub, measure)
            torch.cuda.synchronize()
            require(torch.equal(first, second), f"proximity {measure} {label}: two launches differ")
        log("kernels", f"proximity eq3 and eq2 {label}: two launches bitwise equal")
    for label, Ua, Ub in (("cross 1024x256 p=3 x q=12", U3, U12), ("cross 256x1024 p=12 x q=3", U12, U3),
                          ("cross 37x256 p=3 x q=12", newcomers, U12)):
        compare(label, Ua, Ub, "eq2", False)
        first, second = proximity_cuda(Ua, Ub, "eq2"), proximity_cuda(Ua, Ub, "eq2")
        torch.cuda.synchronize()
        require(torch.equal(first, second), f"proximity eq2 {label}: two launches differ")
    del U9, U20
    # eq2 at its plan's cases: mix4's square (split over n), the churn
    # admission's cross block and square (phase 5), PACFL's K = 1024 square
    # (one kernel, no split); a split call is the same bitwise twice
    from repro_torch.kernels.proximity.proximity import eq2_plan

    U97 = fed.signatures(planted(MIX4_K))
    members = MIX4_K - len(CHURN_LEAVES)
    joins = fed.signatures(planted(CHURN_JOINS))
    for label, Ua, Ub in ((f"square K={MIX4_K} (mix4)", U97, U97),
                          (f"cross {members}x{CHURN_JOINS} (churn admission)", U97[:members], joins),
                          (f"square K={CHURN_JOINS} (churn admission)", joins, joins),
                          (f"square K={N_CLIENTS}", U3, U3)):
        plan = eq2_plan(Ua.shape[0], Ub.shape[0], Ua.shape[1], Ua.shape[2], Ub.shape[2], Ua is Ub)
        log("kernels", f"proximity eq2 {label}: {plan}")
        compare(label, Ua, Ub, "eq2", Ua is Ub)
        first, second = proximity_cuda(Ua, Ub, "eq2"), proximity_cuda(Ua, Ub, "eq2")
        torch.cuda.synchronize()
        require(torch.equal(first, second), f"proximity eq2 {label}: two launches differ")
        log("kernels", f"proximity eq2 {label}: two launches bitwise equal")
    # the model-based signature families' ambient dimensions (phase 9): the
    # weight-delta sketch (n = 256), the inference probe (48 rows x 4
    # datasets = 192) and a ragged probe (200), at mix4's K = 97 (eq2 split
    # over n) and label20's K = 100; each launched twice, bitwise equal
    gen = torch.Generator(device=fed.device).manual_seed(SEED + 9)
    for n in FAMILY_DIMS:
        for K in (MIX4_K, 100):
            U = torch.linalg.qr(torch.randn((K, n, RANK), generator=gen, device=fed.device))[0]
            U = U.contiguous()
            for measure in ("eq3", "eq2"):
                label = f"square K={K} n={n}"
                if measure == "eq2":
                    log("kernels", f"proximity eq2 {label}: "
                        f"{eq2_plan(K, K, n, RANK, RANK, True)}")
                compare(label, U, U, measure, True)
                first, second = proximity_cuda(U, U, measure), proximity_cuda(U, U, measure)
                torch.cuda.synchronize()
                require(torch.equal(first, second), f"proximity {measure} {label}: two launches differ")
            log("kernels", f"proximity eq3 and eq2 square K={K} n={n}: two launches bitwise equal")
    # the square launches only the upper-triangle tiles (eq3 mirrors each
    # value, eq2 runs both epilogues of a pair): it must equal the full
    # rectangle of the stack against a copy of itself, where both take one
    # split (eq3's square is also exactly symmetric)
    for label, U, measure in (("K=1024 p=3", U3, "eq3"), ("ragged K=1000 p=3", U3[:1000], "eq3"),
                              ("K=1024 p=5", U5, "eq3"), ("K=1024 p=3", U3, "eq2"),
                              ("ragged K=1000 p=3", U3[:1000], "eq2"),
                              ("K=1024 p=16", U16, "eq3"), ("K=1024 p=16", U16, "eq2")):
        square = proximity_cuda(U, U, measure)
        cross = proximity_cuda(U, U.clone(), measure)
        torch.cuda.synchronize()
        diff = (square - cross).abs().max().item()
        symmetric = bool((square == square.T).all())
        log("kernels", f"proximity square {label} {measure} vs cross against a clone: "
            f"max|square - cross| = {diff:.3e}, square symmetric: {symmetric}")
        require(diff == 0.0 and (symmetric or measure == "eq2"),
                f"proximity square {label} {measure}: the triangle differs from the rectangle by {diff}")


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


def wkv_inputs(torch, gen, B, S, H, hd, device, fast=False):
    """r, k, v, w, u at the model's scales: decay w = exp(-exp(ww)) with
    ww = -6 + noise (the model's init, w ~ 0.9975), or with ``fast`` ww ~
    U[-6, 2] (w down to ~6e-4, as trained RWKV-6 decays reach)."""
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=device) for _ in range(3))
    if fast:
        ww = -6.0 + 8.0 * torch.rand((B, S, H, hd), generator=gen, device=device)
    else:
        ww = -6.0 + 0.5 * torch.randn((B, S, H, hd), generator=gen, device=device)
    w = torch.exp(-torch.exp(ww))
    u = 0.1 * torch.randn((H, hd), generator=gen, device=device)
    return r, k, v, w, u


def check_wkv(torch, device, errs: list) -> None:
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    H, hd = 32, 64   # rwkv6-1.6b

    def compare(label, ops, state0):
        plan = wkv_plan(ops[0].shape[1])
        out, st = wkv_cuda(*ops, state0)
        want_out, want_st = wkv_plain(*(a.float() for a in ops), state0)
        torch.cuda.synchronize()
        e_out = ((out - want_out).abs().max() / want_out.abs().max()).item()
        e_st = ((st - want_st).abs().max() / want_st.abs().max()).item()
        log("kernels", f"wkv {label}: r {tuple(ops[0].shape)} {str(ops[0].dtype)[6:]} "
            f"{plan.route} (chunk {plan.chunk}) max|kernel - plain| / max|plain| "
            f"= {e_out:.3e} (out), {e_st:.3e} (state) (limit {WKV_REL_TOL})")
        require(bool(torch.isfinite(out).all()) and max(e_out, e_st) <= WKV_REL_TOL,
                f"wkv {label}: {e_out}, {e_st}")
        errs.append(max((out - want_out).abs().max().item(), (st - want_st).abs().max().item()))
        return st

    def bf16(ops):   # the serving path's r, k, v
        return tuple(a.to(torch.bfloat16) if i < 3 else a for i, a in enumerate(ops))

    ops = wkv_inputs(torch, gen, LM_BATCH, LM_PROMPT, H, hd, device)
    state0 = 0.1 * torch.randn((LM_BATCH, H, hd, hd), generator=gen, device=device)
    compare("prefill", ops, None)
    state = compare("prefill with state0", ops, state0)
    compare("prefill with state0, bfloat16 r k v", bf16(ops), state0)
    step = wkv_inputs(torch, gen, LM_BATCH, 1, H, hd, device)
    compare("decode S=1, carried state", step, state)
    compare("decode S=1, carried state, bfloat16 r k v", bf16(step), state)
    for S in (16, 32):   # the recurrent route below CHUNKED_MIN_S
        compare(f"recurrent S={S}, carried state", wkv_inputs(torch, gen, LM_BATCH, S, H, hd,
                                                               device), state)
    fast = wkv_inputs(torch, gen, LM_BATCH, LM_PROMPT, H, hd, device, fast=True)
    compare("prefill, fast decay", fast, None)
    compare("prefill with state0, fast decay", fast, state0)
    compare("prefill with state0, fast decay, bfloat16 r k v", bf16(fast), state0)
    compare("ragged: S=1000 with state0, fast decay",
            tuple(a[:, :1000] if i < 4 else a for i, a in enumerate(fast)), state0)


def planted_data(torch, fed) -> dict:
    """Phase 4's clients, newcomers and queries, drawn from ``fed``'s
    planted clusters, with each one's planted cluster id."""
    truth = planted(N_CLIENTS)
    new_truth = [(3 * t + 1) % N_CLUSTERS for t in range(N_NEWCOMERS)]
    q_truth = [(5 * t + 2) % N_CLUSTERS for t in range(N_QUERIES)]
    data = {"truth": truth, "clients": fed.clients(truth), "new_truth": new_truth,
            "newcomers": fed.clients(new_truth), "q_truth": q_truth,
            "queries": fed.clients(q_truth)}
    sync(torch, fed.device)
    return data


def pacfl_path(torch, fed, config, data, tag) -> dict:
    """One-shot clustering of ``data``'s clients, PME admission of its
    newcomers and its queries served in batches of QUERY_BATCH through the
    medoid representative cache, with the kernel launches of the run
    (counts set to 0 just before it, read just after); checks that the
    planted clusters are recovered and every newcomer and query lands in
    its own, and prints the proximity's within- and between-cluster ranges."""
    from repro_torch.core.pacfl import compute_signatures, one_shot_clustering
    from repro_torch.kernels import _build
    from repro_torch.serving import RepresentativeCache, serve_assign

    truth, new_truth, q_truth = data["truth"], data["new_truth"], data["q_truth"]
    log(tag, f"K={N_CLIENTS} clients n={N_FEATURES} p={config.p}, M_k in {M_RANGE}, "
        f"{N_CLUSTERS} planted clusters; {config}")
    _build.reset_launches()
    t0 = time.perf_counter()
    clustering = one_shot_clustering(data["clients"], config, seed=SEED, device=fed.device)
    sync(torch, fed.device)
    t1 = time.perf_counter()
    U_new = compute_signatures(data["newcomers"], config, seed=SEED + 10, device=fed.device)
    extended = clustering.extend(U_new)
    t2 = time.perf_counter()
    cache = RepresentativeCache("medoid")
    cache.refresh(extended.engine)
    assigned, queries = [], []
    for lo in range(0, N_QUERIES, QUERY_BATCH):
        U_q = compute_signatures(data["queries"][lo:lo + QUERY_BATCH], config,
                                 seed=SEED + 100 + lo, device=fed.device)
        idx, dmin = serve_assign(U_q, cache.rep_stack, config.measure)
        require(bool(torch.isfinite(dmin).all()), "non-finite serving distance")
        assigned.append(idx.cpu())
        queries.append(U_q)
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    routes = dict(_build.ROUTE_LAUNCHES)
    log(tag, f"one-shot {t1 - t0:.2f} s, extend {t2 - t1:.2f} s, "
        f"serve {t3 - t2:.2f} s; kernel launches {launches}, proximity by route "
        f"{ {r: c for (k, r), c in routes.items() if k == 'proximity'} }")

    labels = clustering.labels
    require(clustering.U.shape == (N_CLIENTS, N_FEATURES, config.p), "signature shape")
    A = clustering.A
    require(bool((A == A.T).all()) and float(abs(A.diagonal()).max()) == 0.0, "hygiene")
    planted_ids = torch.as_tensor(truth)
    same = planted_ids[:, None] == planted_ids[None, :]
    off = ~torch.eye(N_CLIENTS, dtype=torch.bool)
    At = torch.as_tensor(A)
    log(tag, f"{config.measure} within planted clusters {float(At[same & off].min()):.3f}-"
        f"{float(At[same & off].max()):.3f} deg, between {float(At[~same].min()):.3f}-"
        f"{float(At[~same].max()):.3f} deg (beta {config.beta})")
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
        require(launches.get(name, 0) > 0, f"the {name} kernel never ran on the {tag} path")
    log(tag, f"recovered {clustering.n_clusters} planted clusters; "
        f"{N_NEWCOMERS} newcomers and {N_QUERIES} queries in their clusters")
    return {"launches": launches, "routes": routes, "engine": extended.engine,
            "config": config, "queries": torch.cat(queries), "served": served,
            "label_of": label_of}


def phase_main_path(torch, fed) -> dict:
    from repro_torch.core.pacfl import PACFLConfig

    config = PACFLConfig(p=RANK, measure="eq3", beta=BETA_DEG,
                         svd_method="randomized_tsgemm", proximity_backend="auto")
    return pacfl_path(torch, fed, config, planted_data(torch, fed), "main")


def phase_any_rank(torch, device) -> dict:
    """Phase 4b: phase 4's PACFL path at p = ANY_RANK_P (rank-16 planted
    clusters with a 16-value spectrum), once under eq3 and once under eq2,
    each its own launch window; both must launch the proximity kernel's
    any-rank route."""
    from repro_torch.core.pacfl import PACFLConfig

    fed = Federation(torch, device, p=ANY_RANK_P, seed=SEED + 11, spectrum=ANY_RANK_SPECTRUM)
    data = planted_data(torch, fed)
    launches, routes = collections.Counter(), collections.Counter()
    for measure in ("eq3", "eq2"):
        config = PACFLConfig(p=ANY_RANK_P, measure=measure, beta=ANY_RANK_BETA[measure],
                             svd_method="randomized_tsgemm", proximity_backend="auto")
        run = pacfl_path(torch, fed, config, data, f"p{ANY_RANK_P}")
        route = ("proximity", f"{measure}_any_rank")
        require(run["routes"].get(route, 0) > 0,
                f"PACFL at p={ANY_RANK_P} under {measure} never launched the any-rank route")
        launches.update(run["launches"])
        routes.update(run["routes"])
    return {"launches": dict(launches), "routes": dict(routes)}


# FL loop (phase 5): the launcher's settings (launch/fl_train.py) on LeNet-5
# at CIFAR-10 geometry.  mix4 with 100 requested clients gives 31/25/27/14 =
# 97; the reference's one-shot partition of them, by dataset name:
FL_DIM, FL_CLIENTS, FL_ROUNDS, FL_STRATEGY_ROUNDS = 3072, 100, 20, 3
MIX4_K = 97
MIX4_PARTITION = ({"cifar10s", "svhns"}, {"fmnists"}, {"uspss"})
REPEAT_ROUNDS = 3   # the same-seed mix4 runs that must agree bitwise
CHURN_JOINS, CHURN_LEAVES = 8, (0, 10, 40, 90)   # fmnists newcomers; positions
SERVER_JOINS, SERVER_ORACLE = 64, 16
FL_BUDGET_S = 120.0


def _timed(torch, device, fn):
    t0 = time.perf_counter()
    out = fn()
    sync(torch, device)
    return out, time.perf_counter() - t0


EQ2, EQ3 = ("proximity", "eq2"), ("proximity", "eq3")


def _counted(torch, device, fn, totals):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after (device synced): returns ``(out, seconds, launches by kernel,
    launches by (kernel, route))`` and adds the counts into ``totals``."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    out, dt = _timed(torch, device, fn)
    launches = collections.Counter(_build.LAUNCHES)
    routes = collections.Counter(_build.ROUTE_LAUNCHES)
    totals["launches"].update(launches)
    totals["routes"].update(routes)
    return out, dt, launches, routes


def phase_fl(torch, device, main) -> dict:
    """Phase 5: the federated-learning loop and the assignment server.

    Every federation runs through ``run_federation``, each with the launch
    counts set to 0 just before it and read just after (but for the two
    short same-seed mix4 runs that check repeatability).  mix4 PACFL (eq2,
    beta 50, exact SVD) at 97 clients must find the reference's three
    clusters and train 20 rounds above chance; on label20 (eq3, beta 175)
    PACFL must beat FedAvg after 20 rounds; all ten strategies run 3 rounds;
    a churn event admits 8 fmnists newcomers into the fmnists cluster
    through more proximity launches than the mix4 run's; and the
    AssignmentServer over phase 4's engine answers as phase 4's dispatch
    and ``admit_oracle`` did (the oracle runs outside every counted window),
    launching the proximity kernel itself, then drains 64 newcomers into
    their planted clusters.  Returns the launches summed over the counted
    runs and the timings."""
    import numpy as np

    from repro_torch._device import float32_math
    from repro_torch.core.pacfl import compute_signatures
    from repro_torch.data import make_dataset
    from repro_torch.fl import STRATEGIES, ChurnEvent, mix_datasets, run_federation
    from repro_torch.fl.trainer import round_generator, sample_round
    from repro_torch.launch.fl_train import MIX4, build_clients, fl_config
    from repro_torch.models.cnn import build_model
    from repro_torch.serving import AssignmentServer, admit_oracle

    t_phase = time.perf_counter()
    totals = {"launches": collections.Counter(), "routes": collections.Counter()}
    out = {}
    # -- mix4: one-shot partition, then 20 rounds, from the process's first --
    # -- FL round; an evaluation after each round gives each round's time ---
    (clients, n_classes), t_data = _timed(torch, device, lambda: build_clients(
        "mix4", FL_CLIENTS, FL_DIM, 3000))
    cfg = fl_config("mix4", FL_ROUNDS)
    model = build_model("lenet5", dim=FL_DIM, n_classes=n_classes)
    log("fl", f"mix4: {len(clients)} clients x 300 samples at dim {FL_DIM} (data {t_data:.2f} s "
        f"on the host); LeNet-5 {model.in_hw}x{model.in_ch}, {n_classes} classes; {cfg}")
    res, t_run, _, routes = _counted(torch, device, lambda: run_federation(
        "pacfl", clients, model, cfg, seed=SEED, eval_every=1, device=device), totals)
    strat = res.strategy_obj
    mix4_eq2 = routes[EQ2]
    names = np.array([c.dataset_name for c in clients])
    groups = sorted(({str(n) for n in names[strat.labels == z]}
                     for z in np.unique(strat.labels)), key=sorted)
    log("fl", f"mix4 PACFL: {strat.clustering.n_clusters} clusters "
        f"{[sorted(g) for g in groups]}; proximity launches by route {dict(routes)}")
    require(len(clients) == MIX4_K, f"mix4: {len(clients)} clients, not {MIX4_K}")
    require(strat.clustering.n_clusters == 3
            and sorted(groups, key=sorted) == sorted(MIX4_PARTITION, key=sorted),
            f"mix4 partition {groups} is not the reference's {MIX4_PARTITION}")
    require(mix4_eq2 >= 1, "the mix4 run launched no eq2 kernel")
    # RoundRecord.seconds: since round 1 began, after that round's evaluation
    ends = [r.seconds for r in res.records]
    require([r.rnd for r in res.records] == list(range(1, FL_ROUNDS + 1)), "mix4 records")
    per_round = np.diff([0.0] + ends)
    window = ends[-1]
    mix4_acc = res.final_mean
    mix4_accs = [r.mean_acc for r in res.records]
    log("fl", f"mix4 PACFL through run_federation: {t_run:.3f} s, of which {FL_ROUNDS} rounds "
        f"of {int(round(cfg.sample_frac * len(clients)))} clients x {strat._steps} local steps, "
        f"each followed by an evaluation of {len(clients)} clients, {window:.3f} s "
        f"({window / FL_ROUNDS * 1e3:.1f} ms a round; the entry point's records); the first "
        f"round {per_round[0] * 1e3:.1f} ms, the other {FL_ROUNDS - 1} median "
        f"{statistics.median(per_round[1:]) * 1e3:.1f} ms; the rest of the call (stacking, "
        f"PACFL setup, final evaluation) {t_run - window:.3f} s; mean accuracy {mix4_acc:.4f} "
        f"(chance {1 / n_classes:.4f}); comm {(strat.comm_up + strat.comm_down) / 1e6:.1f} MB")
    require(bool(np.isfinite(res.final_accs).all()) and mix4_acc > 1.0 / n_classes,
            f"mix4 accuracy {mix4_acc} not above chance")
    # where a warm round's time goes: device time by kernel (torch.profiler)
    # against the host clock of the same round, at the entry point's precision
    sampled = sample_round(np.random.default_rng(SEED), strat.data.n_clients, cfg.sample_frac)
    idx = strat.draw_indices(sampled, round_generator(SEED, FL_ROUNDS + 1, device))

    def one_round():
        strat.run_round(FL_ROUNDS + 1, sampled, idx)

    with float32_math():
        kernels = profile_ms(torch, one_round, iters=3)
        host_ms = statistics.median(_timed(torch, device, one_round)[1] for _ in range(3)) * 1e3
        _, t_eval = _timed(torch, device, strat.evaluate)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    out.update(call_s=t_run, window_s=window, first_round_s=float(per_round[0]),
               round_ms=window / FL_ROUNDS * 1e3, warm_round_ms=host_ms,
               round_device_ms=busy_ms, eval_s=t_eval)
    log("fl", f"mix4 warm round: {host_ms:.1f} ms on the host clock, {busy_ms:.1f} ms of device "
        f"kernels ({len(kernels)} kernels; device idle {1 - busy_ms / host_ms:.1%}); an "
        f"evaluation of {len(clients)} clients {t_eval * 1e3:.1f} ms; largest: "
        + ", ".join(f"{k[:48]} {v:.2f} ms" for k, v in top))

    # -- mix4 twice more with the same seed: bitwise the same (a check, so ---
    # -- outside the counted windows) -----------------------------------------
    def mix4_again():
        again = run_federation("pacfl", clients, model, fl_config("mix4", REPEAT_ROUNDS),
                               seed=SEED, eval_every=1, device=device)
        st = again.strategy_obj
        return ([r.mean_acc for r in again.records], st.labels.copy(), again.final_accs,
                {k: v.detach().clone() for k, v in st.cluster_params.items()})

    (acc_a, lab_a, fin_a, par_a), t_a = _timed(torch, device, mix4_again)
    (acc_b, lab_b, fin_b, par_b), t_b = _timed(torch, device, mix4_again)
    same = (acc_a == acc_b and np.array_equal(lab_a, lab_b) and np.array_equal(fin_a, fin_b)
            and par_a.keys() == par_b.keys() and all(torch.equal(par_a[k], par_b[k]) for k in par_a))
    log("fl", f"mix4 again, twice, {REPEAT_ROUNDS} rounds, seed {SEED} ({t_a:.2f} s, {t_b:.2f} s): "
        f"labels, round accuracies {acc_a} and final parameters bitwise equal: {same}; the "
        f"{FL_ROUNDS}-round run's first {REPEAT_ROUNDS} rounds {mix4_accs[:REPEAT_ROUNDS]}")
    require(same, f"mix4 is not repeatable: accuracies {acc_a} vs {acc_b}")
    require(acc_a == mix4_accs[:REPEAT_ROUNDS] and np.array_equal(lab_a, strat.labels),
            "mix4: the short runs differ from the 20-round run's first rounds")

    # -- label20: PACFL beats FedAvg -------------------------------------------
    (clients20, n20), t_data = _timed(torch, device, lambda: build_clients(
        "label20", FL_CLIENTS, FL_DIM, 3000))
    model20 = build_model("lenet5", dim=FL_DIM, n_classes=n20)
    cfg20 = fl_config("label20", FL_ROUNDS)
    finals = {}
    for name in ("pacfl", "fedavg"):
        res, t_run, _, routes = _counted(torch, device, lambda: run_federation(
            name, clients20, model20, cfg20, seed=SEED, eval_every=FL_ROUNDS, device=device),
            totals)
        finals[name] = res.final_mean
        extra = (f", {res.strategy_obj.clustering.n_clusters} clusters through "
                 f"{routes[EQ3]} eq3 launches" if name == "pacfl" else "")
        log("fl", f"label20 {name}: {len(clients20)} clients, {FL_ROUNDS} rounds in "
            f"{t_run:.2f} s; final mean accuracy {res.final_mean:.4f}{extra}")
        require(np.isfinite(res.final_mean), f"label20 {name}: non-finite accuracy")
        require(name != "pacfl" or routes[EQ3] >= 1, "label20 PACFL launched no eq3 kernel")
    require(finals["pacfl"] > finals["fedavg"],
            f"label20: PACFL {finals['pacfl']} does not beat FedAvg {finals['fedavg']}")

    # -- every strategy, 3 rounds on label20 -----------------------------------
    cfg3 = fl_config("label20", FL_STRATEGY_ROUNDS)
    for name in sorted(STRATEGIES):
        res, t_run, _, routes = _counted(torch, device, lambda: run_federation(
            name, clients20, model20, cfg3, seed=SEED, eval_every=FL_STRATEGY_ROUNDS,
            device=device), totals)
        s_ = res.strategy_obj
        comm = s_.comm_up + s_.comm_down
        log("fl", f"strategy {name}: {FL_STRATEGY_ROUNDS} rounds in {t_run:.2f} s, final mean "
            f"accuracy {res.final_mean:.4f}, comm {comm / 1e6:.2f} MB")
        require(bool(np.isfinite(res.final_accs).all()), f"{name}: non-finite accuracy")
        require((comm == 0) == (name == "solo"), f"{name}: communication {comm}")
        require(name != "pacfl" or routes[EQ3] >= 1, "strategy pacfl launched no eq3 kernel")

    # -- churn: fmnists newcomers join a mix4 federation -----------------------
    dss = [make_dataset(n, n_train=3000, n_test=800, dim=FL_DIM) for n in MIX4]
    newcomers = mix_datasets(dss, [0, 0, CHURN_JOINS, 0], samples_per_client=300, seed=SEED + 1)
    res, t_run, _, routes = _counted(torch, device, lambda: run_federation(
        "pacfl", clients, model, fl_config("mix4", 3), seed=SEED, eval_every=3,
        churn=[ChurnEvent(rnd=2, join=newcomers, leave=list(CHURN_LEAVES))], device=device),
        totals)
    churn_eq2 = routes[EQ2]
    s_ = res.strategy_obj
    kept = [c for i, c in enumerate(clients) if i not in CHURN_LEAVES]
    fm_labels = {int(s_.labels[i]) for i, c in enumerate(kept) if c.dataset_name == "fmnists"}
    new_labels = [int(x) for x in s_.labels[len(kept):]]
    log("fl", f"churn: {CHURN_JOINS} fmnists newcomers joined, {len(CHURN_LEAVES)} left in "
        f"{t_run:.2f} s (3 rounds); K = {len(res.final_accs)}, newcomer labels {new_labels}, "
        f"fmnists cluster {sorted(fm_labels)}; eq2 launches {churn_eq2} (the same setup "
        f"without churn, the mix4 run: {mix4_eq2})")
    require(len(res.final_accs) == len(clients) - len(CHURN_LEAVES) + CHURN_JOINS,
            "churn: wrong client count")
    require(len(fm_labels) == 1 and set(new_labels) == fm_labels,
            "churn: a newcomer left the fmnists cluster")
    require(churn_eq2 > mix4_eq2, "churn: the admission launched no proximity kernel")

    # -- AssignmentServer over phase 4's engine --------------------------------
    engine, queries = main["engine"], main["queries"]
    server = AssignmentServer(engine, batch_max=QUERY_BATCH)
    # the check's own work, outside the counted windows: the oracle's
    # admissions on engine forks and the newcomers' signatures
    oracle = [admit_oracle(engine, queries[i]) for i in range(SERVER_ORACLE)]
    fed = Federation(torch, device)
    truth = [(7 * t + 3) % N_CLUSTERS for t in range(SERVER_JOINS)]
    U_new = compute_signatures(fed.clients(truth), main["config"], seed=SEED + 500,
                               device=device)
    many, t_many, launches, _ = _counted(
        torch, device, lambda: server.assign_many(list(queries)), totals)
    require(launches["proximity"] > 0, "server: assign_many launched no proximity kernel")
    require([int(x) for x in many.labels] == [int(x) for x in main["served"]],
            "server: assign_many differs from phase 4's serve_assign")
    for i, (lbl, new) in enumerate(oracle):
        require(not new and lbl == int(many.labels[i]), f"server: query {i} vs admit_oracle")
    lat = []
    for lo in range(0, N_QUERIES, QUERY_BATCH):
        _, dt, launches, _ = _counted(
            torch, device, lambda: server.assign(queries[lo:lo + QUERY_BATCH]), totals)
        require(launches["proximity"] > 0, "server: assign launched no proximity kernel")
        lat.append(dt)
    epoch0 = server.epoch

    def join_and_drain():
        ids = [server.submit_join(U_new[t]) for t in range(SERVER_JOINS)]
        return ids, server.drain()

    (ids, report), t_drain, launches, _ = _counted(torch, device, join_and_drain, totals)
    label_of = dict(zip(engine.ids.tolist(), engine.labels.tolist()))
    require(report.joins == SERVER_JOINS and server.epoch == epoch0 + 1, f"server: {report}")
    require(launches["proximity"] > 0, "server: the drain launched no proximity kernel")
    require([label_of[i] for i in ids] == [main["label_of"][c] for c in truth],
            "server: a drained newcomer left its planted cluster")
    out.update(serve_batch_ms=statistics.median(lat) * 1e3, drain_s=t_drain)
    log("fl", f"server: assign_many of {N_QUERIES} queries {t_many * 1e3:.1f} ms, equal to "
        f"phase 4's dispatch and to admit_oracle on {SERVER_ORACLE}; assign per batch of "
        f"{QUERY_BATCH}: median {statistics.median(lat) * 1e3:.3f} ms; {SERVER_JOINS} joins "
        f"submitted and drained in {t_drain:.3f} s ({launches['proximity']} proximity "
        f"launches) -> epoch {server.epoch}, each in its planted cluster")
    elapsed = time.perf_counter() - t_phase
    log("fl", f"phase 5 took {elapsed:.1f} s (budget {FL_BUDGET_S:.0f} s); launches summed "
        f"over its counted runs {dict(totals['launches'])}, by route {dict(totals['routes'])}")
    require(elapsed <= FL_BUDGET_S, f"phase 5 took {elapsed:.1f} s")
    out["routes"] = dict(totals["routes"])
    out["launches"] = dict(totals["launches"])
    out.update(mix4_clients=clients, mix4_labels=strat.labels.copy(), newcomers=newcomers)
    return out


# Model-based signature families (phase 9) on phase 5's mix4 federation: the
# experiment suite's settings (experiments/run_fl_suite.py, FAMILY_PARAMS and
# fam_pacfl's beta_quantile 0.1) with the launcher's other settings.
FAMILY_PARAMS = {"weight_delta": {"segments": 4, "steps": 8, "sketch_dim": 256},
                 "inference": {"probe_per_dataset": 48, "steps": 16}}
FAMILY_QUANTILE = 0.1
FAMILY_DIMS = (256, 192, 200)   # the sketch, the probe (48 x 4 datasets), a ragged probe
FAMILY_ROUNDS, FAMILY_CHURN_ROUNDS = 10, 3
FAMILY_CHECK_K = 16             # clients of the card-against-CPU check
# The card against the CPU, from one set of draws (theta_0, minibatch
# indices, sketch), on the first FAMILY_CHECK_K clients.  The two differ only
# in the order of float32 sums (cuDNN and cuBLAS against the CPU's), but 32
# (weight_delta) or 16 (inference) SGD steps of a ReLU / max-pool network
# carry such differences along and let some cross a gate, and a signature's
# last direction sits on a small singular gap (the sketched deltas' third and
# fourth singular values are ~1/20 and ~1/30 of the first), so they grow.
# On an H100 with LeNet-5 at 32x32x3 the sketched weight deltas differ by a
# median 1e-4 (relative) after the first segment of 8 steps and 3e-3 after
# the fourth, and the card alone moves a client's basis by up to 5.5 degrees
# (median 0.1) when theta_0's nonzero entries move by one ulp (the floor,
# printed beside).  So the checks are:
# - weight_delta's first segment, before most of the growth: the median
#   client's sketched delta within 1e-3 relative (TF32 products, ~1e-3 each,
#   or a wrong reduction give 1e-2 and more);
# - each client's largest principal angle: median within 5 degrees, max
#   within 20 (unrelated subspaces, from a wrong draw or layout, are ~90);
# - beta_quantile labels bitwise equal where the card and the CPU cluster the
#   same float32 signatures (the card's), under each measure that resolves
#   the family's distances (FAMILY_LABEL_MEASURES).  Each side's labels from
#   its own signatures are printed, not required equal: a quantile's
#   threshold sits among the distances, and the inference family's floor
#   (up to 0.6 degrees) moves merges across it.
FAMILY_SEGMENT_RTOL = 1e-3
FAMILY_ANGLE_MEDIAN_TOL_DEG, FAMILY_ANGLE_MAX_TOL_DEG = 5.0, 20.0
# eq2 (the smallest principal angle) barely tells inference signatures
# apart: every client's prediction matrix shares its leading direction (the
# mean prediction), so the 16 clients' eq2 distances all fall in 0.19-0.63
# degrees (LeNet-5 at 32x32x3 on an H100; 0-0.04 at 16x16x3), where a float32
# arccos near 1 resolves ~1e-3 degree, about the gap between neighbouring
# distances: the card's kernel and the CPU's twin put a quantile's threshold
# among them differently.  Its eq2 labels are printed; eq3 (all p angles,
# 26-106 degrees apart there) is held.
FAMILY_LABEL_MEASURES = {"weight_delta": ("eq2", "eq3"), "inference": ("eq3",)}
DRIFT_MOVERS = 8
# Table-6 distances on the card against the CPU: two synthetic datasets at
# d = 256 (covariance condition numbers ~1e4); float32 solves and
# log-determinants in another order agree to ~1e-6 x the conditioning.
SIM_DIM, SIM_SAMPLES, SIM_RTOL = 256, 400, 1e-3
FAMILY_BUDGET_S = 150.0


def client_angles_deg(torch, Ua, Ub) -> list:
    """Each client's largest principal angle, in degrees, between the column
    spans of two (K, n, p) stacks: the arcsine of the spectral norm of
    ``Ub - Ua Ua^T Ub``, in float64 on the host."""
    import math

    Ua, Ub = Ua.detach().double().cpu(), Ub.detach().double().cpu()
    R = Ub - Ua @ (Ua.transpose(1, 2) @ Ub)
    return [math.degrees(math.asin(min(1.0, s))) for s in torch.linalg.matrix_norm(R, ord=2).tolist()]


def rand_index(a, b) -> float:
    """Share of client pairs on which two labelings agree (same / apart)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    same_a, same_b = a[:, None] == a[None], b[:, None] == b[None]
    iu = np.triu_indices(a.size, 1)
    return float((same_a == same_b)[iu].mean())


def phase_families(torch, device, main, fl) -> dict:
    """Phase 9: the model-based signature families, drift and Table 6.

    For ``weight_delta`` (sketch n = 256) and ``inference`` (probe n = 192)
    on mix4's 97 clients with LeNet-5 at 32x32x3 and 40 classes, each call
    in its own launch window: the one-shot signatures (timed), one-shot
    clustering through at least one eq2 launch, and a 10-round
    ``run_federation`` to a finite accuracy through eq2 (printing its
    clusters and their agreement with the svd family's partition of phase
    5).  Checks outside the windows: the 97 signatures again with one seed,
    bitwise equal; the first 16 clients on the card and on the CPU from
    draws made once on the CPU (the limits and why: above
    ``FAMILY_SEGMENT_RTOL``).  Then a 3-round ``weight_delta`` run in
    which 8 fmnists clients join and 4 leave (the admission's cross block
    and square: two more eq2 launches at n = 256); one ``DriftTracker``
    observation of phase 4's engine after a fused ``move`` on the card,
    against the same move and observation on a CPU copy; and BD, KL and
    MMD at d = 256 on the card against the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.core import similarity
    from repro_torch.core.engine import DriftTracker
    from repro_torch.core.pacfl import cluster_clients, compute_signatures, one_shot_clustering
    from repro_torch.core.signatures import (
        FamilyContext, get_family, inference, payloads_from_stacked, weight_delta)
    from repro_torch.core.signatures.warmup import warmup_indices
    from repro_torch.data import make_dataset
    from repro_torch.fl import ChurnEvent, run_federation
    from repro_torch.fl.client import stack_clients
    from repro_torch.launch.fl_train import fl_config
    from repro_torch.models.cnn import build_model

    t_phase = time.perf_counter()
    totals = {"launches": collections.Counter(), "routes": collections.Counter()}
    cpu = torch.device("cpu")
    clients, svd_labels = fl["mix4_clients"], fl["mix4_labels"]
    model = build_model("lenet5", dim=FL_DIM, n_classes=40)
    n_params = sum(p.numel() for p in model.parameters())
    payloads = payloads_from_stacked(stack_clients(clients))
    out = {"signature_s": {}, "angle_deg": {}, "floor_deg": {}}

    def family_cfg(family, rounds):
        cfg = fl_config("mix4", rounds)
        return dataclasses.replace(cfg, pacfl=dataclasses.replace(
            cfg.pacfl, family=family, beta_quantile=FAMILY_QUANTILE,
            family_params=dict(FAMILY_PARAMS[family])))

    run_eq2 = {}
    for family, module, n in (("weight_delta", weight_delta, 256), ("inference", inference, 192)):
        cfg = family_cfg(family, FAMILY_ROUNDS)
        pcfg = cfg.pacfl
        ctx = get_family(family).prepare_context(
            payloads, pcfg, FamilyContext(model=model, seed0=SEED))

        def signatures():
            return compute_signatures(payloads, pcfg, seed=SEED, context=ctx, device=device)

        U, t_sig, _, _ = _counted(torch, device, signatures, totals)
        require(tuple(U.shape) == (MIX4_K, n, RANK) and bool(torch.isfinite(U).all()),
                f"{family}: signatures {tuple(U.shape)}")
        again = signatures()
        require(torch.equal(U, again), f"{family}: two signature calls with one seed differ")
        clu, t_one, _, routes = _counted(torch, device, lambda: one_shot_clustering(
            payloads, pcfg, seed=SEED, context=ctx, device=device), totals)
        require(routes[EQ2] >= 1, f"{family}: one-shot clustering launched no eq2 kernel")
        res, t_run, _, routes_run = _counted(torch, device, lambda: run_federation(
            "pacfl", clients, model, cfg, seed=SEED, eval_every=FAMILY_ROUNDS, device=device),
            totals)
        strat = res.strategy_obj
        run_eq2[family] = routes_run[EQ2]
        require(bool(np.isfinite(res.final_accs).all()), f"{family}: non-finite accuracy")
        require(routes_run[EQ2] >= 1, f"{family}: the federation launched no eq2 kernel")
        require(tuple(strat.clustering.U.shape) == (MIX4_K, n, RANK),
                f"{family}: the federation's signatures {tuple(strat.clustering.U.shape)}")
        out["signature_s"][family] = t_sig
        log("families", f"{family} on mix4 ({MIX4_K} clients, LeNet-5 {model.in_hw}x{model.in_ch}, "
            f"{n_params} parameters): one-shot signatures ({MIX4_K}, {n}, {RANK}) in {t_sig:.3f} s "
            f"(host clock after a sync; again with one seed: bitwise equal); one-shot clustering "
            f"{t_one:.3f} s, {clu.n_clusters} clusters, proximity launches by route "
            f"{dict(routes)}; run_federation {FAMILY_ROUNDS} rounds {t_run:.2f} s, "
            f"{strat.clustering.n_clusters} clusters, final mean accuracy {res.final_mean:.4f}, "
            f"proximity launches by route {dict(routes_run)}; pair agreement with the svd "
            f"family's partition {rand_index(strat.labels, svd_labels):.3f}")

        # -- the card against the CPU, from one set of draws made on the CPU --
        hp = module._params(pcfg)
        segments = hp.get("segments", 1)
        sub = payloads[:FAMILY_CHECK_K]
        theta0 = model.init_params(SEED, cpu)
        idx = warmup_indices(torch.as_tensor([len(p.y_train) for p in sub]), segments=segments,
                             steps=hp["steps"], batch_size=hp["batch_size"], seed=SEED)
        proj = (weight_delta.sketch_projection(n_params, hp["sketch_dim"], SEED, cpu)
                if family == "weight_delta" else None)

        def on(dev, theta):
            fctx = FamilyContext(model=model, probe=ctx.probe, indices=idx.to(dev),
                                 theta0={k: v.to(dev) for k, v in theta.items()},
                                 projection=None if proj is None else proj.to(dev))
            return compute_signatures(sub, pcfg, context=fctx, device=dev)

        U_card, U_cpu = on(device, theta0), on(cpu, theta0)
        ulp = {k: torch.where(v != 0, torch.nextafter(v, torch.full_like(v, float("inf"))), v)
               for k, v in theta0.items()}
        U_ulp = on(device, ulp)
        angles = client_angles_deg(torch, U_card, U_cpu)
        floor = client_angles_deg(torch, U_card, U_ulp)
        med, top = statistics.median(angles), max(angles)
        out["angle_deg"][family] = {"median": med, "max": top}
        out["floor_deg"][family] = {"median": statistics.median(floor), "max": max(floor)}
        log("families", f"{family} card against CPU, first {FAMILY_CHECK_K} clients from one set "
            f"of CPU draws: shapes {tuple(U_card.shape)} / {tuple(U_cpu.shape)}; each client's "
            f"largest principal angle, median {med:.3e} deg (limit {FAMILY_ANGLE_MEDIAN_TOL_DEG}), "
            f"max {top:.3e} deg (limit {FAMILY_ANGLE_MAX_TOL_DEG}), all "
            f"{[float(f'{a:.2e}') for a in angles]}; floor, theta_0 moved one ulp on the card: "
            f"median {statistics.median(floor):.3e}, max {max(floor):.3e} deg")
        require(U_card.shape == U_cpu.shape and med <= FAMILY_ANGLE_MEDIAN_TOL_DEG
                and top <= FAMILY_ANGLE_MAX_TOL_DEG,
                f"{family}: card and CPU signatures apart by median {med}, max {top} deg")
        if family == "weight_delta":
            def trajectory(dev):
                """The sketched deltas after each segment, (K, sketch, segments)."""
                from repro_torch._device import float32_math
                from repro_torch.core.signatures.warmup import flatten_params, warmup_segments

                with float32_math():
                    theta = {k: v.to(dev) for k, v in theta0.items()}
                    flat0 = flatten_params({k: v[None] for k, v in theta.items()})
                    cols = [(flatten_params(params) - flat0) @ proj.to(dev)
                            for _, params in warmup_segments(
                                sub, model=model, theta0=theta, indices=idx.to(dev),
                                steps=hp["steps"], batch_size=hp["batch_size"], lr=hp["lr"],
                                momentum=hp["momentum"], device=dev)]
                return torch.stack(cols, dim=-1).cpu()

            D_card, D_cpu = trajectory(device), trajectory(cpu)
            rel = ((D_card - D_cpu).norm(dim=1) / D_cpu.norm(dim=1)).median(dim=0).values
            sv = torch.linalg.svdvals(D_cpu).median(dim=0).values
            log("families", f"weight_delta sketched deltas, card against CPU, median over the "
                f"clients of the relative difference after each segment: "
                f"{[float(f'{r:.2e}') for r in rel.tolist()]} (first segment's limit "
                f"{FAMILY_SEGMENT_RTOL}); median singular values "
                f"{[float(f'{v:.3g}') for v in sv.tolist()]}")
            require(rel[0].item() <= FAMILY_SEGMENT_RTOL,
                    f"weight_delta: the first segment's deltas differ by {rel[0].item()}")
        # the same float32 signatures clustered on the card and on the CPU
        for measure in ("eq2", "eq3"):
            mcfg = dataclasses.replace(pcfg, measure=measure)
            clu_card = cluster_clients(U_card, mcfg, device=device)
            lab_card, A = clu_card.labels, clu_card.A
            lab_same = cluster_clients(U_card.cpu(), mcfg, device=cpu).labels
            lab_own = cluster_clients(U_cpu, mcfg, device=cpu).labels
            off = A[~np.eye(A.shape[0], dtype=bool)]
            held = measure in FAMILY_LABEL_MEASURES[family]
            log("families", f"{family} {measure} beta_quantile labels of the card's signatures "
                f"(distances {off.min():.3g}-{off.max():.3g} deg), on the card and on the CPU: "
                f"bitwise equal {np.array_equal(lab_card, lab_same)} ({'required' if held else 'not required'}) "
                f"{lab_card.tolist()}; from the CPU's own signatures: the same partition "
                f"{same_partition(lab_own, lab_card)}, pair agreement "
                f"{rand_index(lab_own, lab_card):.3f} {lab_own.tolist()}")
            require(not held or np.array_equal(lab_card, lab_same),
                    f"{family} {measure}: one set of signatures clustered differently on the "
                    f"card and the CPU")

    # -- churn for weight_delta: 8 fmnists join, 4 leave ------------------------
    cfg = family_cfg("weight_delta", FAMILY_CHURN_ROUNDS)
    res, t_run, _, routes = _counted(torch, device, lambda: run_federation(
        "pacfl", clients, model, cfg, seed=SEED, eval_every=FAMILY_CHURN_ROUNDS,
        churn=[ChurnEvent(rnd=2, join=fl["newcomers"], leave=list(CHURN_LEAVES))],
        device=device), totals)
    s_ = res.strategy_obj
    K_after = MIX4_K - len(CHURN_LEAVES) + CHURN_JOINS
    log("families", f"weight_delta churn: {CHURN_JOINS} fmnists joined (eager signature_one at "
        f"enqueue), {len(CHURN_LEAVES)} left, {FAMILY_CHURN_ROUNDS} rounds in {t_run:.2f} s; "
        f"K = {len(res.final_accs)}, newcomer labels {[int(x) for x in s_.labels[-CHURN_JOINS:]]}; "
        f"eq2 launches {routes[EQ2]} (the 10-round run without churn: {run_eq2['weight_delta']}; "
        f"the admission's {MIX4_K - len(CHURN_LEAVES)}x{CHURN_JOINS} cross block and "
        f"{CHURN_JOINS}x{CHURN_JOINS} square at n = 256)")
    require(len(res.final_accs) == K_after and bool(np.isfinite(res.final_accs).all()),
            "weight_delta churn: wrong client count or non-finite accuracy")
    require(tuple(s_.clustering.engine.U.shape) == (K_after, 256, RANK),
            f"weight_delta churn: engine signatures {tuple(s_.clustering.engine.U.shape)}")
    require(routes[EQ2] >= run_eq2["weight_delta"] + 2,
            "weight_delta churn: the admission launched no eq2 kernel")

    # -- drift: phase 4's engine after a fused move, on the card and the CPU ----
    engine = main["engine"]
    engine_cpu = engine.copy()
    engine_cpu.device, engine_cpu.U = cpu, engine.U.cpu()
    movers = engine.ids[:DRIFT_MOVERS].copy()
    fed = Federation(torch, device, seed=SEED + 21)
    U_mv = fed.signatures([(c + 5) % N_CLUSTERS for c in range(DRIFT_MOVERS)])
    _, t_move, launches, _ = _counted(torch, device, lambda: engine.move(movers, U_mv), totals)
    engine_cpu.move(movers, U_mv.cpu())
    rep, rep_cpu = DriftTracker().observe(engine), DriftTracker().observe(engine_cpu)
    spread = max(max(abs(a.mean_intra_deg - b.mean_intra_deg), abs(a.max_intra_deg - b.max_intra_deg))
                 for a, b in zip(rep.clusters, rep_cpu.clusters))
    same = (np.array_equal(engine.labels, engine_cpu.labels)
            and [(c.label, c.size) for c in rep.clusters] == [(c.label, c.size) for c in rep_cpu.clusters]
            and rep.split_candidates == rep_cpu.split_candidates
            and [m[:2] for m in rep.merge_candidates] == [m[:2] for m in rep_cpu.merge_candidates])
    log("families", f"drift: move of {DRIFT_MOVERS} clients on phase 4's engine ({engine.n_clients} "
        f"clients) {t_move * 1e3:.1f} ms, {launches['proximity']} proximity launches; "
        f"DriftTracker.observe: {len(rep.clusters)} clusters, splits {rep.split_candidates}, "
        f"{len(rep.merge_candidates)} merge candidates; against the CPU: labels, sizes and "
        f"candidates equal {same}, dispersions within {spread:.2e} deg (limit {PROX_TOL_DEG})")
    require(launches["proximity"] > 0, "drift: the move launched no proximity kernel")
    require(same and spread <= PROX_TOL_DEG, "drift: the card's report differs from the CPU's")

    # -- Table-6 distances at d = 256 -------------------------------------------
    a, b = (make_dataset(name, n_train=SIM_SAMPLES, n_test=8, dim=SIM_DIM).x_train
            for name in ("cifar10s", "svhns"))
    for fn in (similarity.bhattacharyya_gaussian, similarity.kl_gaussian, similarity.mmd_rbf):
        got = float(fn(torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)))
        want = float(fn(torch.as_tensor(a), torch.as_tensor(b)))
        rel = abs(got - want) / max(abs(want), 1e-30)
        log("families", f"{fn.__name__} cifar10s vs svhns, {SIM_SAMPLES} samples at d = {SIM_DIM}: "
            f"card {got:.6g}, CPU {want:.6g}, relative difference {rel:.2e} (limit {SIM_RTOL})")
        require(np.isfinite(got) and rel <= SIM_RTOL, f"{fn.__name__}: card {got} vs CPU {want}")

    elapsed = time.perf_counter() - t_phase
    log("families", f"phase 9 took {elapsed:.1f} s (budget {FAMILY_BUDGET_S:.0f} s); launches "
        f"summed over its counted runs {dict(totals['launches'])}, by route {dict(totals['routes'])}")
    require(elapsed <= FAMILY_BUDGET_S, f"phase 9 took {elapsed:.1f} s")
    out["launches"] = dict(totals["launches"])
    out["routes"] = dict(totals["routes"])
    return out


def phase_lm_serving(torch, device) -> dict:
    """Phase 6: each architecture served at full width in bfloat16; the
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
    """Phase 7: the full-width model in float32 through the kernels on the
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


def prox_bound(K: int, n: int, p: int, measure: str) -> tuple[float, str]:
    """The least time of a proximity square: it is symmetric, so K (K + 1) / 2
    client pairs, each p (eq3: the Gram diagonal) or p * p (eq2) dot
    products of length n at 2 flops a term (the O(K^2) epilogue is not
    counted), on the FP64 tensor cores' 67 TFLOP/s; or the stack read and
    the matrix written once."""
    gram = p if measure == "eq3" else p * p
    return bound(K * n * p * 4 + K * K * 4, 2.0 * K * (K + 1) / 2 * n * gram)


def cross_bound(Ka: int, Kb: int, n: int, p: int, q: int, measure: str) -> tuple[float, str]:
    """The least time of a proximity cross block: Ka x Kb pairs, each p
    (eq3) or p * q (eq2) dot products of length n at 2 flops a term, on the
    FP64 tensor cores; or both stacks read and the block written once."""
    gram = p if measure == "eq3" else p * q
    return bound((Ka * p + Kb * q) * n * 4 + Ka * Kb * 4, 2.0 * Ka * Kb * n * gram)


def wkv_decode_bound(B: int, H: int, hd: int, rkv_bytes: int) -> tuple[float, str]:
    """The least time of one WKV decode step: r, k, v read once, w and out
    (float32) and u once, the state read and written once; 5 flops a state
    entry (see lm_kernel_timings)."""
    n1 = B * H * hd
    return bound(rkv_bytes * 3.0 * n1 + 4.0 * (2 * n1 + H * hd + 2 * B * H * hd * hd),
                 5.0 * n1 * hd)


def phase_timings(torch, fed, launches, errs) -> list:
    from repro_torch.core.angles import _hygiene
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    K, n, p = N_CLIENTS, N_FEATURES, RANK
    U = fed.signatures(planted(K))
    U97 = fed.signatures(planted(MIX4_K))
    rows = []
    t = {}
    for label, X, measure in ((f"eq3 K={K}", U, "eq3"), (f"eq2 K={K}", U, "eq2"),
                              (f"eq2 K={MIX4_K} (mix4)", U97, "eq2")):
        ms = time_ms(torch, lambda: proximity_cuda(X, X, measure))
        plain_ms = time_ms(torch, lambda: proximity_plain(X, X, measure), iters=5)
        b_ms, b_by = prox_bound(X.shape[0], n, p, measure)
        t[label] = (ms, plain_ms, b_ms, b_by)
        log("time", f"proximity {label} n={n} p={p}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
    # eq3 at label20's K = 100 (10 triangle tiles on 132 SMs)
    U100 = fed.signatures(planted(100))
    ms = time_ms(torch, lambda: proximity_cuda(U100, U100, "eq3"))
    plain_ms = time_ms(torch, lambda: proximity_plain(U100, U100, "eq3"), iters=5)
    t["eq3 K=100"] = (ms, plain_ms) + prox_bound(100, n, p, "eq3")
    log("time", f"proximity eq3 K=100 (label20) n={n} p={p}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {t['eq3 K=100'][2]:.4f} ms ({t['eq3 K=100'][3]}), "
        f"{t['eq3 K=100'][2] / ms:.1%} of the bound")
    del U100
    # the any-rank route (p or q > 8): phase 4b's p = 16, p = 12, and the
    # cross block at p = 3 x q = 12
    U16 = Federation(torch, fed.device, p=ANY_RANK_P, seed=SEED + 5).signatures(planted(K))
    U12 = Federation(torch, fed.device, p=12, seed=SEED + 4).signatures(planted(K))
    for key, Ua, Ub, measure in (("any-rank eq3", U16, U16, "eq3"), ("any-rank eq2", U16, U16, "eq2"),
                                 ("any-rank eq3 p=12", U12, U12, "eq3"),
                                 ("any-rank eq2 p=12", U12, U12, "eq2"),
                                 ("any-rank eq2 cross", U, U12[:256], "eq2")):
        Ka, _, pa = Ua.shape
        Kb, _, qb = Ub.shape
        got, want = proximity_cuda(Ua, Ub, measure), proximity_plain(Ua, Ub, measure)
        if Ua is Ub:
            got, want = _hygiene(got), _hygiene(want)
        err = (got - want).abs().max().item()
        del got, want
        ms = time_ms(torch, lambda: proximity_cuda(Ua, Ub, measure), warmup=2, iters=10)
        plain_ms = time_ms(torch, lambda: proximity_plain(Ua, Ub, measure), warmup=1, iters=3)
        b_ms, b_by = (prox_bound(Ka, n, pa, measure) if Ua is Ub
                      else cross_bound(Ka, Kb, n, pa, qb, measure))
        t[key] = (ms, plain_ms, b_ms, b_by)
        log("time", f"proximity {key} {Ka}x{Kb} n={n} p={pa} q={qb}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound; "
            f"max|kernel - plain| = {err:.3e} deg (limit {PROX_TOL_DEG})")
        require(err <= PROX_TOL_DEG, f"proximity {key}: err {err}")
        errs["proximity"].append(err)
    del U16, U12
    ms, plain_ms, b_ms, b_by = t[f"eq3 K={K}"]
    row = {
        "name": "proximity", "route": "cuda",
        "source": "src/repro_torch/csrc/proximity.cu",
        "replaces": "src/repro/kernels/proximity/proximity.py:55",
        "launches": launches.get("proximity", 0),
        "launches_by_route": launches["proximity_by_route"],
        "max_abs_err": max(errs["proximity"]), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "redesigned": REDESIGNED_IN["proximity"],
    }
    for key, label in (("eq2", f"eq2 K={K}"), ("eq2_k97", f"eq2 K={MIX4_K} (mix4)"),
                       ("eq3_k100", "eq3 K=100"),
                       ("any_rank_eq3", "any-rank eq3"), ("any_rank_eq2", "any-rank eq2"),
                       ("any_rank_p12_eq3", "any-rank eq3 p=12"),
                       ("any_rank_p12_eq2", "any-rank eq2 p=12"),
                       ("any_rank_cross_eq2", "any-rank eq2 cross")):
        ms, plain_ms, b_ms, b_by = t[label]
        row.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms, f"{key}_bound_ms": b_ms,
                    f"{key}_bound_by": b_by})
    rows.append(row)
    Uc = U.clone()
    ms = time_ms(torch, lambda: proximity_cuda(U, Uc, "eq3"))
    log("time", f"proximity eq3 K={K} against a clone (the full rectangle, no "
        f"triangle): kernel {ms:.4f} ms")
    del Uc
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
                "library_ms": lib_ms, "redesigned": REDESIGNED_IN["tsgemm"],
            })
    return rows


def lm_kernel_timings(torch, device, launches, errs) -> list:
    """Flash attention at tinyllama's prefill and decode shapes, WKV at
    rwkv6's, in the main path's types (bfloat16 attention; WKV's bfloat16
    r, k, v with float32 w, u and state)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan

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
        "redesigned": REDESIGNED_IN["flash_attention"],
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

    # WKV: prefill over the prompt, then one decode step with a carried state.
    # The least work per step and state entry (i, j): out_j += r_i S_ij (one
    # FMA) and S_ij = w_i S_ij + k_i v_j (a multiply and an FMA), 5 flops;
    # the bonus (sum_i r_i u_i k_i) v_j is per j, not per (i, j).
    H = 32
    ops = wkv_inputs(torch, gen, B, S, H, hd, device)
    bf = tuple(a.to(torch.bfloat16) if i < 3 else a for i, a in enumerate(ops))
    plan = wkv_plan(S)
    ms = time_ms(torch, lambda: wkv_cuda(*bf))
    ms_f32 = time_ms(torch, lambda: wkv_cuda(*ops))
    plain_ms = time_ms(torch, lambda: wkv_plain(*bf), warmup=1, iters=3)
    n = B * S * H * hd
    b_ms, b_by = bound(2.0 * 3 * n + 4.0 * (2 * n + H * hd + B * H * hd * hd), 5.0 * n * hd)
    log("time", f"wkv prefill r {tuple(ops[0].shape)} ({plan.route}, chunk {plan.chunk}): "
        f"kernel {ms:.4f} ms with bfloat16 r, k, v (the serving path's), {ms_f32:.4f} ms "
        f"float32; plain {plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by})")
    rows.append({
        "name": "wkv", "route": "cuda", "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv/wkv.py:53",
        "launches": launches.get("wkv", 0), "max_abs_err": max(errs["wkv"]),
        "ms": ms, "ms_f32": ms_f32, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "redesigned": REDESIGNED_IN["wkv"],
    })
    del ops, bf
    step = tuple(a.to(torch.bfloat16) if i < 3 else a
                 for i, a in enumerate(wkv_inputs(torch, gen, B, 1, H, hd, device)))
    state = randn(B, H, hd, hd)
    ms = graph_ms(torch, lambda: wkv_cuda(*step, state), reps=20)
    plain_ms = graph_ms(torch, lambda: wkv_plain(*step, state), reps=20)
    b_ms, b_by = wkv_decode_bound(B, H, hd, rkv_bytes=2)
    log("time", f"wkv decode r {tuple(step[0].shape)} bf16, state {tuple(state.shape)} f32 "
        f"(graph replay): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
    rows[-1].update(decode_ms=ms, decode_plain_ms=plain_ms, decode_bound_ms=b_ms,
                    decode_bound_by=b_by)
    return rows


def time_kernels(torch) -> dict:
    """Milliseconds of the imported ``repro_torch``'s tsgemm, bfloat16
    flash-attention, float32 WKV and proximity wrappers at phase 8's
    main-path shapes (the wrappers' calls that earlier trees also take),
    and the bounds of the proximity and WKV decode cases."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.proximity import proximity_cuda
    from repro_torch.kernels.tsgemm import tsgemm_cuda
    from repro_torch.kernels.wkv import wkv_cuda

    _build.build_all(_build.KERNELS)
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
    del q, k, v, q1, kc, vc
    H, hd = 32, 64
    ops = wkv_inputs(torch, gen, LM_BATCH, LM_PROMPT, H, hd, device)
    ms["wkv prefill f32"] = time_ms(torch, lambda: wkv_cuda(*ops))
    step = wkv_inputs(torch, gen, LM_BATCH, 1, H, hd, device)
    state = randn(LM_BATCH, H, hd, hd)
    ms["wkv decode (graph replay)"] = graph_ms(torch, lambda: wkv_cuda(*step, state), reps=20)
    step_bf16 = tuple(a.to(bf16) if i < 3 else a for i, a in enumerate(step))   # serving's r, k, v
    ms["wkv decode bf16 (graph replay)"] = graph_ms(
        torch, lambda: wkv_cuda(*step_bf16, state), reps=20)
    one = torch.zeros(1, device=device)
    ms["graph replay floor (one-element add)"] = graph_ms(torch, lambda: one.add_(1.0), reps=20)
    del ops, step, step_bf16, state
    fed = Federation(torch, device)
    bounds = {"wkv decode (graph replay)": wkv_decode_bound(LM_BATCH, H, hd, rkv_bytes=4)[0],
              "wkv decode bf16 (graph replay)": wkv_decode_bound(LM_BATCH, H, hd, rkv_bytes=2)[0]}
    for K, measures in ((N_CLIENTS, ("eq3", "eq2")), (MIX4_K, ("eq2",))):
        U = fed.signatures(planted(K))
        for measure in measures:
            key = f"proximity {measure} K={K}"
            ms[key] = time_ms(torch, lambda: proximity_cuda(U, U, measure))
            bounds[key] = prox_bound(K, N_FEATURES, RANK, measure)[0]
    U = fed.signatures(planted(100))
    ms["proximity eq3 K=100"] = time_ms(torch, lambda: proximity_cuda(U, U, "eq3"))
    bounds["proximity eq3 K=100"] = prox_bound(100, N_FEATURES, RANK, "eq3")[0]
    # the any-rank route: p = 16 and 12 squares, the 1024 x 256 block at 3 x 12
    U3 = fed.signatures(planted(N_CLIENTS))
    U16 = Federation(torch, device, p=ANY_RANK_P, seed=SEED + 5).signatures(planted(N_CLIENTS))
    U12 = Federation(torch, device, p=12, seed=SEED + 4).signatures(planted(N_CLIENTS))
    for label, Ua, Ub, measures in ((f"K={N_CLIENTS} p={ANY_RANK_P}", U16, U16, ("eq3", "eq2")),
                                    (f"K={N_CLIENTS} p=12", U12, U12, ("eq3", "eq2")),
                                    (f"cross {N_CLIENTS}x256 p=3 q=12", U3, U12[:256], ("eq2",))):
        Ka, _, p = Ua.shape
        Kb, _, q = Ub.shape
        for measure in measures:
            key = f"proximity any-rank {measure} {label}"
            ms[key] = time_ms(torch, lambda: proximity_cuda(Ua, Ub, measure), warmup=1, iters=5)
            bounds[key] = (prox_bound(Ka, N_FEATURES, p, measure) if Ua is Ub
                           else cross_bound(Ka, Kb, N_FEATURES, p, q, measure))[0]
    return {"ms": ms, "bound_ms": bounds, "build_s": dict(_build.BUILD_SECONDS)}


def time_fl(torch) -> dict:
    """Phase 5's federations through the imported ``repro_torch``'s
    ``run_federation``, each timed on the host clock after a device sync:
    mix4 PACFL 20 rounds (with its round times from the entry point's
    records and a warm round of the finished federation), label20 PACFL and
    FedAvg 20 rounds, the ten strategies 3 rounds on label20."""
    import numpy as np

    from repro_torch._device import float32_math
    from repro_torch.fl import STRATEGIES, run_federation
    from repro_torch.fl.trainer import round_generator, sample_round
    from repro_torch.kernels import _build
    from repro_torch.launch.fl_train import build_clients, fl_config
    from repro_torch.models.cnn import build_model

    _build.build_all(_build.KERNELS)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    out = {}
    clients, n_classes = build_clients("mix4", FL_CLIENTS, FL_DIM, 3000)
    model = build_model("lenet5", dim=FL_DIM, n_classes=n_classes)
    cfg = fl_config("mix4", FL_ROUNDS)
    res, out["mix4_s"] = _timed(torch, device, lambda: run_federation(
        "pacfl", clients, model, cfg, seed=SEED, eval_every=1, device=device))
    per_round = np.diff([0.0] + [r.seconds for r in res.records])
    strat = res.strategy_obj
    sampled = sample_round(np.random.default_rng(SEED), strat.data.n_clients, cfg.sample_frac)
    idx = strat.draw_indices(sampled, round_generator(SEED, FL_ROUNDS + 1, device))
    with float32_math():
        warm = [_timed(torch, device, lambda: strat.run_round(FL_ROUNDS + 1, sampled, idx))[1]
                for _ in range(5)]
    out.update(mix4_first_round_s=float(per_round[0]),
               mix4_round_median_ms=float(statistics.median(per_round[1:])) * 1e3,
               mix4_warm_round_ms=statistics.median(warm) * 1e3, mix4_accuracy=res.final_mean)
    clients20, n20 = build_clients("label20", FL_CLIENTS, FL_DIM, 3000)
    model20 = build_model("lenet5", dim=FL_DIM, n_classes=n20)
    for name in ("pacfl", "fedavg"):
        res, out[f"label20_{name}_s"] = _timed(torch, device, lambda: run_federation(
            name, clients20, model20, fl_config("label20", FL_ROUNDS), seed=SEED,
            eval_every=FL_ROUNDS, device=device))
    _, out["strategies_s"] = _timed(torch, device, lambda: [run_federation(
        name, clients20, model20, fl_config("label20", FL_STRATEGY_ROUNDS), seed=SEED,
        eval_every=FL_STRATEGY_ROUNDS, device=device) for name in sorted(STRATEGIES)])
    out["total_s"] = time.perf_counter() - t0
    return out


def sweep_eq2(torch) -> dict:
    """The measurements behind ``eq2_plan``'s one-wave split: eq2 at mix4's
    K = 97 (n = 3072, p = 3) planned as if the card had 33 to 528 SMs (the
    plan's only input besides the shapes, set through ``_build.sm_count``),
    each with its split count, time and device time by kernel
    (torch.profiler), and the same split by kernel at K = 1024 and at the
    churn admission's blocks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cuda
    from repro_torch.kernels.proximity.proximity import eq2_plan

    _build.build_all(("proximity",))
    device = torch.device("cuda")
    fed = Federation(torch, device)
    U97 = fed.signatures(planted(MIX4_K))
    joins = fed.signatures(planted(CHURN_JOINS))
    out = {}
    cases = ((f"K={MIX4_K}", U97, U97), (f"K={N_CLIENTS}", fed.signatures(planted(N_CLIENTS)), None),
             (f"cross {MIX4_K - len(CHURN_LEAVES)}x{CHURN_JOINS}", U97[:MIX4_K - len(CHURN_LEAVES)],
              joins), (f"square K={CHURN_JOINS}", joins, joins))
    for label, Ua, Ub in cases:
        Ub = Ua if Ub is None else Ub
        out[label] = {"ms": time_ms(torch, lambda: proximity_cuda(Ua, Ub, "eq2")),
                      "kernels_ms": profile_ms(torch, lambda: proximity_cuda(Ua, Ub, "eq2"))}
    sm_count = _build.sm_count
    try:
        for sms in (33, 66, 132, 264, 528):
            _build.sm_count = lambda index, _sms=sms: _sms
            plan = eq2_plan(MIX4_K, MIX4_K, N_FEATURES, RANK, RANK, True, sms)
            out[f"K={MIX4_K} as if {sms} SMs"] = {
                "splits": plan.splits, "split_rows": plan.split_rows,
                "ms": time_ms(torch, lambda: proximity_cuda(U97, U97, "eq2")),
                "kernels_ms": profile_ms(torch, lambda: proximity_cuda(U97, U97, "eq2"))}
    finally:
        _build.sm_count = sm_count
    return out


def sweep_any_rank(torch) -> dict:
    """The measurements behind the any-rank eq2 plan: eq2 at K = 1024, n =
    3072, p = 16 with each Gram piece shape (``eq2_chunks``), each job count
    of the reduce (``reduce_jobs``) and two workspace caps, each with its
    device time by kernel (torch.profiler).  The plan is set through the
    module's functions."""
    import functools
    import importlib

    from repro_torch.kernels import _build

    plan = importlib.import_module("repro_torch.kernels.proximity.proximity")
    chunks, jobs, eq2_plan = plan.eq2_chunks, plan.reduce_jobs, plan.eq2_plan
    _build.build_all(("proximity",))
    device = torch.device("cuda")
    U = Federation(torch, device, p=ANY_RANK_P, seed=SEED + 5).signatures(planted(N_CLIENTS))
    out = {}

    def run(label):
        out[label] = {"ms": time_ms(torch, lambda: plan.proximity_cuda(U, U, "eq2"),
                                    warmup=1, iters=5),
                      "kernels_ms": profile_ms(torch, lambda: plan.proximity_cuda(U, U, "eq2"),
                                               iters=2)}
    try:
        for shape in ((3, 4), (4, 4), (4, 3), (2, 6), (2, 4), (1, 8), (8, 8)):
            plan.eq2_chunks = lambda p, q, _s=shape: _s
            run(f"pieces {shape[0]}x{shape[1]}")
        plan.eq2_chunks = chunks
        for j in (32, 16):
            plan.reduce_jobs = lambda p, q, sym, _j=j: _j
            run(f"reduce jobs {j}")
        plan.reduce_jobs = jobs
        for cap in (128 << 20, 2 << 30):
            plan.eq2_plan = functools.partial(eq2_plan, workspace_bytes=cap)
            run(f"workspace cap {cap >> 20} MiB")
    finally:
        plan.eq2_chunks, plan.reduce_jobs, plan.eq2_plan = chunks, jobs, eq2_plan
    return out


def sweep_wkv(torch) -> dict:
    """The measurements behind ``wkv_plan``'s constants, float32 at
    rwkv6-1.6b's (4, S, 32, 64) with the model's decays: the prefill at
    S = 1024 by chunk length, both routes at short S, and the device time of
    each of the chunked route's kernels at S = 1024 (torch.profiler).  The
    route and chunk length are set through the plan's module constants."""
    import importlib

    from repro_torch.kernels import _build

    plan = importlib.import_module("repro_torch.kernels.wkv.wkv")
    chunk, min_s = plan.CHUNK, plan.CHUNKED_MIN_S
    _build.build_all(("wkv",))
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    H, hd = 32, 64
    ops = wkv_inputs(torch, gen, LM_BATCH, LM_PROMPT, H, hd, device)
    ms = {"kernels at S=1024": profile_ms(torch, lambda: plan.wkv_cuda(*ops))}
    try:
        for c in (32, 64, 128, 256):
            plan.CHUNK = c
            ms[f"S=1024 chunk {c}"] = time_ms(torch, lambda: plan.wkv_cuda(*ops))
        plan.CHUNK = chunk
        for S in (16, 32, 48, 64, 128):
            short = wkv_inputs(torch, gen, LM_BATCH, S, H, hd, device)
            for route, threshold in (("recurrent", S + 1), ("chunked", 1)):
                plan.CHUNKED_MIN_S = threshold
                ms[f"S={S} {route}"] = time_ms(torch, lambda: plan.wkv_cuda(*short))
    finally:
        plan.CHUNK, plan.CHUNKED_MIN_S = chunk, min_s
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--time-kernels", metavar="SRC",
                    help="only time the kernels of SRC/repro_torch at the main-path shapes")
    ap.add_argument("--time-fl", metavar="SRC",
                    help="only time phase 5's federations through SRC/repro_torch")
    ap.add_argument("--sweep-wkv", action="store_true",
                    help="only time WKV by chunk length and route (wkv_plan's constants)")
    ap.add_argument("--sweep-eq2", action="store_true",
                    help="only time eq2 by split count at K = 97 (eq2_plan's one wave)")
    ap.add_argument("--sweep-any-rank", action="store_true",
                    help="only time eq2 at p = 16 by Gram piece, reduce jobs and workspace cap")
    args = ap.parse_args(argv)
    tree = args.time_kernels or args.time_fl
    src = Path(tree).resolve() if tree else ROOT / "src"
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
                          **time_kernels(torch)}))
        return 0
    if args.time_fl:
        print(json.dumps({"src": args.time_fl, "device": device["smi"], "fl": time_fl(torch)}))
        return 0
    if args.sweep_wkv:
        print(json.dumps({"device": device["smi"], "ms": sweep_wkv(torch)}))
        return 0
    if args.sweep_eq2:
        print(json.dumps({"device": device["smi"], "eq2": sweep_eq2(torch)}))
        return 0
    if args.sweep_any_rank:
        print(json.dumps({"device": device["smi"], "any_rank_eq2": sweep_any_rank(torch)}))
        return 0
    phase_build()
    fed = Federation(torch, torch.device("cuda"))
    errs = {"proximity": [], "tsgemm": [], "wkv": [],
            "flash_attention": {torch.float32: [], torch.bfloat16: []}}
    check_proximity(torch, fed, errs["proximity"])
    check_tsgemm(torch, fed.device, errs["tsgemm"])
    check_flash(torch, fed.device, errs["flash_attention"])
    check_wkv(torch, fed.device, errs["wkv"])
    main_path = phase_main_path(torch, fed)
    any_rank = phase_any_rank(torch, fed.device)
    fl = phase_fl(torch, fed.device, main_path)
    families = phase_families(torch, fed.device, main_path, fl)
    # the PACFL (p = 3 and p = 16), FL and family paths' launches, each
    # counted from 0 over its run
    paths = (main_path, any_rank, fl, families)
    launches = dict(sum((collections.Counter(x["launches"]) for x in paths), collections.Counter()))
    routes = sum((collections.Counter(x["routes"]) for x in paths), collections.Counter())
    launches["proximity_by_route"] = {m: routes[("proximity", m)] for m in
                                      ("eq3", "eq2", "eq3_any_rank", "eq2_any_rank")}
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
