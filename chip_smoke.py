#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card, its power limit, the float32 matmul settings;
2. build: compiles the port's CUDA kernel sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel; the four TPU kernels' and the
   flash-attention and WKV backwards') into ``build/kernels/``, printing
   each source's ``nvcc`` time, the count of tensor-core instructions in
   the SASS of the bfloat16 flash-attention kernels (``HMMA``; the
   backward's at every head dim, with its registers and stack, none
   allowed) and of the
   eq3 and eq2 proximity kernels (``DMMA``; also of each instantiation the
   p = 16 routes of phase 4b launch, with its registers and stack), and
   the registers and stack of the main paths' eq2, the any-rank eq2 reduce
   (``eq2_form_any``, ``eq2_jacobi_any``), WKV decode and the WKV
   backward's kernels (no stack allowed; its two tensor-core kernels
   ``wkv_bwd_chunk_tc`` and ``wkv_bwd_grad_tc`` also with ``HMMA``
   instructions, at hd 64 and 128 with bfloat16 and float32 r, k, v);
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
   the flash-attention backward (dq, dk, dv, and the forward's log-sum-exp)
   at every form phase 10 trains (``trained_flash_calls``) and the zoo's
   training forms besides, bfloat16 and float32, each launched twice and
   required bitwise equal; the WKV backward (dr, dk, dv, dw, du, dstate0
   from the forward's chunk-start states) at rwkv6's training shape with
   slow and fast decays, with and without state0 and dstateT, float32 and
   bfloat16 r, k, v, S = 1, 47 and 1111, hd 16, 32 and 128, and on a
   rank's 16 and 8 of rwkv6's 32 heads, each launched twice and required
   bitwise equal (``WKV_BWD_FORMS``); the WKV forward on a rank's heads too;
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
4c. the ``"sharded"`` proximity backend (at most 60 s): at K = 16384 (n =
   3072, p = 3) the square and a 16384 x 64 cross block, and the any-rank
   route's square at K = 2048, p = 16, each under eq3 and eq2 through
   ``backend="sharded"`` (row strips over every local card, the count
   printed) and through the strip function over the card listed four
   times, each against the ``"kernel"`` backend: eq3 bitwise, eq2 bitwise
   where the kernel's and every strip's ``eq2_plan`` take one split of n
   (the plans printed), else within 1e-3 degrees; CUDA-event times of
   each; and phase 4's one-shot clustering again through ``"sharded"``,
   its labels required equal to phase 4's;
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
6b. sharded serving (after phase 6): tensor- and expert-parallel ranks in
   fresh processes (``launch.mesh.run_ranks``, gloo) sharing the card, one
   spawn a mesh, each rank drawing its shard with ``init_params_sharded``
   and loading phase 2's flash build (never nvcc), each run against the
   unsharded model alone on the card: llama4-scout at full width over 1x4
   in float32 (2 layers, the experts whole on their rank) and bfloat16 (8
   layers), qwen2-moe over 1x4 in float32 (2 layers, the experts' F over
   the ranks) and bfloat16 (full depth), tinyllama over 1x2 in float32 and
   bfloat16 (full depth): float32 logits within 1e-4 of max|logit| and
   every token equal; bfloat16 logits within 2e-2 of max|logit| or the
   unsharded model's one-ulp weight floor, each row's first token equal or
   a tie within the measured difference, the first divergence printed;
   zamba2 (one super-block and the shared block), rwkv6 (2 layers), gemma3
   (6 layers, a prompt past its window: the rings roll and wrap) and
   whisper (2 + 2 layers, 1500 frames) over 1x2 in float32 at full width,
   as the float32 runs above; every rank's flash and WKV launches the
   unsharded count and its flash forms checked in phase 3; with four cards
   the float32 llama4 run over NCCL, a card a rank, and llama4-scout at
   full depth; else one line saying so;
7. whole model in float32 at full width: last-position logits of a prefill
   and 8 teacher-forced decode steps through the kernels on the card against
   the plain twins (the same model on the CPU);
8. timings: each kernel's median time at its main-path shape beside its
   bound at the card's peak rates, its plain twin and the library call
   (flash attention also at llama3.2-3b's heads; tsgemm also at Q^T @ D and
   the M = 1024 bucket; proximity eq2 also at mix4's K = 97, eq3 at
   label20's K = 100, and the any-rank route, eq3 and eq2, at K = 1024, p =
   16 and 12 and the 1024 x 256 cross block at p = 3 x q = 12; WKV decode
   replayed from a CUDA graph, and prefill also with float32 r, k, v; the
   flash-attention backward at tinyllama's and gemma3's training shapes
   beside SDPA's backward; the flash forward and backward at a rank's
   bfloat16 training shapes of granite-8b over four cards (8 / 2 heads at
   1x4, 16 / 4 at 2x2, hd 128), of zamba2-7b's shared block (8 / 8 at 1x4,
   hd 112) and of gemma3-4b's local and global layers (2 / 1 at 1x4, hd
   256) beside SDPA's; the same at model index 0's heads of a model axis
   of 16 under the shared-KV split (llama3.2-3b 2 / 1, hd 128; gemma3-4b's
   local and global layers 1 / 1, hd 256), each with phase 10f's rank-0
   launches; WKV prefill, decode and backward on a rank's 8 of
   rwkv6's 32 heads; the WKV backward at rwkv6's training shape
   beside its twin, its bound at the rates its kernels run on and the
   stepwise kernel's bound, and each of its four kernels' device time a
   call from torch.profiler, every launch recorded);
9. model-based signature families (run after phase 5, at most 150 s):
   ``weight_delta`` (sketch n = 256) and ``inference`` (probe n = 192) on
   phase 5's mix4 clients with LeNet-5 at 32x32x3, the experiment suite's
   settings (``beta_quantile`` 0.1, eq2): per family the one-shot
   signatures (timed, and twice bitwise equal), ``one_shot_clustering``
   and a 10-round ``run_federation``, each through eq2; the first 16
   clients on the card against the CPU from one set of CPU draws; a
   3-round ``weight_delta`` run with phase 5's churn event; a
   ``DriftTracker`` observation of phase 4's engine after a fused ``move``,
   and the Table-6 distances (BD, KL, MMD) at d = 256, each against the CPU;
10. LM training (run after phase 7): (a) tinyllama-1.1b at full width and
   depth, float32 masters, bfloat16 compute, AdamW, remat, batch 4 x 2048:
   10 ``make_train_step`` steps on one repeated batch (finite losses, at
   least 0.5 nat lower at the last step than at the first, exactly 44
   flash forward and 22 backward launches a step; step time, peak memory,
   device idle share), two fresh same-seed steps run twice (the losses
   and parameters bitwise equal), then 5 steps of ``repro_torch.launch.train.main``
   with a fresh batch each step; (b) whole-model float32 gradients at full
   width, depth cut, card (kernels) against CPU (twins) for tinyllama,
   gemma3, qwen2-moe, zamba2, whisper, internvl2 and rwkv6 (beside it the
   CPU's own gradients after every weight moves by one float32 ulp); (c)
   rwkv6-1.6b at full width and depth as (a): 10 steps on one batch (loss
   down >= 0.5 nat, exactly 48 WKV forward and 24 backward launches a step,
   no flash), then 5 launcher steps.  Each training run prints its warm
   step time, tok/s, model-FLOP utilisation (``launch.roofline``), device
   idle share, largest kernels and peak memory; (d) sharded training (at
   most 180 s): one ``run_ranks`` spawn of a 2x2 mesh over gloo, the four
   ranks sharing the card, trains granite-8b under ``fsdp_tp`` and
   qwen2-moe-a2.7b under ``tp_only`` at full width with 2 layers, float32,
   batch 4 x 512, and zamba2-7b under ``fsdp_tp`` (one super-block and the
   shared block) at batch 2 x 256, then on two of the ranks over 1x2
   ``tp_only`` rwkv6 (2 layers), gemma3 (2 local layers) and whisper (2 + 2
   layers) at batch 2 x 256, one ``make_train_step`` each, against the
   unsharded step
   computed alone first: the loss, every gradient leaf put together from
   the pieces, each parameter after the step and its v inside the window
   that AdamW's first step allows the gradient's limit, every piece two
   ranks hold bit-equal, each rank's flash launches ``lm.train_step_launches`` and
   its flash forms checked in phase 3 (``sharded_train_flash_calls``);
   zamba2's ranks then save their state after the step
   (``ckpt.save_sharded``, the reference's checkpoint format, rank 0
   writing: FSDP pieces, pieces replicated over the data axis, Mamba2's
   B and C columns, the shared block) and restore the file into fresh
   models (``ckpt.restore_sharded``, each rank its slices): every
   parameter, moment and step a rank restores is bit-equal to the one it
   saved, so the file is the ranks' pieces put together (save and
   restore seconds, bytes, peak RSS growth printed); then one line saying
   that the four-card trainings (granite-8b, zamba2-7b, gemma3-4b) did not
   run; (f) KV heads shared by a group of ranks (its spawn at most 120 s):
   one ``run_ranks`` spawn of 16 ranks sharing the card over gloo, loading
   phase 2's builds, a model axis of 16 as at the reference's production
   meshes, float32 at full width with the depth cut, each run against the
   unsharded model alone first: llama3.2-3b over 1x16 ``tp_only`` (query
   heads 2 / 1 a rank, KV heads shared by pairs) served as phase 6b serves
   and trained one step as 10d trains, gemma3-4b over 1x16 served (one 5
   local + 1 global super-block, prompt 1040; 1 / 1 / 0 / 0 query heads in
   each group of four: ranks with no query head), tinyllama-1.1b over 2x8
   ``fsdp_tp`` trained one step (4 x 512); held to 6b's and 10d's limits,
   each rank's flash launches its own heads' count (none where it holds no
   query head), every piece two ranks hold (the KV replicas included)
   bit-equal after the step.

Launch counts are set to 0 just before each main path (phase 4, each
measure of 4b, phase 4c's sharded calls, each federation and each server call of phase 5, each
architecture of 6, each family call, federation and the move of 9, each
training step of 10a and 10c, each rank's step of 10d and 10f) and read just
after; launches that only check a result (phase 5's ``admit_oracle``
and its newcomers' signatures, phase 9's repeats and card-against-CPU work)
fall outside every window. The kernels line sums phases 4, 4b, 5 and 9's
windows and splits the proximity launches by route (eq3, eq2 and, above
rank 8, eq3_any_rank, eq2_any_rank); phase 4c's window stands apart, on
its own line and under the proximity row's ``sharded`` key, with its
times. The second-to-last line is the
``{"kernels": [...]}`` record, the last ``{"ok": true, "device": {...}}``.
Nothing of the JAX package is imported.

    python3 chip_smoke.py --time-kernels SRC

builds the kernels of the ``repro_torch`` under the directory SRC,
times tsgemm, flash attention (and its backward at phase 8's three
training shapes), WKV (prefill and decode, and its backward at rwkv6's
training shape where SRC has it) and proximity (eq3
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

    python3 chip_smoke.py --sharded-4card

runs only phase 6b's four-card runs over NCCL and the training of
granite-8b and zamba2-7b at full width and depth over 1x4 ``tp_only`` and
2x2 ``fsdp_tp`` and of gemma3-4b over 1x4 ``tp_only`` (10 steps on one
batch: the loss down 0.5 nat, the ranks' losses equal, step time, tok/s,
model-FLOP utilisation beside the parameters ``param_count`` gives and the
model holds, each card's peak beside ``launch/dryrun.py``'s forecast), with
the kernel builds and the phase-3 checks they need, on a machine with four
cards.  granite-8b's 2x2 run saves its state after step 5 (~99 GB; it stops
first, naming the bytes, where the disk lacks them), restores it after
step 10 into fresh models (the file removed once every rank has read it)
and takes steps 6-10 again: their losses must be the uninterrupted run's,
bit for bit.

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
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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

# LM serving (phase 6): each configuration that fits one card at full width,
# (arch, prompt, the kernel whose launches are counted): tinyllama-1.1b's
# attention and rwkv6-1.6b's WKV, then gemma3-4b at twice its window (the
# prefill rolls the local layers' rings and every decode step wraps them),
# qwen2-moe-a2.7b, zamba2-7b (the shared attention block after each of its
# 13 super-blocks), whisper-medium at its published 448-token decoder
# context (416 + 32) with 1500 encoder frames, and internvl2-26b with its
# 256 vision embeddings.  llama4-scout (215 GB in bfloat16) does not fit.
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 1024, 32
LM_SERVED = (
    ("tinyllama-1.1b", LM_PROMPT, "flash_attention"),
    ("rwkv6-1.6b", LM_PROMPT, "wkv"),
    ("gemma3-4b", 2048, "flash_attention"),
    ("qwen2-moe-a2.7b", LM_PROMPT, "flash_attention"),
    ("zamba2-7b", LM_PROMPT, "flash_attention"),
    ("whisper-medium", 416, "flash_attention"),
    ("internvl2-26b", LM_PROMPT, "flash_attention"),
)
# Whole-model float32 check (phase 7): the CPU side runs the plain twins at
# full width, so the prompt is shorter than phase 6's and the new families'
# depth is cut: (arch, config changes, prompt).  gemma3 keeps one 5 local +
# 1 global super-block with a prompt past its window (the ring rolls and
# wraps); zamba2 one super-block, the shared block and 1 remainder layer;
# internvl2's prompt holds its 256 vision embeddings and 128 tokens.
F32_BATCH, F32_PROMPT, F32_DECODE = 2, 128, 8
LM_F32 = (
    ("tinyllama-1.1b", {}, F32_PROMPT),
    ("rwkv6-1.6b", {}, F32_PROMPT),
    ("gemma3-4b", {"n_layers": 6}, 1040),
    ("qwen2-moe-a2.7b", {"n_layers": 2}, F32_PROMPT),
    ("zamba2-7b", {"n_layers": 7}, F32_PROMPT),
    ("whisper-medium", {"n_layers": 2, "encoder_layers": 2}, F32_PROMPT),
    ("internvl2-26b", {"n_layers": 2}, 256 + F32_PROMPT),   # 256 vision embeddings lead
)
# Limits on max|kernels - plain| / max|logits|.  Both sides are float32 and
# differ only in summation order (cuBLAS vs the CPU's BLAS, the kernel's
# online softmax and on-chip recurrence vs the dense / stepwise twins), ~1e-6
# relative per operation; a wrong mask, head mapping or state moves the
# logits by ~1e-1 of their scale.  How far the model amplifies rounding is
# measured beside each check (the "floor": the kernels' logits again after
# every weight moves by one float32 ulp).  tinyllama amplifies little;
# rwkv6 at its random init (decay ~0.9975, so the WKV state sums nearly all
# past k v^T before the per-head group norm) amplifies rounding ~700x more,
# hence its wider limit.  The limits of the families added later were fixed
# before their first run: 1e-4, and 1e-3 for zamba2, whose Mamba blocks
# carry a recurrent state through 7 layers and whose SSD and decode sum in
# other orders on the card.
LOGIT_REL_TOL = {"tinyllama-1.1b": 1e-4, "rwkv6-1.6b": 1e-2, "gemma3-4b": 1e-4,
                 "qwen2-moe-a2.7b": 1e-4, "zamba2-7b": 1e-3, "whisper-medium": 1e-4,
                 "internvl2-26b": 1e-4}

# The flash calls phase 8 and --time-kernels time (bfloat16, SDPA beside
# each, an explicit mask for the window), at their phase 6 shapes: the family
# that makes the call, label, (B, Sq, Skv, Hq, Hkv, hd), causal, window,
# q_offset, and the cache's slots when K and V are a view of its first Skv
# (whisper's cross cache, padded to 1536).  Phase 3 checks each of them
# besides every call of phase 6 (served_flash_calls).
FAMILY_FLASH = (
    ("gemma3-4b", "gemma3 prefill, local layer", (4, 2048, 2048, 8, 4, 256), True, 1024, 0, None),
    ("gemma3-4b", "gemma3 prefill, global layer", (4, 2048, 2048, 8, 4, 256), True, None, 0,
     None),
    ("gemma3-4b", "gemma3 decode, wrapped ring", (4, 1, 1024, 8, 4, 256), False, None, 0, None),
    ("zamba2-7b", "zamba2 shared attention prefill", (4, 1024, 1024, 32, 32, 112), True, None,
     0, None),
    ("zamba2-7b", "zamba2 shared attention decode", (4, 1, 1056, 32, 32, 112), True, None, 1054,
     None),
    ("whisper-medium", "whisper cross-attention decode", (4, 1, 1500, 16, 16, 64), False, None,
     0, 1536),
)

# Sharded serving (phase 6b): tensor- and expert-parallel ranks, one fresh
# process each (``launch.mesh.run_ranks``; one spawn a mesh serves all its
# runs in turn), gloo over the one card they share, each run held against
# the unsharded model on the card, run alone first: label, arch, config
# changes, dtype, mesh (data, model), scheme, batch, prompt, tokens.  Each
# sharding rule in float32 under float32_math, where only summation order
# differs: llama4-scout's experts whole on their rank, qwen2-moe's on
# slices of F (both at full width, 2 layers), tinyllama's dense blocks (G =
# 8 a rank; full depth): last-position logits within 1e-4 of max|logit|
# and every greedy token equal.  Then at the serving dtype, bfloat16:
# llama4-scout at full width (215 GB at its 48 layers) with 8 layers (~39
# GB), qwen2-moe and tinyllama at full width and depth; their prefill
# logits within 2e-2 of max|logit|, or within the floor where that is
# larger: how far the unsharded model's logits move when each of its
# weights moves by one bfloat16 ulp (an MoE's expert choices flip at
# rounding-level ties: qwen2-moe's logits differ by ~1e-1 of max|logit|
# on an H100); each row's first token equal, or a tie within the
# measured difference; the first divergence of the generated tokens
# printed.  Where there are four cards, the float32 llama4 run again over
# NCCL, a card a rank, against the same unsharded model, then llama4-scout
# at full depth (SHARDED_4CARD).  The recurrent and encoder families in
# float32 over 1x2 at full width, their depth cut: zamba2 one super-block
# of 6 Mamba2 layers and the shared attention block (56 Mamba heads and
# 16 / 16 attention heads a rank), rwkv6 2 layers (16 WKV heads a rank), gemma3
# one 5 local + 1 global super-block with a prompt past its window (the
# local layers' rings roll at prefill and wrap at every decode step; 4 / 2
# heads a rank at hd 256) and whisper 2 + 2 layers with its 1500 encoder
# frames (8 / 8 heads a rank, the cross cache a view); held as the float32
# runs above, and each rank's flash or WKV launches the unsharded count.
SHARDED_RUNS = (
    dict(label="llama4-scout float32, 2 layers", arch="llama4-scout-17b-a16e",
         cut={"n_layers": 2}, dtype="float32", mesh=(1, 4), scheme="tp_only",
         batch=F32_BATCH, prompt=256 + F32_PROMPT, tokens=F32_DECODE),
    dict(label="qwen2-moe float32, 2 layers", arch="qwen2-moe-a2.7b", cut={"n_layers": 2},
         dtype="float32", mesh=(1, 4), scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT,
         tokens=F32_DECODE),
    dict(label="llama4-scout bfloat16, 8 layers", arch="llama4-scout-17b-a16e",
         cut={"n_layers": 8}, dtype="bfloat16", mesh=(1, 4), scheme="tp_only",
         batch=LM_BATCH, prompt=LM_PROMPT, tokens=LM_TOKENS),
    dict(label="qwen2-moe bfloat16", arch="qwen2-moe-a2.7b", cut={}, dtype="bfloat16",
         mesh=(1, 4), scheme="tp_only", batch=LM_BATCH, prompt=LM_PROMPT, tokens=LM_TOKENS),
    dict(label="tinyllama float32", arch="tinyllama-1.1b", cut={}, dtype="float32",
         mesh=(1, 2), scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT, tokens=F32_DECODE),
    dict(label="tinyllama bfloat16", arch="tinyllama-1.1b", cut={}, dtype="bfloat16",
         mesh=(1, 2), scheme="tp_only", batch=LM_BATCH, prompt=LM_PROMPT, tokens=LM_TOKENS),
    dict(label="zamba2 float32, 6 layers", arch="zamba2-7b", cut={"n_layers": 6},
         dtype="float32", mesh=(1, 2), scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT,
         tokens=F32_DECODE),
    dict(label="rwkv6 float32, 2 layers", arch="rwkv6-1.6b", cut={"n_layers": 2},
         dtype="float32", mesh=(1, 2), scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT,
         tokens=F32_DECODE),
    dict(label="gemma3 float32, 6 layers", arch="gemma3-4b", cut={"n_layers": 6},
         dtype="float32", mesh=(1, 2), scheme="tp_only", batch=F32_BATCH, prompt=1040,
         tokens=F32_DECODE),
    dict(label="whisper float32, 2 + 2 layers", arch="whisper-medium",
         cut={"n_layers": 2, "encoder_layers": 2}, dtype="float32", mesh=(1, 2),
         scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT, tokens=F32_DECODE),
)
SHARDED_4CARD = (
    SHARDED_RUNS[0],
    dict(label="llama4-scout bfloat16, full depth", arch="llama4-scout-17b-a16e",
         cut={}, dtype="bfloat16", mesh=(1, 4), scheme="tp_only", batch=LM_BATCH,
         prompt=LM_PROMPT, tokens=LM_TOKENS),
)
SHARDED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of max|logit|
SHARDED_TIMEOUT_S = 600.0

# Sharded training (phase 10d): the train step over a 2x2 mesh of ranks in
# fresh processes (one ``run_ranks`` spawn, gloo, the four sharing the
# card), each run at full width with its depth cut, in float32 under
# float32_math, each run's batch x seq, each against
# the unsharded step on the card, run alone first: granite-8b under
# fsdp_tp (FSDP over data, tensor parallel over model; 0.84 B parameters,
# 13.4 GB of masters, gradients and AdamW moments unsharded) and
# qwen2-moe-a2.7b under tp_only (experts split by F over model, rows and
# the Switch loss's statistics over data; 1.76 B, 28 GB).  Memory: a
# rank's AdamW step (lm.make_train_step, a group of leaves at a time) ends
# holding its parameters and new moments, 3 P, beside the old moments;
# tp_only leaves a qwen2 rank half the model, P = 3.5 GB, and four ranks
# share the card, so they start from zero moments held as broadcast views
# (the values opt.init gives, without their bytes) and peak near 4 x 3.5 P
# = 49 GB of the card's 80 (with real zero moments and a step holding 5 P
# at once, four qwen2 ranks do not fit).  Limits, as the CPU tests': loss
# 1e-5 relative, each gradient leaf 1e-4 of its max |g|.  A MoE model's
# top-k expert choices flip at near-ties between the sharded and unsharded
# float32 runs (the row-parallel sums round in another order; 4 of 65536
# for qwen2-moe on an H100), and one flipped choice moves every leaf's
# gradient by more than 1e-4 of its max (by 1.381e-01 on an expert's w_in).
# So each rank's MoE blocks take the unsharded run's choices for its rows
# (``_RouteForce``): each rank's own choices are counted against them, and
# every choice that differs must be a tie, its gates within ROUTE_TIE of
# the chosen one's; with the choices aligned every leaf, the router's and
# the Switch loss's path included, is held to 1e-4.  The step: one AdamW step from zero moments
# moves each element by about lr sign(g) (first rate 5e-6), so a bound on
# the parameters' difference alone cannot tell a step from none.  Each
# parameter, and its v, is held inside the window that the step allows a
# gradient within the leaf's limit of the unsharded one (the steps of the
# window's ends, widened by two float32 ulps and 1e-11): about 2 lr wide
# where |g| is within the limit (the sign is open; those elements are
# counted), far below lr elsewhere.
#
# Then, in the same spawn, the recurrent and encoder families at full width
# and batch 2 x 256: zamba2 under fsdp_tp over the 2x2 mesh (one
# super-block of 6 Mamba2 layers and the shared block; 0.90 B parameters),
# and over 1x2 tp_only, on ranks 0 and 1 in a process group of their own,
# rwkv6 (2 layers; 0.38 B), gemma3 (2 local layers; 1.53 B, most of it its
# 262,144-word embedding and head) and whisper (2 + 2 layers, its 1500
# encoder frames; 0.18 B).  Their Mamba2 and RWKV6 blocks read replicated
# weights for the rank's heads only, whose gradients a rank forms in part
# and sums over the model axis: the bit-equal check of every piece two
# ranks hold is what catches a miss.  rwkv6 at its random init (decay ~
# 0.9975: the WKV state sums nearly all past k v^T before the per-head group
# norm) amplifies float32 rounding in its gradients as in its logits (phase
# 7's 1e-2): the unsharded step moves a leaf by 2.327e-04 of its max when
# every weight moves by one float32 ulp (H100, torch 2.11), more than 1e-4.
# Its gradients (and so its windows) are held to 1e-4 or that floor,
# measured in the same run, whichever is larger, as phase 6b holds
# bfloat16 logits (run["floor"]).
SHARDED_TRAIN = (
    dict(label="granite-8b fsdp_tp, 2 layers", arch="granite-8b", cut={"n_layers": 2},
         mesh=(2, 2), scheme="fsdp_tp", batch=4, seq=512),
    dict(label="qwen2-moe tp_only, 2 layers", arch="qwen2-moe-a2.7b", cut={"n_layers": 2},
         mesh=(2, 2), scheme="tp_only", batch=4, seq=512),
    dict(label="zamba2 fsdp_tp, 6 layers", arch="zamba2-7b", cut={"n_layers": 6},
         mesh=(2, 2), scheme="fsdp_tp", batch=2, seq=256, ckpt=True),
    dict(label="rwkv6 tp_only, 2 layers", arch="rwkv6-1.6b", cut={"n_layers": 2},
         mesh=(1, 2), scheme="tp_only", batch=2, seq=256, floor=True),
    dict(label="gemma3 tp_only, 2 layers", arch="gemma3-4b", cut={"n_layers": 2},
         mesh=(1, 2), scheme="tp_only", batch=2, seq=256),
    dict(label="whisper tp_only, 2 + 2 layers", arch="whisper-medium",
         cut={"n_layers": 2, "encoder_layers": 2}, mesh=(1, 2), scheme="tp_only", batch=2,
         seq=256),
)
SHARDED_TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4}
ROUTE_TIE = 1e-4   # largest gate gap of a choice a rank makes otherwise than the unsharded run
SHARDED_TRAIN_BUDGET_S = 180.0
# Shared KV heads (phase 10f): one ``run_ranks`` spawn of 16 ranks sharing
# the card over gloo, a model axis of 16 as at the reference's production
# meshes, where the KV heads are fewer than the ranks: R = 16 / Hkv
# consecutive ranks (a replica group) each hold one KV head whole and split
# its query heads (``sharding.attn_heads``).  Full width, depth cut,
# float32 under float32_math, each run against the unsharded model on the
# card, run alone first, held to phase 6b's and 10d's limits:
# llama3.2-3b over 1x16 tp_only (24 / 8 heads: query heads 2 / 1 a rank,
# KV heads shared by pairs) serves and takes one train step; gemma3-4b
# over 1x16 serves (8 / 4 heads: 1 / 1 / 0 / 0 query heads in each group of
# four, so ranks with no query head; one 5 local + 1 global super-block,
# prompt 1040, the rings roll and wrap); tinyllama-1.1b over 2x8 fsdp_tp
# (32 / 4 heads: 4 / 4, KV heads shared by pairs under FSDP) takes one
# train step.  Each rank's flash launches are its heads' count (none where
# it holds no query head), every piece two ranks hold (the KV replicas
# included) is bit-equal after the step.
SHARED_KV_RANKS = 16
SHARED_KV_SERVE = (
    dict(label="llama3.2-3b float32, 2 layers, 1x16", arch="llama3.2-3b", cut={"n_layers": 2},
         dtype="float32", mesh=(1, 16), scheme="tp_only", batch=F32_BATCH, prompt=F32_PROMPT,
         tokens=F32_DECODE),
    dict(label="gemma3 float32, 6 layers, 1x16", arch="gemma3-4b", cut={"n_layers": 6},
         dtype="float32", mesh=(1, 16), scheme="tp_only", batch=F32_BATCH, prompt=1040,
         tokens=F32_DECODE),
)
SHARED_KV_TRAIN = (
    dict(label="llama3.2-3b tp_only 1x16, 2 layers", arch="llama3.2-3b", cut={"n_layers": 2},
         mesh=(1, 16), scheme="tp_only", batch=2, seq=256),
    dict(label="tinyllama fsdp_tp 2x8, 2 layers", arch="tinyllama-1.1b", cut={"n_layers": 2},
         mesh=(2, 8), scheme="fsdp_tp", batch=4, seq=512),
)
SHARED_KV_BUDGET_S = 120.0   # the spawn: start, init, serve, a step each
# Phase 8's rows at a rank's heads under the shared-KV split, bfloat16 at
# 4 x 2048: model index 0 of llama3.2-3b over 1x16 (2 query heads over 1 KV
# head, hd 128) and of gemma3-4b (1 over 1, hd 256, local and global
# layers); their launches are phase 10f's rank 0's (``timed_from``).
SHARED_KV_TIMED = (
    dict(label="llama3.2-3b 1x16 rank 0", arch="llama3.2-3b", cut={"n_layers": 1},
         mesh=(1, 16), batch=4, seq=2048, timed_from=SHARED_KV_TRAIN[0]["label"]),
    dict(label="gemma3-4b 1x16 rank 0", arch="gemma3-4b", cut={"n_layers": 6},
         mesh=(1, 16), batch=4, seq=2048, timed_from=SHARED_KV_SERVE[1]["label"]),
)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "tinyllama-1.1b", 4, 2048   # phase 10a
# --sharded-4card training: granite-8b at full width and depth over NCCL, a
# card a rank, float32 masters and bfloat16 compute, TRAIN_BATCH x
# TRAIN_SEQ, TRAIN_STEPS steps on one repeated batch at TRAIN_LR (loss down
# TRAIN_MIN_DROP, as phase 10a), at 1x4 tp_only and 2x2 fsdp_tp.
# Then zamba2-7b (6.75 B parameters: 108 GB of float32 masters, gradients
# and AdamW moments; no one card trains it) at 1x4 tp_only and 2x2
# fsdp_tp, and gemma3-4b (4.55 B; 73 GB of masters, gradients and moments; its
# 262,144 words at 4 x 2048 give 8.6 GB of float32 logits, of which a rank's
# vocab-parallel loss forms its quarter) at 1x4 tp_only.
# granite-8b's 2x2 run also saves its state (ckpt.save_sharded, ~99 GB:
# float32 masters and AdamW's m and v) after TRAIN_RESUME_AFTER steps,
# restores it into fresh models after the tenth and takes the last steps
# again: their losses must be the uninterrupted run's, bit for bit.
TRAIN_RESUME_AFTER = 5
TRAIN_4CARD = (
    dict(label="granite-8b tp_only 1x4", arch="granite-8b", cut={}, mesh=(1, 4),
         scheme="tp_only", batch=TRAIN_BATCH, seq=TRAIN_SEQ),
    dict(label="granite-8b fsdp_tp 2x2", arch="granite-8b", cut={}, mesh=(2, 2),
         scheme="fsdp_tp", batch=TRAIN_BATCH, seq=TRAIN_SEQ, resume=TRAIN_RESUME_AFTER),
    dict(label="zamba2-7b tp_only 1x4", arch="zamba2-7b", cut={}, mesh=(1, 4),
         scheme="tp_only", batch=TRAIN_BATCH, seq=TRAIN_SEQ),
    dict(label="zamba2-7b fsdp_tp 2x2", arch="zamba2-7b", cut={}, mesh=(2, 2),
         scheme="fsdp_tp", batch=TRAIN_BATCH, seq=TRAIN_SEQ),
    dict(label="gemma3-4b tp_only 1x4", arch="gemma3-4b", cut={}, mesh=(1, 4),
         scheme="tp_only", batch=TRAIN_BATCH, seq=TRAIN_SEQ),
)
# the runs whose peak is printed beside launch/step_costs.py's count of
# their step (the others beside dryrun's plan-only bytes)
COUNTED_4CARD = ("granite-8b fsdp_tp 2x2", "gemma3-4b tp_only 1x4")

# LM training (phase 10a): tinyllama-1.1b at full width and depth, float32
# masters and bfloat16 compute, remat on, AdamW under a cosine schedule, on
# one repeated batch; the loss must fall by TRAIN_MIN_DROP nat from the
# first step to the last.  Then TRAIN_LAUNCHER_STEPS steps of the launcher.
TRAIN_STEPS, TRAIN_LAUNCHER_STEPS, TRAIN_LR, TRAIN_MIN_DROP = 10, 5, 1e-3, 0.5
# Whole-model float32 gradients (phase 10b), card against CPU: (arch, config
# changes, batch, seq).  gemma3 keeps one 5 local + 1 global super-block,
# zamba2 one super-block of 6 Mamba2 layers and the shared block; whisper
# its 1500 encoder frames; internvl2's 256 vision embeddings lead 64 tokens
# (its only sequence past 256).
TRAIN_F32 = (
    ("tinyllama-1.1b", {"n_layers": 2}, 2, 256),
    ("gemma3-4b", {"n_layers": 6}, 1, 256),
    ("qwen2-moe-a2.7b", {"n_layers": 2}, 2, 256),
    ("zamba2-7b", {"n_layers": 6}, 1, 256),
    ("whisper-medium", {"n_layers": 2, "encoder_layers": 2}, 2, 256),
    ("internvl2-26b", {"n_layers": 2}, 1, 320),
    ("rwkv6-1.6b", {"n_layers": 2}, 2, 256),
)
# LM training (phase 10c): rwkv6-1.6b at full width and depth, phase 10a's
# settings and limit, through the WKV kernels forward and backward.
RWKV_TRAIN_ARCH = "rwkv6-1.6b"
# Limits, fixed before the first run.  The backward kernel against its twin:
# max|kernel - plain| / max|plain| of each of dq, dk, dv; both compute in
# float32 from the same inputs, so float32 differs by summation order
# (~1e-6) and bfloat16 by one rounding of each output (2^-8 relative), a
# wrong mask, head or scale by ~1e-1.  Whole-model gradients card against
# CPU: each leaf within GRAD_REL_TOL of its max |g| (float32, ~1e-6 an
# operation, amplified through the depth).
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_REL_TOL = 1e-3
# The WKV backward against its twin (phase 3), fixed before the first run:
# both compute in float32 from the same inputs (the forward holds 1e-5), so
# each gradient the kernel writes within 1e-4 of its max|plain|; with
# bfloat16 r, k, v, the dr, dk, dv the WKV Function rounds to bfloat16 (once
# an element, 2^-8 relative) within 1e-2.  The forms: rwkv6's training
# shape at the model's slow decays and at fast ones, with and without state0
# and dstateT, float32 and bfloat16 r, k, v, S = 1, 47 and 1111 (ragged), hd
# 16, 32 and 128: (label, (B, S, H, hd), fast, r k v dtype, state0, dstateT).
WKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
WKV_BWD_FORMS = (
    ("rwkv6 training", (4, 2048, 32, 64), False, "bfloat16", False, False),
    ("rwkv6 training, float32", (4, 2048, 32, 64), False, "float32", False, False),
    ("rwkv6 shape, fast decay, state0, dstateT", (4, 2048, 32, 64), True, "bfloat16", True, True),
    ("rwkv6 shape, fast decay, state0", (4, 2048, 32, 64), True, "float32", True, False),
    ("rwkv6 shape, dstateT", (4, 2048, 32, 64), False, "float32", False, True),
    ("S=1", (4, 1, 32, 64), True, "float32", True, True),
    ("S=47 (recurrent forward)", (4, 47, 32, 64), False, "bfloat16", True, False),
    ("ragged S=1111", (2, 1111, 32, 64), True, "float32", False, True),
    ("hd 16", (2, 300, 8, 16), True, "bfloat16", True, True),
    ("hd 32", (2, 300, 8, 32), False, "float32", False, False),
    ("hd 128", (2, 300, 8, 128), True, "float32", True, True),
    ("a rank's 16 of 32 heads (phase 10d's rwkv6 over 1x2)", (2, 256, 16, 64), False,
     "float32", False, False),
    ("a rank's 8 of 32 heads (1x4), rwkv6's training shape", (4, 2048, 8, 64), False,
     "bfloat16", False, False),
)
# The zoo's training forms besides phase 10's calls, checked in phase 3:
# label, (B, Sq, Skv, Hq, Hkv, hd), causal, window.
TRAINED_FORMS = (
    ("tinyllama training", (4, 2048, 2048, 32, 4, 64), True, None),
    ("llama3.2-3b heads (hd 128, 24 / 8)", (4, 2048, 2048, 24, 8, 128), True, None),
    ("gemma3 local layer (window 1024)", (4, 2048, 2048, 8, 4, 256), True, 1024),
    ("gemma3 global layer", (4, 2048, 2048, 8, 4, 256), True, None),
    ("zamba2 shared attention (hd 112, G = 1)", (4, 2048, 2048, 32, 32, 112), True, None),
    ("whisper encoder (non-causal)", (4, 1500, 1500, 16, 16, 64), False, None),
    ("whisper decoder self-attention", (4, 448, 448, 16, 16, 64), True, None),
    ("whisper cross-attention", (4, 448, 1500, 16, 16, 64), False, None),
    ("internvl2 (G = 6)", (4, 1024, 1024, 48, 8, 128), True, None),
    ("ragged S", (2, 1111, 1111, 32, 4, 64), True, None),
    ("ragged S, windowed, hd 256", (2, 999, 999, 8, 4, 256), True, 300),
)

# The revision in which each hand-written kernel was last redesigned (earlier
# times are in PERF.md section 6).
REDESIGNED_IN = {"flash_attention": 13, "flash_attention_bwd": 21, "tsgemm": 13,
                 "wkv": {"prefill": 14, "decode": 16}, "wkv_bwd": 23,
                 "proximity": {"eq3": 14, "eq2": 16, "any_rank": 18}}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def memory(torch) -> str:
    """The host's available memory, this process's resident set and the
    card's memory this process holds."""
    def kib(path, key):
        for line in Path(path).read_text().splitlines():
            if line.startswith(key):
                return int(line.split()[1])
        return 0
    return (f"host {kib('/proc/meminfo', 'MemAvailable:') / 2**20:.1f} GiB available, "
            f"this process {kib('/proc/self/status', 'VmRSS:') / 2**20:.1f} GiB resident, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card "
            f"({torch.cuda.memory_reserved() / 2**30:.1f} reserved)")


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
    launches, by kernel name (``launch.kernel_times``: every launch's device
    record present, or it raises)."""
    from repro_torch.launch.kernel_times import kernel_times

    return kernel_times(fn, iters=iters).ms


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


@functools.lru_cache(maxsize=None)
def _cuobjdump(lib_path: str, flag: str) -> str:
    """``cuobjdump <flag>`` of a built library, once per library (its name
    carries the hash of its source)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), flag, lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def count_mma(lib_path, function_substring: str, opcodes=("HMMA", "HGMMA")) -> int:
    """Tensor-core instructions (``opcodes``) in the SASS of the functions of
    a built library whose names contain ``function_substring``."""
    sass = _cuobjdump(str(lib_path), "--dump-sass")
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
    usage = _cuobjdump(str(lib_path), "--dump-resource-usage")
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
    # the head dims of zamba2 (112) and gemma3 (256): the bf16 kernel keeps
    # every value in registers (hd 256 re-reads Q from shared memory); the
    # float32 kernel (comparison cases only) may spill, and says how much
    lib = _build.library_path("flash_attention")
    for hd in (112, 256):
        mangled = f"flash_fwd_tcILi{hd}ELi1EE"
        hmma, usage = count_mma(lib, mangled), resource_usage(lib, mangled)
        log("build", f"flash_fwd_tc<{hd}, 1>: {hmma} HMMA instructions; {usage[0]} registers "
            f"a thread, {usage[1]} bytes of stack")
        require(hmma > 0 and usage[1] == 0, f"flash_fwd_tc<{hd}, 1>: {hmma} HMMA, {usage}")
    for label, mangled in (("flash_fwd_f32<112>", "flash_fwd_f32ILi112EE"),
                           ("flash_fwd_f32<128>", "flash_fwd_f32ILi128EE"),
                           ("flash_fwd_f32<256>", "flash_fwd_f32ILi256EE"),
                           ("flash_combine", "flash_combine")):
        usage = resource_usage(lib, mangled)
        log("build", f"{label}: {usage[0]} registers a thread, {usage[1]} bytes of stack")
    # the backward: bf16 on the tensor cores at every head dim, without
    # spills; float32 on the CUDA cores (FP32 FMAs, no HMMA)
    bwd = _build.library_path("flash_attention_bwd")
    log("build", f"flash_attention_bwd.cu: nvcc "
        f"{_build.BUILD_SECONDS.get('flash_attention_bwd', 0):.1f} s")
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    for hd in HEAD_DIMS:
        for kernel in ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc"):
            mangled = f"{kernel}ILi{hd}EE"
            hmma, usage = count_mma(bwd, mangled), resource_usage(bwd, mangled)
            log("build", f"{kernel}<{hd}> (bf16): {hmma} HMMA/HGMMA instructions; {usage[0]} "
                f"registers a thread, {usage[1]} bytes of stack (spills)")
            require(hmma > 0 and usage[1] == 0, f"{kernel}<{hd}>: {hmma} HMMA, {usage}")
    for hd in (64, 112, 128, 256):
        for kernel in ("flash_bwd_dkdv", "flash_bwd_dq"):
            usage = resource_usage(bwd, f"{kernel}IfLi{hd}EE") or ("?", "?")
            log("build", f"{kernel}<float, {hd}>: {usage[0]} registers a thread, {usage[1]} "
                f"bytes of stack")
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
                                 ("wkv", "wkv_step<64, bf16>", "wkv_stepILi64E13__nv_bfloat16E"),
                                 ("wkv_bwd", "wkv_bwd_scan<64>", "wkv_bwd_scanILi64EE")):
        usage = resource_usage(_build.library_path(name), mangled)
        if usage is None:
            log("build", f"{label}: not in cuobjdump's resource usage")
            continue
        log("build", f"{label}: {usage[0]} registers a thread, {usage[1]} bytes of stack")
        require(usage[1] == 0, f"{label} spills to the stack ({usage[1]} bytes)")
    # the WKV backward's tensor-core kernels (3xTF32 mma.sync) at rwkv6's head
    # dim and at hd 128, both r, k, v dtypes: HMMA instructions, no stack
    bwd = _build.library_path("wkv_bwd")
    for kernel in ("wkv_bwd_chunk_tc", "wkv_bwd_grad_tc"):
        for hd in (64, 128):
            for dtype, mangled_type in (("bf16", "13__nv_bfloat16"), ("float", "f")):
                mangled = f"{kernel}ILi{hd}E{mangled_type}E"
                hmma, usage = count_mma(bwd, mangled), resource_usage(bwd, mangled)
                log("build", f"{kernel}<{hd}, {dtype}>: {hmma} HMMA instructions; {usage[0]} "
                    f"registers a thread, {usage[1]} bytes of stack")
                require(hmma > 0 and usage[1] == 0,
                        f"{kernel}<{hd}, {dtype}>: {hmma} HMMA, {usage}")


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


def flash_form(dims, causal: bool, window, q_offset: int, slots) -> tuple:
    """A flash call's form: (B, Sq, Skv, Hq, Hkv, hd), causal, window,
    q_offset, and the slots of the cache K and V are a view of (None when
    they are whole tensors).  Phase 3 keys its checks by it, phase 6 records
    the form of every call it makes."""
    return tuple(int(x) for x in dims), bool(causal), window, int(q_offset), slots


def rank_heads(cfg, model: int, index=None) -> list:
    """The distinct (query heads, KV heads) of attention that the ranks of
    a model axis of ``model`` hold (``sharding.attn_heads``; only model
    index ``index``'s where given), leaving out a rank with no query head,
    which makes no flash call."""
    from repro_torch import sharding

    out = []
    for i in range(model) if index is None else (index,):
        (_, n_q), (_, n_kv) = sharding.attn_heads(cfg, model, i)
        if n_q and (n_q, n_kv) not in out:
            out.append((n_q, n_kv))
    return out


def model_flash_calls(cfg, batch: int, model: int, seq: int, tokens=None, index=None) -> dict:
    """{form: label} of every distinct flash call a forward of ``cfg`` makes
    on ``batch`` rows and a rank's heads over a model axis of ``model``
    (``rank_heads``: every rank's, or model index ``index``'s): with
    ``tokens`` None a train-mode forward of ``seq`` tokens (the backward
    takes each forward's form), else a prefill of ``seq`` then decode steps
    up to ``seq + tokens - 1``, each decode form at the first and the last
    step (the steps between differ only in q_offset).  Encoder
    self-attention, cross attention (at decode over the cache padded to a
    multiple of 128), and each self-attention kind, the shared attention
    block's global."""
    calls = {}
    has_attention = cfg.block_kind == "attn" or cfg.attn_every
    for n_q, n_kv in rank_heads(cfg, model, index) if has_attention else ():
        _rank_flash_calls(cfg, batch, (n_q, n_kv, cfg.resolved_head_dim), seq, tokens, calls)
    return calls


def _rank_flash_calls(cfg, batch: int, heads: tuple, seq: int, tokens, calls: dict) -> None:
    """:func:`model_flash_calls` on one rank's ``heads`` (Hq, Hkv, hd),
    added to ``calls``."""
    from repro_torch.models import attention, lm

    def add(label, Sq, Skv, causal, window, q_off, slots=None):
        calls.setdefault(flash_form((batch, Sq, Skv, *heads), causal, window, q_off, slots),
                         label)

    if cfg.is_enc_dec:
        n_enc = cfg.encoder_seq
        add("encoder self-attention", n_enc, n_enc, False, None, 0)
        add("cross-attention" if tokens is None else "cross-attention prefill", seq, n_enc,
            False, None, 0)
        if tokens is not None:
            add("cross-attention decode", 1, n_enc, False, None, 0, n_enc + (-n_enc) % 128)
    stages = lm.stages_for(cfg)
    kinds = {kind for st in stages if st.kind == "attn" and st.repeats for kind in st.sub}
    if any(st.shared_attn for st in stages):
        kinds.add("global")
    for kind in sorted(kinds):
        window = cfg.window if kind == "local" else None
        if tokens is None:
            add(f"{kind} self-attention", seq, seq, True, window, 0)
            continue
        add(f"{kind} prefill", seq, seq, True, window, 0)
        s_cache = lm._cache_len(cfg, kind, seq + tokens)
        for pos in (seq, seq + tokens - 2):
            form = attention.decode_form(s_cache, pos, window)
            add(f"{kind} decode at {pos}", 1, s_cache, form.causal, form.window,
                form.q_offset)


def served_flash_calls() -> list:
    """(label, form) of every distinct flash call of phase 6's runs
    (``model_flash_calls``), then the FAMILY_FLASH calls and phase 6b's
    (``sharded_flash_calls``).  Phase 6 checks that its runs made no
    other."""
    from repro_torch.configs import get_config

    calls = {}
    for arch, prompt, kernel in LM_SERVED:
        if kernel != "flash_attention":
            continue
        for form, label in model_flash_calls(get_config(arch), LM_BATCH, 1, prompt,
                                             LM_TOKENS).items():
            calls.setdefault(form, f"{arch} {label}")
    for _, label, dims, causal, window, q_off, slots in FAMILY_FLASH:
        calls.setdefault(flash_form(dims, causal, window, q_off, slots), label)
    for label, form in sharded_flash_calls():
        calls.setdefault(form, label)
    return [(label, form) for form, label in calls.items()]


def sharded_flash_calls() -> list:
    """(label, form) of every distinct flash call a rank of phase 6b makes
    (and of the four-card run and phase 10f's serving): on the rank's
    heads, at prefill and at the first and the last decode step."""
    calls = {}
    for run in SHARDED_RUNS + SHARDED_4CARD + SHARED_KV_SERVE:
        data, model = run["mesh"]
        for form, label in model_flash_calls(_sharded_config(run), run["batch"] // data, model,
                                             run["prompt"], run["tokens"]).items():
            calls.setdefault(form, f"{run['label']}: a rank's {label}")
    return [(label, form) for form, label in calls.items()]


def sharded_flash_timed() -> tuple:
    """Phase 8's cases (FAMILY_FLASH's layout, keyed by the phase-6b run)
    for each bfloat16 run's per-rank prefill and last decode step."""
    from repro_torch.configs import get_config

    cases = []
    for run in SHARDED_RUNS:
        if run["dtype"] != "bfloat16":
            continue
        cfg = get_config(run["arch"])
        heads = (cfg.n_heads // run["mesh"][1], cfg.n_kv_heads // run["mesh"][1],
                 cfg.resolved_head_dim)
        B, S, T = run["batch"] // run["mesh"][0], run["prompt"], run["tokens"]
        cases.append((run["label"], f"{run['label']}: a rank's prefill", (B, S, S, *heads),
                      True, None, 0, None))
        cases.append((run["label"], f"{run['label']}: a rank's decode", (B, 1, S + T, *heads),
                      True, None, S + T - 2, None))
    return tuple(cases)


def check_flash(torch, device, errs: dict) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.flash_attention.flash_attention import split_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    tinyllama, llama3b = (32, 4, 64), (24, 8, 128)   # (Hq, Hkv, hd)

    def compare(label, B, Sq, Skv, dtype, causal=True, window=None, q_offset=0,
                heads=tinyllama, slots=None):
        Hq, Hkv, hd = heads
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device=device).to(dtype)
        # with ``slots``, K and V are views of the first Skv slots of a cache
        k = torch.randn((B, slots or Skv, Hkv, hd), generator=gen, device=device).to(dtype)
        v = torch.randn((B, slots or Skv, Hkv, hd), generator=gen, device=device).to(dtype)
        k, v = k[:, :Skv], v[:, :Skv]
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
        errs["by_case"][(flash_form((B, Sq, Skv, Hq, Hkv, hd), causal, window, q_offset, slots),
                         dtype)] = err

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
        # every call phase 6 makes, at its shape, form and cache stride
        # (gemma3's global decode splits its keys, merged by flash_combine
        # at hd 256), and the FAMILY_FLASH calls; then forms off the main
        # path: gemma3's ring before it fills, ragged and windowed cases at
        # hd 112 and 256
        # and a rank's training forward of phase 10d and the four-card runs
        for label, form in served_flash_calls() + sharded_train_flash_calls():
            (B, Sq, Skv, Hq, Hkv, hd), causal, window, q_off, slots = form
            if (form, dtype) not in errs["by_case"]:
                compare(label, B, Sq, Skv, dtype, causal=causal, window=window,
                        q_offset=q_off, heads=(Hq, Hkv, hd), slots=slots)
        gemma, zamba = (8, 4, 256), (32, 32, 112)
        compare("gemma3 ring decode before it fills", LM_BATCH, 1, 1024, dtype, q_offset=500,
                heads=gemma)
        compare("windowed ragged hd 256", 2, 1000, 1000, dtype, window=128, heads=gemma)
        compare("ragged suffix hd 112", 2, 77, 1111, dtype, q_offset=1034, heads=zamba)
        compare("decode, no valid key, hd 256", LM_BATCH, 1, 1056, dtype, window=100,
                q_offset=1400, heads=gemma)
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


def check_wkv(torch, device, errs: list, rank_errs: list) -> None:
    """Phase 3, WKV: prefill and decode at rwkv6's serving shape and off it
    (``errs``), then at a rank's heads (``rank_errs``): phase 6b's 16 of 32
    over 1x2 in float32, and 8 of 32 (1x4) at the serving shape."""
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain, wkv_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    H, hd = 32, 64   # rwkv6-1.6b

    def compare(label, ops, state0, errs=errs):
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
    for B, S, heads, rkv in ((F32_BATCH, F32_PROMPT, H // 2, torch.float32),
                             (LM_BATCH, LM_PROMPT, H // 4, torch.bfloat16)):
        def cast(ops):
            return tuple(a.to(rkv) if i < 3 else a for i, a in enumerate(ops))

        st = compare(f"a rank's {heads} of {H} heads: prefill",
                     cast(wkv_inputs(torch, gen, B, S, heads, hd, device)), None, rank_errs)
        compare(f"a rank's {heads} of {H} heads: decode S=1, carried state",
                cast(wkv_inputs(torch, gen, B, 1, heads, hd, device)), st, rank_errs)


def wkv_bwd_operands(torch, gen, dims, fast, dtype, with_state, with_dT, device):
    """r, k, v (in ``dtype``), w, u at ``wkv_inputs``' scales, and dout,
    state0 (0.1 x normal) and dstateT (normal) or None."""
    B, S, H, hd = dims
    r, k, v, w, u = wkv_inputs(torch, gen, B, S, H, hd, device, fast=fast)
    dout = torch.randn((B, S, H, hd), generator=gen, device=device)
    s0 = (0.1 * torch.randn((B, H, hd, hd), generator=gen, device=device)
          if with_state else None)
    dT = torch.randn((B, H, hd, hd), generator=gen, device=device) if with_dT else None
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u), dout, s0, dT


def check_wkv_bwd(torch, device, errs: list, by_label: dict) -> None:
    """Phase 3, the WKV backward: at each of WKV_BWD_FORMS, the forward's
    chunk-start states, then dr, dk, dv, dw, du, dstate0 of two launches
    (bitwise equal) against the plain twin's (WKV_BWD_TOL); each form's
    largest difference in ``errs`` and by its label in ``by_label``."""
    from repro_torch.kernels.wkv import wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    for label, dims, fast, dtype_name, with_state, with_dT in WKV_BWD_FORMS:
        dtype = getattr(torch, dtype_name)
        (r, k, v, w, u), dout, s0, dT = wkv_bwd_operands(torch, gen, dims, fast, dtype,
                                                         with_state, with_dT, device)
        _, _, starts = wkv_cuda(r, k, v, w, u, s0, return_starts=True)
        got = wkv_bwd_cuda(r, k, v, w, u, dout, starts, dT)
        again = wkv_bwd_cuda(r, k, v, w, u, dout, starts, dT)
        want = wkv_bwd_plain(r, k, v, w, u, dout, s0, dT)
        torch.cuda.synchronize()
        scale = [b.abs().max().item() for b in want]
        rel = [(a - b).abs().max().item() / sc for a, b, sc in zip(got, want, scale)]
        # the gradients the WKV Function hands back: dr, dk, dv in r, k, v's dtype
        handed = [(a.to(dtype).float() - b).abs().max().item() / sc
                  for a, b, sc in zip(got[:3], want[:3], scale[:3])]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log("kernels", f"wkv backward {label}: r {tuple(r.shape)} {dtype_name}, "
            f"{'fast' if fast else 'slow'} decay, state0 {with_state}, dstateT {with_dT}: "
            f"{', '.join(f'{n} {x:.2e}' for n, x in zip(names, rel))} of max|plain| (limit "
            f"{WKV_BWD_TOL['float32']}); in {dtype_name} dr, dk, dv "
            f"{', '.join(f'{x:.2e}' for x in handed)} (limit {WKV_BWD_TOL[dtype_name]}); two "
            f"launches bitwise equal: {same}")
        require(finite and same and max(rel) <= WKV_BWD_TOL["float32"]
                and max(handed) <= WKV_BWD_TOL[dtype_name],
                f"wkv backward {label}: {rel}, {handed}, bitwise {same}")
        errs.append(max((a - b).abs().max().item() for a, b in zip(got, want)))
        by_label[label] = errs[-1]
        del r, k, v, w, u, dout, s0, dT, starts, got, again, want
    torch.cuda.empty_cache()


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
            "label_of": label_of, "labels": labels, "one_shot_s": t1 - t0}


def phase_main_path(torch, fed) -> dict:
    """Phase 4; its clients stay in the result under ``"data"`` until phase
    4c has clustered them again."""
    from repro_torch.core.pacfl import PACFLConfig

    config = PACFLConfig(p=RANK, measure="eq3", beta=BETA_DEG,
                         svd_method="randomized_tsgemm", proximity_backend="auto")
    data = planted_data(torch, fed)
    run = pacfl_path(torch, fed, config, data, "main")
    run["data"] = data
    return run


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


# The "sharded" proximity backend (phase 4c): the K x K matrix in row strips,
# one per local card, each strip the kernel's cross form against the whole
# stack.  At K = 16384 clients of phase 4's geometry (n = 3072, p = 3: a 0.6
# GB stack, a 1.07 GB matrix) through "kernel", "sharded" over every local
# card and the strip function over SHARDED_STRIPS copies of one card; the
# any-rank route (p = 16) at K = 2048; a 16384 x 64 cross block; phase 4's
# one-shot clustering again through "sharded".  At most 60 s.
SHARDED_K, SHARDED_ANY_RANK_K, SHARDED_CROSS_KB = 16384, 2048, 64
SHARDED_STRIPS = 4
SHARDED_BUDGET_S = 60.0


def phase_sharded(torch, device, main) -> dict:
    """Phase 4c: the ``"sharded"`` backend through its entry points.

    One launch window holds the main path: ``proximity_matrix`` and
    ``cross_proximity`` with ``backend="sharded"``, the strip function over
    the card listed SHARDED_STRIPS times, and phase 4's one-shot clustering
    through ``"sharded"`` (its labels must be phase 4's).  Outside it, each
    result is held against the ``"kernel"`` backend's on the same stack:
    eq3 bitwise; eq2 bitwise where the square's and every strip's
    ``eq2_plan`` take one split of n, else within PROX_TOL_DEG; then each
    call is timed with CUDA events."""
    import dataclasses

    from repro_torch.core import angles
    from repro_torch.core.pacfl import one_shot_clustering
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cross
    from repro_torch.kernels.proximity.proximity import eq2_plan

    t_start = time.perf_counter()
    card = torch.device("cuda", torch.cuda.current_device())
    ndev = torch.cuda.device_count()
    four = [card] * SHARDED_STRIPS
    sms = _build.sm_count(card.index)
    log("sharded", f"'sharded' over {ndev} local card(s) "
        f"({', '.join(torch.cuda.get_device_name(i) for i in range(ndev))}); "
        f"the strip function over {SHARDED_STRIPS} strips of {card}")
    fed = Federation(torch, device, seed=SEED + 21)
    U = fed.signatures(planted(SHARDED_K))
    V = fed.signatures(planted(SHARDED_CROSS_KB))
    U16 = Federation(torch, device, p=ANY_RANK_P, seed=SEED + 22).signatures(
        planted(SHARDED_ANY_RANK_K))
    stacks = {f"K={SHARDED_K}": (U, U), f"cross {SHARDED_K}x{SHARDED_CROSS_KB}": (U, V),
              f"any rank K={SHARDED_ANY_RANK_K} p={ANY_RANK_P}": (U16, U16)}
    log("sharded", f"stacks: {SHARDED_K} x {N_FEATURES} x {RANK} float32 "
        f"({U.numel() * 4 / 1e9:.2f} GB; matrix {SHARDED_K ** 2 * 4 / 1e9:.2f} GB), "
        f"{SHARDED_CROSS_KB} newcomers, {SHARDED_ANY_RANK_K} x {N_FEATURES} x {ANY_RANK_P}")

    def calls(Ua, Ub, measure):
        """label -> the raw (Ka, Kb) result's function, per route."""
        if Ua is Ub:
            public = lambda: angles._proximity_strips(Ua, Ua, measure,
                                                      angles._strip_devices(card))
        else:
            public = lambda: angles.cross_proximity(Ua, Ub, measure, backend="sharded")
        return {"sharded": public,
                f"strips x{SHARDED_STRIPS}": lambda: angles._proximity_strips(Ua, Ub, measure,
                                                                              four)}

    # -- the main path, in its own launch window -----------------------------
    _build.reset_launches()
    got = {}
    for label, (Ua, Ub) in stacks.items():
        for measure in ("eq3", "eq2"):
            if Ua is Ub:
                got[label, measure, "sharded"] = angles.proximity_matrix(
                    Ua, measure, backend="sharded")
                got[label, measure, f"strips x{SHARDED_STRIPS}"] = angles._hygiene(
                    angles._proximity_strips(Ua, Ua, measure, four))
            else:
                for route, fn in calls(Ua, Ub, measure).items():
                    got[label, measure, route] = fn()
    config = dataclasses.replace(main["config"], proximity_backend="sharded")
    t0 = time.perf_counter()
    clustering = one_shot_clustering(main["data"]["clients"], config, seed=SEED, device=device)
    sync(torch, device)
    one_shot_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    routes = dict(_build.ROUTE_LAUNCHES)
    log("sharded", f"launch window: kernel launches {launches}, proximity by route "
        f"{ {r: c for (k, r), c in routes.items() if k == 'proximity'} }")
    # one launch a non-empty strip: the square and the cross block at K =
    # 16384 and the any-rank square, each measure, each route; the one-shot
    per_measure = 2 * (min(ndev, SHARDED_K) + SHARDED_STRIPS) + (
        min(ndev, SHARDED_ANY_RANK_K) + SHARDED_STRIPS)
    want_launches = 2 * per_measure + min(ndev, N_CLIENTS)
    require(launches.get("proximity", 0) == want_launches,
            f"phase 4c: {launches.get('proximity', 0)} proximity launches, want {want_launches}")
    require(routes.get(("proximity", "eq3_any_rank"), 0) > 0
            and routes.get(("proximity", "eq2_any_rank"), 0) > 0,
            "phase 4c never launched the any-rank route")
    require(bool((clustering.labels == main["labels"]).all()),
            "phase 4c: one-shot labels through 'sharded' differ from phase 4's")
    log("sharded", f"phase 4's one-shot clustering through 'sharded': {one_shot_s:.2f} s "
        f"(phase 4: {main['one_shot_s']:.2f} s), {clustering.n_clusters} clusters, labels "
        f"equal to phase 4's")
    del clustering
    main.pop("data")

    # -- held against the "kernel" backend -----------------------------------
    out = {"launches": launches, "routes": routes, "ndev": ndev, "one_shot_s": one_shot_s}
    for label, (Ua, Ub) in stacks.items():
        Ka, n, p = Ua.shape
        Kb, _, q = Ub.shape
        square = Ua is Ub
        for measure in ("eq3", "eq2"):
            want = proximity_cross(Ua, Ub, measure)
            if square:
                want = angles._hygiene(want)
            sync(torch, device)
            for route, devs in (("sharded", angles._strip_devices(card)),
                                (f"strips x{SHARDED_STRIPS}", four)):
                plans = ""
                one_split = True
                if measure == "eq2":
                    strip_plans = [eq2_plan(len(r), Kb, n, p, q, False, sms) for r in
                                   torch.tensor_split(torch.arange(Ka), len(devs)) if len(r)]
                    plan_sq = eq2_plan(Ka, Kb, n, p, q, square, sms)
                    one_split = all(pl.splits == 1 for pl in [plan_sq] + strip_plans)
                    plans = (f"; kernel's plan {plan_sq}; strip plans "
                             f"{sorted(set(strip_plans), key=str)}")
                g = got.pop((label, measure, route))
                diff = (g - want).abs().max().item()
                same = torch.equal(g, want)
                finite = bool(torch.isfinite(g).all())
                log("sharded", f"{label} {measure} {route} ({len(devs)} strips): shape "
                    f"{tuple(g.shape)}, max|{route} - kernel| = {diff:.3e} deg, bitwise "
                    f"{same}{plans}")
                require(finite and g.device == Ua.device, f"phase 4c {label} {measure} {route}")
                if measure == "eq3" or one_split:
                    require(same, f"phase 4c {label} {measure} {route} differs from 'kernel' "
                            f"by {diff}")
                else:
                    require(diff <= PROX_TOL_DEG,
                            f"phase 4c {label} {measure} {route}: {diff} deg")
                del g
            del want
            # CUDA-event times of the raw result (no hygiene), each route
            times = {"kernel": time_ms(torch, lambda: proximity_cross(Ua, Ub, measure),
                                       warmup=1, iters=3)}
            for route, fn in calls(Ua, Ub, measure).items():
                times[route] = time_ms(torch, fn, warmup=1, iters=3)
            b_ms, b_by = (prox_bound(Ka, n, p, measure) if square
                          else cross_bound(Ka, Kb, n, p, q, measure))
            log("sharded", f"time {label} {measure}: " + ", ".join(
                f"{r} {ms:.4f} ms" for r, ms in times.items())
                + f"; bound {b_ms:.4f} ms ({b_by})")
            out[label, measure, "ms"] = times
            torch.cuda.empty_cache()
    del U, V, U16
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_start
    log("sharded", f"phase 4c took {seconds:.1f} s (budget {SHARDED_BUDGET_S:.0f} s)")
    require(seconds <= SHARDED_BUDGET_S, f"phase 4c took {seconds:.1f} s")
    out["seconds"] = seconds
    return out


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


def kernel_calls(cfg, kernel: str, prefill: bool, model=(1, 0)) -> int:
    """Launches of ``kernel`` in one forward of ``cfg``: its attention calls
    (``lm.attention_calls``; on a rank of a model axis, ``model``: its size
    and index, the rank's) or WKV calls (``lm.wkv_calls``)."""
    from repro_torch.models import lm

    if kernel == "wkv":
        return lm.wkv_calls(cfg)
    return lm.attention_calls(cfg, prefill, model)


def _model_of(res: dict) -> tuple:
    """(model axis size, index) of a rank's result with ``coords``."""
    i, n = res["coords"].get("model", (0, 1))
    return n, i


class _FlashLog:
    """Records the form (``flash_form``) of every flash call the models make
    (phase 6)."""

    def __init__(self):
        from repro_torch.models import attention

        self.module, self.forms = attention, []
        self.flash = attention.flash_attention

    def __enter__(self):
        def logged(q, k, v, *, causal=True, window=None, q_offset=0):
            B, Skv, Hkv, hd = k.shape
            slots = k.stride(0) // k.stride(1) if k.stride(1) == Hkv * hd else -1
            dims = (B, q.shape[1], Skv, q.shape[2], Hkv, hd)
            self.forms.append(flash_form(dims, causal, window, q_offset,
                                         None if slots == Skv else slots))
            return self.flash(q, k, v, causal=causal, window=window, q_offset=q_offset)

        self.module.flash_attention = logged
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.flash


def require_checked(arch: str, forms: list, checked: set) -> None:
    """Every flash form of ``arch``'s run was held against the plain twin
    in phase 3 (a decode's q_offset within the offsets checked for its
    form)."""
    offsets = collections.defaultdict(list)
    for dims, causal, window, q_off, slots in checked:
        offsets[(dims, causal, window, slots)].append(q_off)
    for form in sorted(set(forms), key=str):
        dims, causal, window, q_off, slots = form
        seen = offsets.get((dims, causal, window, slots), [])
        require(bool(seen) and min(seen) <= q_off <= max(seen),
                f"{arch}: flash call {form} was not checked in phase 3")


def phase_lm_serving(torch, device, checked: set, outputs: dict) -> dict:
    """Phase 6: each architecture served at full width in bfloat16 (one at a
    time, each freed before the next); the launch counts are set to 0 just
    before and read just after each run, and each flash call's form is
    recorded and must be one of ``checked`` (phase 3's bfloat16 forms).
    Returns each run's counts; ``outputs[arch]`` gets its generated tokens
    and last-position prefill logits (phase 6b's reference)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    launches = {}
    for arch, prompt_len, kernel in LM_SERVED:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=device)
        prompt = serve.random_prompt(cfg, LM_BATCH, prompt_len, seed=SEED, device=device)
        extra = serve.model_inputs(cfg, LM_BATCH, dtype=torch.bfloat16, seed=SEED + 1,
                                   device=device)
        sync(torch, device)
        n_params = sum(p.numel() for p in params.parameters())
        log("lm", f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, head dim "
            f"{cfg.resolved_head_dim}, {n_params / 1e9:.3f} B parameters in bfloat16 "
            f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card), built in "
            f"{time.perf_counter() - t0:.1f} s; extra inputs "
            f"{ {k: tuple(v.shape) for k, v in extra.items()} }")
        serve.generate(params, prompt, 2, **extra)   # warm-up: cuBLAS plans, allocator
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        with _FlashLog() as flash_log:
            toks, times = serve.generate(params, prompt, LM_TOKENS, **extra)
        counts = dict(_build.LAUNCHES)
        total = times["prefill_s"] + times["decode_s"]
        log("lm", f"{arch}: batch {LM_BATCH}, prompt {prompt_len}, {LM_TOKENS} tokens: "
            f"prefill {times['prefill_s']:.4f} s, {LM_TOKENS - 1} decode steps "
            f"{times['decode_s']:.4f} s ({LM_BATCH * LM_TOKENS / total:.1f} tok/s, "
            f"decode {LM_BATCH * (LM_TOKENS - 1) / times['decode_s']:.1f} tok/s); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; kernel launches {counts}")
        expected = (kernel_calls(cfg, kernel, True)
                    + (LM_TOKENS - 1) * kernel_calls(cfg, kernel, False))
        require(counts.get(kernel, 0) == expected,
                f"{arch}: {counts.get(kernel, 0)} {kernel} launches, expected {expected}")
        forms = flash_log.forms
        require(len(forms) == counts.get("flash_attention", 0),
                f"{arch}: {len(forms)} flash calls recorded, {counts} launched")
        require_checked(arch, forms, checked)
        if forms:
            log("lm", f"{arch}: {len(forms)} flash calls in {len(set(forms))} forms, each "
                f"held against the plain twin at its shape in phase 3")
        require(tuple(toks.shape) == (LM_BATCH, LM_TOKENS)
                and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_padded,
                f"{arch}: generated tokens out of range")
        with torch.inference_mode():
            prefill = lm.make_prefill_step(prompt_len + LM_TOKENS)
            batch = {"tokens": prompt, **extra}
            logits, cache = prefill(params, batch)
            require(bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits")
            outputs[arch] = {"tokens": toks.cpu(), "logits": logits.float().cpu()}
            tok = logits.argmax(-1)[:, None]
            step = lm.make_serve_step()
            dev_ms = graph_ms(torch, lambda: step(params, cache, tok, prompt_len))
            pre_ms = graph_ms(torch, lambda: prefill(params, batch), iters=5)
        host_ms = times["decode_s"] / (LM_TOKENS - 1) * 1e3
        pre_host_ms = times["prefill_s"] * 1e3
        log("lm", f"{arch}: prefill {pre_host_ms:.3f} ms on the host clock, {pre_ms:.3f} ms "
            f"replayed from a CUDA graph (device idle {1 - pre_ms / pre_host_ms:.1%})")
        log("lm", f"{arch}: one decode step {host_ms:.3f} ms on the host clock, "
            f"{dev_ms:.3f} ms replayed from a CUDA graph (device idle "
            f"{1 - dev_ms / host_ms:.1%} of a host-driven step)")
        log("lm", f"{arch}: sample {toks[0, :12].tolist()}")
        launches[arch] = counts
        del params, prompt, extra, batch, toks, logits, cache, tok
        torch.cuda.empty_cache()
    return launches


def _sharded_config(run: dict):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(run["arch"]), **run["cut"])


def _serve_run(torch, params, run: dict, device, mesh=None) -> dict:
    """One phase-6b serving run on ``params`` (a rank's shard on ``mesh``,
    or the unsharded model): the last-position prefill logits, then
    ``serve.generate`` with the launch counts set to 0 just before and read
    just after and every flash call's form recorded."""
    import contextlib

    from repro_torch._device import float32_math
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = params.cfg
    dtype = getattr(torch, run["dtype"])
    rows = run["batch"] // run["mesh"][0]
    prompt = serve.random_prompt(cfg, run["batch"], run["prompt"], seed=SEED, device=device)
    extra = serve.model_inputs(cfg, run["batch"], dtype=dtype, seed=SEED + 1, device=device)
    if mesh is not None:   # this data group's rows
        from repro_torch import sharding
        extra = sharding.local_batch(cfg, {"tokens": prompt, **extra}, mesh)
        prompt = extra.pop("tokens")
    ctx = float32_math() if dtype == torch.float32 else contextlib.nullcontext()
    with ctx:
        with torch.inference_mode():
            logits, _ = lm.make_prefill_step(run["prompt"] + run["tokens"])(
                params, {"tokens": prompt, **extra})
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launches()
        with _FlashLog() as flash_log:
            toks, times = serve.generate(params, prompt, run["tokens"], **extra)
        launches = dict(_build.LAUNCHES)
    require(tuple(toks.shape) == (rows, run["tokens"]), f"{run['label']}: tokens {toks.shape}")
    return {"tokens": toks.cpu(), "logits": logits.float().cpu(), "launches": launches,
            "forms": flash_log.forms, "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            **times}


def _in_waves(torch, device, wave, fn):
    """``fn()`` on this rank; with ``wave`` (ranks that share the card),
    the process group's ranks take turns in waves of ``wave``, each freeing
    its cached blocks before the next wave starts, so the whole weights an
    init draws one at a time (gemma3-4b's float32 embedding and its scaled
    copy: 5.4 GB) do not meet on the card from every rank at once."""
    import torch.distributed as dist

    if wave is None:
        return fn()
    out = None
    for start in range(0, dist.get_world_size(), wave):
        if start <= dist.get_rank() < start + wave:
            out = fn()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _sharded_rank(runs: list, wave=None) -> list:
    """One rank of phase 6b's runs on one mesh, in its own process
    (``run_ranks`` has joined the process group and set its card), each
    freed before the next: the kernel phase 2 built is loaded, never built;
    the rank's shard is drawn by ``init_params_sharded`` (in waves of
    ``wave`` ranks, :func:`_in_waves`) and served by :func:`_serve_run`."""
    import gc
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import axis_coords, make_mesh

    # the kernels the path launches, loaded as phase 2 built them (never nvcc)
    for name in ("flash_attention", "wkv"):
        require(_build.library_path(name).exists(),
                f"rank {dist.get_rank()}: {name} was not built by phase 2")
    torch.backends.cuda.matmul.allow_tf32 = False       # phase_device's settings
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(*runs[0]["mesh"], device_type="cuda")
    t0 = time.perf_counter()
    torch.zeros(1, device=device)   # the process's first CUDA work: its context
    torch.cuda.synchronize(device)
    context_s = time.perf_counter() - t0
    out = []
    for run in runs:
        cfg = _sharded_config(run)
        t0 = time.perf_counter()
        params = _in_waves(torch, device, wave, lambda: sharding.init_params_sharded(
            cfg, sharding.plan_for(cfg, run["scheme"]), mesh, seed=SEED,
            dtype=getattr(torch, run["dtype"]), device=device))
        torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        res = _serve_run(torch, params, run, device, mesh)
        res.update(init_s=init_s, context_s=context_s, rank=dist.get_rank(),
                   coords=axis_coords(mesh),
                   backend=dist.get_backend(), device=str(device),
                   params=sum(p.numel() for p in params.parameters()),
                   host_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        out.append(res)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ulp_floor(torch, params, run: dict, device, want) -> float:
    """max|logits moved| when each bfloat16 weight of ``params`` moves by one
    ulp, up or down at random (seeded); ``params`` is changed in place."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with torch.no_grad():
        for p in params.parameters():
            if p.dtype == torch.bfloat16:
                up = torch.rand(p.shape, generator=gen, device=device) < 0.5
                step = up.to(torch.int16) * 2 - 1
                p.view(torch.int16).add_(step.masked_fill_(p == 0, 0))
                del up, step
    cfg = params.cfg
    prompt = serve.random_prompt(cfg, run["batch"], run["prompt"], seed=SEED, device=device)
    extra = serve.model_inputs(cfg, run["batch"], dtype=torch.bfloat16, seed=SEED + 1,
                               device=device)
    with torch.inference_mode():
        logits, _ = lm.make_prefill_step(run["prompt"] + run["tokens"])(
            params, {"tokens": prompt, **extra})
    return (logits.float().cpu() - want).abs().max().item()


def _divergence(got, want) -> list:
    """Each row's first step at which two token sequences differ (None if
    they never do)."""
    out = []
    for a, b in zip(got.tolist(), want.tolist()):
        out.append(next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None))
    return out


def _launch_line(launches: list) -> str:
    """Each rank's launch counts, runs of equal ones joined."""
    out = []
    for r, d in enumerate(launches):
        if out and out[-1][1] == d:
            out[-1][0].append(r)
        else:
            out.append(([r], d))
    return "; ".join(f"ranks {rs[0]}-{rs[-1]} {d}" if len(rs) > 1 else f"rank {rs[0]} {d}"
                     for rs, d in out)


def _check_sharded(torch, run: dict, ranks: list, want: dict, checked: dict) -> None:
    """Phase 6b's checks of one run (``ranks``: each rank's result):
    every rank's logits and tokens the same, its flash launches the
    unsharded count, its flash forms checked in phase 3 at the run's dtype,
    and the logits and tokens against the unsharded model's (``want``,
    with ``floor`` for bfloat16; None where it cannot run)."""
    from repro_torch.models import lm

    cfg = _sharded_config(run)
    label, dtype = run["label"], run["dtype"]
    r0 = ranks[0]
    for r in ranks[1:]:   # activations replicated over the model axis
        require(torch.equal(r["logits"], r0["logits"]) and torch.equal(r["tokens"], r0["tokens"]),
                f"{label}: rank {r['rank']}'s logits or tokens differ from rank 0's")
    # each rank launches the unsharded model's kernels, on its heads (none
    # where it holds no query head)
    def launches_of(r):
        model = _model_of(r)
        return {k: n for k in ("flash_attention", "wkv")
                if (n := kernel_calls(cfg, k, True, model)
                    + (run["tokens"] - 1) * kernel_calls(cfg, k, False, model))}

    for r in ranks:
        expected = launches_of(r)
        require(r["launches"] == expected,
                f"{label}: rank {r['rank']} launched {r['launches']}, expected {expected}")
        require(len(r["forms"]) == expected.get("flash_attention", 0),
                f"{label}: {len(r['forms'])} flash calls recorded")
        require_checked(label, r["forms"], checked[dtype])
    require(bool(torch.isfinite(r0["logits"]).all()), f"{label}: non-finite logits")
    require(int(r0["tokens"].min()) >= 0 and int(r0["tokens"].max()) < cfg.vocab_padded,
            f"{label}: tokens out of range")
    shared = " (the ranks time-slice one card)" if len({r["device"] for r in ranks}) == 1 else ""
    log("tp", f"{label}: ranks {[r['device'] for r in ranks]} over {r0['backend']}, "
        f"{r0['params'] / 1e9:.3f} B parameters a rank, drawn in "
        f"{[round(r['init_s'], 2) for r in ranks]} s (the processes' first CUDA call "
        f"{[round(r['context_s'], 2) for r in ranks]} s); prefill "
        f"{[round(r['prefill_s'], 4) for r in ranks]} s, {run['tokens'] - 1} decode steps "
        f"{[round(r['decode_s'], 4) for r in ranks]} s{shared}; peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; launches by rank "
        f"{_launch_line([r['launches'] for r in ranks])}, each the rank's heads' count, "
        f"{len(set(f for r in ranks for f in r['forms']))} flash forms, each checked in "
        f"phase 3; sample "
        f"{r0['tokens'][0, :8].tolist()}")
    if want is None:
        return
    scale = want["logits"].abs().max().item()
    err = (r0["logits"] - want["logits"]).abs().max().item()
    limit = SHARDED_TOL[dtype] * scale
    floor_note = ""
    if "floor" in want:
        limit = max(limit, want["floor"])
        floor_note = (f", the one-ulp weight floor {want['floor'] / scale:.3e}; limit "
                      f"{limit / scale:.3e}")
    first = r0["tokens"][:, 0] == want["tokens"][:, 0]
    top2 = want["logits"].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    div = _divergence(r0["tokens"], want["tokens"])
    log("tp", f"{label}: against the unsharded model, max|logits difference| {err:.3e} of "
        f"max|logit| {scale:.3f}, relative {err / scale:.3e} ({SHARDED_TOL[dtype]}"
        f"{floor_note}); first tokens equal in {int(first.sum())} of {len(first)} rows "
        f"(top-2 margins {[round(m, 4) for m in margin]}); first divergence by row {div} of "
        f"{run['tokens']}")
    require(err <= limit, f"{label}: logits {err} vs limit {limit} (max|logit| {scale})")
    if dtype == "float32":
        require(torch.equal(r0["tokens"], want["tokens"]), f"{label}: tokens {div}")
    for row, same in enumerate(first.tolist()):
        # a first token may differ only where the two runs' logits, each
        # within err, leave the unsharded top two tied
        require(same or margin[row] <= 2 * err,
                f"{label}: row {row}'s first token differs with margin {margin[row]} > 2 x {err}")


def _unsharded(torch, run: dict, device, served: dict) -> dict:
    """The unsharded model of ``run`` alone on ``device`` (:func:`_serve_run`;
    in bfloat16 with its one-ulp floor), freed before this returns; a
    full-width bfloat16 run of a phase-6 configuration must repeat phase
    6's tokens (``served``)."""
    import gc

    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(_sharded_config(run), seed=SEED, dtype=getattr(torch, run["dtype"]),
                            device=device)
    want = _serve_run(torch, params, run, device)
    same_as = served.get(run["arch"]) if not run["cut"] else None
    repeat = ""
    if same_as is not None and run["dtype"] == "bfloat16" and run["batch"] == LM_BATCH:
        require(torch.equal(want["tokens"], same_as["tokens"]),
                f"{run['label']}: the unsharded model does not repeat phase 6's tokens")
        moved = (want["logits"] - same_as["logits"]).abs().max().item()
        repeat = f", phase 6's tokens repeated (its logits to {moved:.3e})"
    if run["dtype"] == "bfloat16":
        want["floor"] = _ulp_floor(torch, params, run, device, want["logits"])
    log("tp", f"{run['label']}: the unsharded model alone, "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters, peak "
        f"{want['peak_gib']:.1f} GiB, prefill {want['prefill_s']:.4f} s, decode "
        f"{want['decode_s']:.4f} s ({time.perf_counter() - t0:.1f} s in all){repeat}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return want


def phase_sharded_serving(torch, device, served: dict, checked: dict, *,
                          one_card: bool = True) -> dict:
    """Phase 6b: SHARDED_RUNS over ranks sharing the card through gloo
    (``run_ranks``, one spawn a mesh), each against the unsharded model on
    the card, run alone in this process first and freed before the ranks
    start.  Then SHARDED_4CARD over NCCL where there are four cards, or one
    line saying it was not made (``one_card=False``: only that).  Returns
    each run's rank-0 launch counts."""
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    launches, wants = {}, {}
    card = f"cuda:{torch.cuda.current_device()}"
    meshes = sorted({run["mesh"] for run in SHARDED_RUNS}, reverse=True) if one_card else []
    for mesh in meshes:
        runs = [run for run in SHARDED_RUNS if run["mesh"] == mesh]
        for run in runs:
            wants[run["label"]] = _unsharded(torch, run, device, served)
        n = mesh[0] * mesh[1]
        log("tp", f"mesh {mesh}: starting {n} ranks; {memory(torch)}")
        t0 = time.perf_counter()
        results = run_ranks(_sharded_rank, n, runs, backend="gloo", devices=[card] * n,
                            timeout=SHARDED_TIMEOUT_S)
        log("tp", f"mesh {mesh}: {n} ranks on {card} served {len(runs)} runs in "
            f"{time.perf_counter() - t0:.1f} s (spawn, init, serve); the ranks' peak host "
            f"memory {[round(r[-1]['host_gib'], 1) for r in results]} GiB resident")
        for i, run in enumerate(runs):
            _check_sharded(torch, run, [res[i] for res in results], wants[run["label"]], checked)
            launches[run["label"]] = results[0][i]["launches"]
    cards = torch.cuda.device_count()
    if cards >= 4:
        for run in SHARDED_4CARD:   # compared where the unsharded model fits one card
            if run["cut"] and run["label"] not in wants:
                wants[run["label"]] = _unsharded(torch, run, device, served)
        t0 = time.perf_counter()
        results = run_ranks(_sharded_rank, 4, list(SHARDED_4CARD), backend="nccl",
                            devices=[f"cuda:{i}" for i in range(4)], timeout=SHARDED_TIMEOUT_S)
        log("tp", f"four cards over NCCL: {len(SHARDED_4CARD)} runs in "
            f"{time.perf_counter() - t0:.1f} s (spawn, init, serve)")
        for i, run in enumerate(SHARDED_4CARD):
            _check_sharded(torch, {**run, "label": f"{run['label']} (NCCL, four cards)"},
                           [res[i] for res in results], wants.get(run["label"]), checked)
            launches[f"{run['label']} (NCCL, four cards)"] = results[0][i]["launches"]
    else:
        log("tp", f"{SHARDED_4CARD[-1]['label']}: not run: it needs four cards, this machine "
            f"has {cards}")
    log("tp", f"phase 6b took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _teacher_forced(torch, params, prompt, teacher, extra):
    """Last-position logits of a prefill and one decode step per teacher token."""
    from repro_torch.models import lm

    B, S = prompt.shape
    out = []
    with torch.inference_mode():
        logits, cache = lm.make_prefill_step(max_len=S + teacher.shape[1])(
            params, {"tokens": prompt, **extra})
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


class _RouteLog:
    """Records the experts each MoE ``route`` call chooses (phase 7)."""

    def __init__(self, moe_module):
        self.module, self.choices = moe_module, []
        self.route = moe_module.route

    def __enter__(self):
        def logged(*args, **kwargs):
            out = self.route(*args, **kwargs)
            self.choices.append(out[2].cpu())
            return out

        self.module.route = logged
        return self

    def __exit__(self, *exc):
        self.module.route = self.route


class _RouteForce(_RouteLog):
    """Makes each MoE ``route`` call take the experts the unsharded run
    chose (``choices``, one per call in call order, rows ``rows`` of them:
    this rank's), their weights the gates of those experts renormalised as
    ``route`` does, instead of its own top-k; counts the calls, the
    choices that differ from its own and the largest gate gap between a
    choice of its own and the one it takes (phase 10d)."""

    def __init__(self, moe_module, choices: list, rows: slice):
        super().__init__(moe_module)
        self.forced, self.rows = choices, rows
        self.differ = self.total = 0
        self.gap = 0.0

    def __enter__(self):
        import torch

        def forced(params, x, cfg, dtype):
            gates, _, own = self.route(params, x, cfg, dtype)
            i = len(self.choices)
            require(i < len(self.forced), f"route call {i + 1}: the unsharded run made "
                    f"{len(self.forced)}")
            want = self.forced[i][self.rows].to(own.device)
            require(want.shape == own.shape, f"route call {i}: {tuple(own.shape)} choices, the "
                    f"unsharded run's rows {tuple(want.shape)}")
            self.choices.append(own.cpu())
            differ = own != want
            self.differ += int(differ.sum())
            self.total += own.numel()
            if differ.any():
                gap = (gates.gather(-1, own) - gates.gather(-1, want)).abs().max().item()
                self.gap = max(self.gap, gap)
            top_w = gates.gather(-1, want)
            return gates, top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), want

        self.module.route = forced
        return self


def phase_lm_float32(torch, device) -> None:
    """Phase 7: the full-width model in float32 through the kernels on the
    card against the same model through the plain twins on the CPU (the
    newer families with their depth cut, each cut printed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe

    for arch, cut, prompt_len in LM_F32:
        cfg = dataclasses.replace(get_config(arch), **cut)
        kernel = "wkv" if cfg.block_kind == "rwkv6" else "flash_attention"
        params = lm.init_params(cfg, seed=SEED + 1, dtype=torch.float32, device=device)
        prompt = serve.random_prompt(cfg, F32_BATCH, prompt_len, seed=SEED + 1, device=device)
        teacher = serve.random_prompt(cfg, F32_BATCH, F32_DECODE, seed=SEED + 2, device=device)
        extra = serve.model_inputs(cfg, F32_BATCH, dtype=torch.float32, seed=SEED + 4,
                                   device=device)
        _build.reset_launches()
        t0 = time.perf_counter()
        with _RouteLog(moe) as card_routes:
            got = _teacher_forced(torch, params, prompt, teacher, extra).cpu()
        t1 = time.perf_counter()
        expected = kernel_calls(cfg, kernel, True) + F32_DECODE * kernel_calls(cfg, kernel, False)
        require(_build.LAUNCHES[kernel] == expected,
                f"{arch} float32: {dict(_build.LAUNCHES)}, expected {expected} {kernel}")
        floor = (_teacher_forced(torch, _ulp_perturbed(torch, params), prompt, teacher, extra)
                 .cpu() - got).abs().max().item()
        torch.cuda.empty_cache()
        params = params.to("cpu")
        t2 = time.perf_counter()
        with _RouteLog(moe) as cpu_routes:
            want = _teacher_forced(torch, params, prompt.cpu(), teacher.cpu(),
                                   {k: v.cpu() for k, v in extra.items()})
        t3 = time.perf_counter()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        limit = LOGIT_REL_TOL[arch]
        cut_note = f"depth cut {cut}, " if cut else ""
        log("lm32", f"{arch} float32 batch {F32_BATCH}, {cut_note}prompt {prompt_len}, "
            f"{F32_DECODE} teacher-forced steps: max|kernels - plain| = {err:.3e}, "
            f"max|logits| = {scale:.3f}, relative {err / scale:.3e} (limit {limit}); "
            f"one-ulp weight floor {floor / scale:.3e} relative; argmax agreement "
            f"{same:.4f}; {expected} {kernel} launches; card {t1 - t0:.2f} s, "
            f"CPU {t3 - t2:.2f} s")
        if cfg.is_moe:
            pairs = list(zip(card_routes.choices, cpu_routes.choices))
            differ = sum(int((a != b).sum()) for a, b in pairs)
            total = sum(a.numel() for a, _ in pairs)
            log("lm32", f"{arch} float32: {differ} of {total} top-{cfg.top_k} expert "
                f"choices differ between the card and the CPU ({len(pairs)} route calls)")
        require(bool(torch.isfinite(got).all()) and err <= limit * scale,
                f"{arch} float32 logits: {err} vs scale {scale}")
        del params, got, want
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# LM training (phases 3, 8 and 10)
# --------------------------------------------------------------------------


def trained_flash_calls() -> list:
    """(label, form) of every distinct flash call phase 10 makes (the
    backward takes each forward's form), then the zoo's TRAINED_FORMS.
    Phase 10 records its calls and fails on a form phase 3 did not check."""
    import dataclasses

    from repro_torch.configs import get_config

    calls = {}
    runs = [(TRAIN_ARCH, {}, TRAIN_BATCH, TRAIN_SEQ)] + list(TRAIN_F32)
    for arch, cut, batch, seq in runs:
        cfg = dataclasses.replace(get_config(arch), **cut)
        for form, label in model_flash_calls(cfg, batch, 1, seq).items():
            calls.setdefault(form, f"{arch} {label}")
    for label, dims, causal, window in TRAINED_FORMS:
        calls.setdefault(flash_form(dims, causal, window, 0, None), label)
    for label, form in sharded_train_flash_calls():
        calls.setdefault(form, label)
    return [(label, form) for form, label in calls.items()]


def sharded_train_flash_calls(runs=SHARDED_TRAIN + TRAIN_4CARD + SHARED_KV_TRAIN
                              + SHARED_KV_TIMED) -> list:
    """(label, form) of the flash calls a rank of ``runs`` (phase 10d's, the
    four-card training, phase 10f's and the shapes phase 8 times on a
    rank's heads) makes: its rows of the batch on its heads (granite: 16 /
    4 at 2x2, 8 / 2 at 1x4; qwen2-moe: 8 / 8; hd 128; zamba2's shared block
    8 / 8 at 1x4, 16 / 16 at 2x2, hd 112; gemma3 2 / 1 at 1x4, hd 256;
    llama3.2-3b 2 / 1 and 1 / 1 at 1x16, hd 128; gemma3 1 / 1 at 1x16;
    tinyllama 4 / 1 at 2x8, hd 64)."""
    calls = {}
    for run in runs:
        data, model = run["mesh"]
        batch, seq = run["batch"], run["seq"]
        for form, label in model_flash_calls(_sharded_config(run), batch // data, model,
                                             seq).items():
            calls.setdefault(form, f"{run['label']}: a rank's {label}")
    return [(label, form) for form, label in calls.items()]


def flash_bwd_operands(torch, gen, device, form, dtype):
    (B, Sq, Skv, Hq, Hkv, hd), causal, window, q_off, _ = form

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, do = randn(B, Sq, Hq, hd), randn(B, Sq, Hq, hd)
    k, v = randn(B, Skv, Hkv, hd), randn(B, Skv, Hkv, hd)
    return (q, k, v, do), dict(causal=causal, window=window, q_offset=q_off)


def check_flash_bwd(torch, device, errs: dict, calls=None) -> None:
    """Phase 3, the backward: at each of ``calls`` (default
    ``trained_flash_calls``), bfloat16 and float32, the forward kernel's
    lse against the twin's, then dq, dk, dv of two launches (bitwise equal)
    against the plain twin's."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
        flash_attention_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for label, form in calls or trained_flash_calls():
            (q, k, v, do), kw = flash_bwd_operands(torch, gen, device, form, dtype)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            want = flash_attention_bwd_plain(q, k, v, o, do, want_lse, **kw)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(got, want)]
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            log("kernels", f"flash backward {label} {name}: q {tuple(q.shape)} k "
                f"{tuple(k.shape)} {kw}: dq, dk, dv max|kernel - plain| / max|plain| "
                f"{', '.join(f'{r:.2e}' for r in rel)} (limit {FLASH_BWD_TOL[name]}); lse "
                f"{lse_err:.2e} (limit 1e-4); two launches bitwise equal: {same}")
            require(finite and same and max(rel) <= FLASH_BWD_TOL[name] and lse_err <= 1e-4,
                    f"flash backward {label} {name}: {rel}, lse {lse_err}, bitwise {same}")
            errs[dtype].append(err)
            errs["by_case"][(form, dtype)] = err
            del q, k, v, do, o, lse, want_lse, got, again, want
    torch.cuda.empty_cache()


def _loss_drop_run(torch, device, checked: set, arch: str = TRAIN_ARCH) -> dict:
    """Phase 10a (10c for rwkv6): TRAIN_STEPS steps of ``make_train_step``
    on one repeated batch, the launch counts of each step set to 0 just
    before it and read just after, each step's required to be
    ``lm.train_step_launches``."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.roofline import model_flop_utilisation
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule

    cfg = get_config(arch)
    params = lm.init_params(cfg, seed=SEED, dtype=torch.float32, compute_dtype=torch.bfloat16,
                            device=device)
    opt = adamw(cosine_schedule(TRAIN_LR, warmup=2, total=TRAIN_STEPS))
    state = opt.init(dict(params.named_parameters()))
    step = lm.make_train_step(opt)
    batch = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                            torch.Generator(device=device).manual_seed(SEED))
    want = lm.train_step_launches(cfg)
    n_params = sum(p.numel() for p in params.parameters())
    log("train", f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} "
        f"B parameters, float32 masters, bfloat16 compute, remat {cfg.remat}; AdamW, "
        f"cosine_schedule({TRAIN_LR}, warmup=2, total={TRAIN_STEPS}); batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, one batch repeated")
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, counts = [], [], []
    with _FlashLog() as flash_log:
        for i in range(TRAIN_STEPS):
            sync(torch, device)
            _build.reset_launches()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            loss = float(metrics["loss"])          # a sync
            seconds.append(time.perf_counter() - t0)
            counts.append(dict(_build.LAUNCHES))
            losses.append(loss)
            log("train", f"step {i}: loss {loss:.4f}, {seconds[-1]:.3f} s, launches {counts[-1]}")
    require(all(c == want for c in counts), f"{arch} training launches {counts}, "
            f"expected {want} a step")
    require_checked(f"{arch} training", flash_log.forms, checked)
    require(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    require(losses[-1] <= losses[0] - TRAIN_MIN_DROP,
            f"loss fell {losses[0] - losses[-1]:.4f} nat in {TRAIN_STEPS} steps "
            f"(at least {TRAIN_MIN_DROP} required)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = statistics.median(seconds[1:])
    mfu = model_flop_utilisation(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"), warm)
    # the device's share of a warm step: its kernels' device time (torch.profiler,
    # every launch recorded), each WKV backward kernel once a backward launch
    from repro_torch.launch.kernel_times import kernel_times

    traced = kernel_times(lambda: step(params, state, batch), iters=1)
    kernels = traced.ms
    bwd_launches = collections.Counter()
    for name, n in traced.launches.items():
        if name.startswith("wkv_bwd_"):
            bwd_launches[name.split("<")[0]] += n
    require(all(n == want.get("wkv_bwd", 0) for n in bwd_launches.values())
            and len(bwd_launches) == (len(WKV_BWD_KERNELS) if "wkv_bwd" in want else 0),
            f"{arch}: the profiled step ran WKV backward kernels {dict(bwd_launches)}, expected "
            f"{sorted(WKV_BWD_KERNELS)} {want.get('wkv_bwd', 0)} times each")
    busy = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    wkv_bwd_ms = sum(v for k, v in kernels.items() if "wkv_bwd" in k)
    wkv_note = f"WKV backward {wkv_bwd_ms:.1f} ms of the step; " if "wkv_bwd" in want else ""
    log("train", f"{arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {TRAIN_STEPS} steps "
        f"(limit: down {TRAIN_MIN_DROP}); first step {seconds[0]:.3f} s, warm step median "
        f"{warm:.4f} s on the host clock ({TRAIN_BATCH * TRAIN_SEQ / warm:.0f} tok/s, model-FLOP "
        f"utilisation {mfu:.1%} of 989 TFLOP/s); kernels {busy:.4f} s of a profiled step, "
        f"device idle {1 - busy / warm:.1%} (the trace lost {traced.pad_lost} of its padding "
        f"kernels and none of the step's); {wkv_note}peak {peak:.1f} GiB allocated; launches "
        f"a step {counts[-1]}")
    log("train", "largest kernels of a step (ms): " + ", ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    return {"losses": losses, "step_s": warm, "first_s": seconds[0], "peak_gib": peak,
            "idle": 1 - busy / warm, "mfu": mfu, "wkv_bwd_ms": wkv_bwd_ms,
            "launches": counts[-1], "run_launches": {k: sum(c[k] for c in counts) for k in want},
            "device_launches": dict(traced.launches), "busy_s": busy}


def _launcher_steps(torch, arch: str) -> list:
    """TRAIN_LAUNCHER_STEPS steps of ``launch.train.main`` at phase 10's
    batch, a fresh batch each, its launches ``lm.train_step_launches`` a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import lm

    _build.reset_launches()
    t0 = time.perf_counter()
    losses = train.main(["--arch", arch, "--steps", str(TRAIN_LAUNCHER_STEPS), "--batch",
                         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    log("train", f"launch.train.main --arch {arch}: {TRAIN_LAUNCHER_STEPS} steps, a fresh batch "
        f"each, losses {[round(x, 4) for x in losses]} in {time.perf_counter() - t0:.1f} s; "
        f"launches {dict(_build.LAUNCHES)}")
    require(len(losses) == TRAIN_LAUNCHER_STEPS and all(math.isfinite(x) for x in losses),
            f"launch.train {arch} losses {losses}")
    want = {k: n * TRAIN_LAUNCHER_STEPS for k, n in lm.train_step_launches(get_config(arch)).items()}
    require(dict(_build.LAUNCHES) == want, f"launch.train {arch} launches {dict(_build.LAUNCHES)}")
    torch.cuda.empty_cache()
    return losses


def _same_seed_steps(torch, device) -> dict:
    """Phase 10a: two fresh same-seed steps of ``make_train_step`` at full
    width (phase 10a's model, optimizer and batch shape), run twice: the
    losses and every parameter bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule

    cfg = get_config(TRAIN_ARCH)

    def run():
        params = lm.init_params(cfg, seed=SEED + 3, dtype=torch.float32,
                                compute_dtype=torch.bfloat16, device=device)
        opt = adamw(cosine_schedule(TRAIN_LR, warmup=2, total=TRAIN_STEPS))
        state = opt.init(dict(params.named_parameters()))
        step = lm.make_train_step(opt)
        batch = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                torch.Generator(device=device).manual_seed(SEED + 3))
        losses = []
        for _ in range(2):
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
        del params, state, batch
        torch.cuda.empty_cache()
        return losses, flat

    t0 = time.perf_counter()
    (la, fa), (lb, fb) = run(), run()
    same = la == lb and torch.equal(fa, fb)
    differ = int((fa != fb).sum())
    log("train", f"{TRAIN_ARCH}: two fresh same-seed steps, twice: losses {la} and {lb}; "
        f"{differ} of {fa.numel()} parameters differ; bitwise equal: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(same, f"two same-seed train steps differ: losses {la} / {lb}, {differ} parameters")
    del fa, fb
    torch.cuda.empty_cache()
    return {"losses": la, "bitwise": same}


def _worst_leaf(grads: dict, want: dict) -> tuple[float, str]:
    """The largest max|g - want| / max|want| over the leaves, and its leaf."""
    worst, worst_name = 0.0, ""
    for name, g in want.items():
        scale = g.abs().max().item()
        rel = (grads[name] - g).abs().max().item() / (scale if scale > 0 else 1.0)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def phase_lm_training(torch, device, checked: set) -> dict:
    """Phase 10: (a) tinyllama-1.1b training at full width, then the
    launcher; (b) whole-model float32 gradients, card against CPU; (c)
    rwkv6-1.6b training at full width, then the launcher."""
    import dataclasses

    from repro_torch._device import float32_math
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm, moe

    t_phase = time.perf_counter()
    out = _loss_drop_run(torch, device, checked)
    torch.cuda.empty_cache()
    out["repeat"] = _same_seed_steps(torch, device)
    _launcher_steps(torch, TRAIN_ARCH)

    # (b) whole-model float32 gradients: kernels on the card, twins on the CPU
    for arch, cut, batch_size, seq in TRAIN_F32:
        cfg = dataclasses.replace(get_config(arch), **cut)
        params = lm.init_params(cfg, seed=SEED + 2, dtype=torch.float32, device=device)
        batch = synthetic_batch(cfg, batch_size, seq,
                                torch.Generator(device=device).manual_seed(SEED + 2))
        _build.reset_launches()
        t0 = time.perf_counter()
        with float32_math(), _FlashLog() as flash_log, _RouteLog(moe) as card_routes:
            loss, grads = lm.value_and_grad(params, batch)
            sync(torch, device)
        t1 = time.perf_counter()
        launches = dict(_build.LAUNCHES)
        require(launches == lm.train_step_launches(cfg),
                f"{arch} float32 gradients: launches {launches}, expected "
                f"{lm.train_step_launches(cfg)}")
        require_checked(f"{arch} float32 training", flash_log.forms, checked)
        grads = {n: g.cpu() for n, g in grads.items()}
        params = params.to("cpu")
        batch = {k: v.cpu() for k, v in batch.items()}
        t2 = time.perf_counter()
        with _RouteLog(moe) as cpu_routes:
            want_loss, want = lm.value_and_grad(params, batch)
        t3 = time.perf_counter()
        worst, worst_name = _worst_leaf(grads, want)
        loss_rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        floor = ""
        if cfg.block_kind == "rwkv6":
            # how far the CPU twin's own gradients move when every weight
            # moves by one float32 ulp (phase 7's floor, for gradients)
            _, moved = lm.value_and_grad(_ulp_perturbed(torch, params), batch)
            ulp, ulp_name = _worst_leaf(moved, want)
            floor = f"; one-ulp weight floor (CPU) {ulp:.3e} (leaf {ulp_name})"
        log("train32", f"{arch} float32, depth cut {cut}, batch {batch_size} x {seq}: loss card "
            f"{loss.item():.6f} CPU {want_loss.item():.6f} (relative {loss_rel:.2e}); worst "
            f"gradient leaf {worst_name}: {worst:.3e} of its max |g| (limit {GRAD_REL_TOL}) over "
            f"{len(want)} leaves{floor}; launches {launches}; card {t1 - t0:.2f} s, CPU "
            f"{t3 - t2:.2f} s")
        if cfg.is_moe:
            pairs = list(zip(card_routes.choices, cpu_routes.choices))
            differ = sum(int((a != b).sum()) for a, b in pairs)
            total = sum(a.numel() for a, _ in pairs)
            log("train32", f"{arch} float32: {differ} of {total} top-{cfg.top_k} expert choices "
                f"differ between the card and the CPU ({len(pairs)} route calls, remat included)")
        require(math.isfinite(loss.item()) and loss_rel <= GRAD_REL_TOL and worst <= GRAD_REL_TOL,
                f"{arch} float32 gradients: loss {loss_rel}, worst leaf {worst_name} {worst}")
        if cfg.block_kind == "rwkv6":
            for name in want:
                if name.rsplit(".", 1)[-1] in ("w_base", "w_A", "w_B", "u"):
                    require(grads[name].abs().max().item() > 0,
                            f"{arch}: the decay / bonus leaf {name} has a zero gradient")
        del params, grads, want, batch
        torch.cuda.empty_cache()

    # (c) rwkv6-1.6b at full width and depth through the WKV kernels
    out["rwkv"] = _loss_drop_run(torch, device, checked, RWKV_TRAIN_ARCH)
    torch.cuda.empty_cache()
    _launcher_steps(torch, RWKV_TRAIN_ARCH)
    log("train", f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 10e: launch/step_costs.py's count of phase 10's steps.  A counted
# peak more than 25% below the measured one fails (an undercount is what
# hid gemma3-4b's float32 logits); the device kernel each counted launch
# runs exactly once (phase 10's profiled step); the phase's budget.
COUNT_PEAK_FLOOR = 0.75
COUNTED_KERNEL = {"flash_attention": "flash_fwd_tc", "flash_attention_bwd": "flash_bwd_dq_tc",
                  "wkv": "wkv_scan", "wkv_bwd": "wkv_bwd_du"}
COUNT_BUDGET_S = 30.0


def counted_step(cfg, batch: int, seq: int, sizes: dict, scheme: str) -> dict:
    """launch/step_costs.py's count of one rank's train step of ``cfg`` at
    ``batch`` x ``seq`` (bfloat16 compute, float32 masters: the card's
    policy), with its roofline's three terms (``launch/roofline.py``: the
    H100 figures, NVLink or InfiniBand by the rank's groups)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import roofline, step_costs

    shape = InputShape("train", seq, batch, "train")
    counted = step_costs.count_step(cfg, shape, sizes, scheme)
    report = roofline.build_report(
        arch=cfg.name, shape_name="train", mesh_name="x".join(map(str, sizes.values())),
        n_chips=math.prod(sizes.values()), counted=counted, cfg=cfg, shape=shape,
        links={a: roofline.link_bw(sizes, a) for a in sizes})
    counted["terms"] = {k: getattr(report, k) for k in ("compute_s", "memory_s", "collective_s")}
    return counted


def _counted_line(counted: dict, peak_gib: float) -> str:
    t = counted["terms"]
    return (f"counted peak {counted['peak_bytes'] / 2**30:.2f} GiB against {peak_gib:.2f} GiB "
            f"measured ({counted['peak_bytes'] / 2**30 / peak_gib:.1%}); compute "
            f"{t['compute_s'] * 1e3:.1f} ms, memory {t['memory_s'] * 1e3:.1f} ms, collective "
            f"{t['collective_s'] * 1e3:.1f} ms at the H100 data sheet's rates "
            f"({counted['flops']:.4e} flops, {counted['bytes']:.4e} bytes; counted in "
            f"{counted['count_s']:.1f} s)")


def phase_counted_training(torch, training: dict) -> dict:
    """Phase 10e: the dry run's count (launch/step_costs.py: the step run on
    meta tensors, no card) of phase 10's two train steps, tinyllama-1.1b and
    rwkv6-1.6b at TRAIN_BATCH x TRAIN_SEQ on one card, beside what phase 10
    measured of them, adding no step on the card: the counted kernel
    launches must equal the wrappers' and the profiler's device launches
    exactly (COUNTED_KERNEL), the counted peak must be at least
    COUNT_PEAK_FLOOR of max_memory_allocated, and the compute and memory
    terms stand beside the warm step's seconds."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {}
    for arch, run in ((TRAIN_ARCH, training), (RWKV_TRAIN_ARCH, training["rwkv"])):
        counted = counted_step(get_config(arch), TRAIN_BATCH, TRAIN_SEQ,
                               {"data": 1, "model": 1}, "fsdp_tp")
        launches = {k: v["launches"] for k, v in counted["kernels"].items()}
        device = {k: sum(n for name, n in run["device_launches"].items()
                         if name.split("<")[0] == COUNTED_KERNEL[k]) for k in launches}
        t = counted["terms"]
        log("count", f"{arch} train step {TRAIN_BATCH} x {TRAIN_SEQ} on one card: counted "
            f"launches {launches}, the wrappers' {run['launches']}, the profiler's device "
            f"launches {device}; {_counted_line(counted, run['peak_gib'])}; the warm step "
            f"{run['step_s'] * 1e3:.1f} ms on the host clock, its kernels "
            f"{run['busy_s'] * 1e3:.1f} ms (compute + memory terms "
            f"{(t['compute_s'] + t['memory_s']) / run['step_s']:.1%} of the warm step)")
        require(launches == run["launches"] == device,
                f"{arch}: counted launches {launches}, the wrappers' {run['launches']}, the "
                f"profiler's {device}")
        require(counted["peak_bytes"] / 2**30 >= COUNT_PEAK_FLOOR * run["peak_gib"],
                f"{arch}: counted peak {counted['peak_bytes'] / 2**30:.2f} GiB is more than "
                f"{1 - COUNT_PEAK_FLOOR:.0%} below the measured {run['peak_gib']:.2f} GiB")
        out[arch] = {"launches": launches, "device_launches": device,
                     "peak_gib": counted["peak_bytes"] / 2**30,
                     "measured_peak_gib": run["peak_gib"], "step_s": run["step_s"],
                     "kernels_s": run["busy_s"], **t}
    seconds = time.perf_counter() - t0
    log("count", f"phase 10e took {seconds:.1f} s (budget {COUNT_BUDGET_S:.0f} s)")
    require(seconds <= COUNT_BUDGET_S, f"phase 10e took {seconds:.1f} s")
    return out


def _sharded_train_schedule():
    from repro_torch.optim import cosine_schedule

    return cosine_schedule(5e-5, warmup=10, total=100)


def _sharded_train_opt():
    """Phase 10d's optimizer: the LM tests' AdamW (cosine_schedule(5e-5,
    warmup=10, total=100), weight decay 0.1; a first rate of 5e-6)."""
    from repro_torch.optim import adamw

    return adamw(_sharded_train_schedule(), b1=ADAM_B1, weight_decay=0.1)


ADAM_B1 = 0.9   # from zero moments a step's m is (1 - b1) g: its gradient


def _zero_moments(torch, params) -> dict:
    """AdamW's initial state of ``params``: opt.init's values, the moments
    zeros held as broadcast views of one element (no bytes a leaf)."""
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {n: zero.expand(p.shape) for n, p in named.items()},
            "v": {n: zero.expand(p.shape) for n, p in named.items()}}


def _sharded_train_batch(torch, run: dict, cfg, device) -> dict:
    from repro_torch.launch.train import synthetic_batch

    return synthetic_batch(cfg, run["batch"], run["seq"],
                           torch.Generator(device=device).manual_seed(SEED))


def _train_step_read(torch, params, batch, routes=None, on_state=None) -> tuple:
    """One ``make_train_step`` of phase 10d's optimizer from zero moments,
    under float32_math, with every MoE route recorded by ``routes`` (a
    :class:`_RouteLog` by default): (loss, the step's gradients read back
    from its first moment, its second moment, the route log).  The state
    the step made goes to ``on_state`` (if given) before its first moment
    is read back in place."""
    from repro_torch._device import float32_math
    from repro_torch.models import lm, moe

    with float32_math(), routes or _RouteLog(moe) as routes:
        params, state, metrics = lm.make_train_step(_sharded_train_opt())(
            params, _zero_moments(torch, params), batch)
        if on_state is not None:
            on_state(state)
        grads = {n: m.div_(1 - ADAM_B1) for n, m in state["m"].items()}
    return metrics["loss"].item(), grads, state["v"], routes


def _unsharded_step(torch, run: dict, device, path: str) -> dict:
    """Phase 10d's yardstick: one ``make_train_step`` of the unsharded
    model of ``run`` alone on the card (:func:`_train_step_read`); its
    gradients saved to ``path`` on the host (the ranks map it), the model
    freed before this returns.  Its MoE route choices (the ranks take
    them), each leaf's max |g| and its gradient limit in absolute terms
    (``delta``, for the ranks' windows).  With the run's ``floor``, also the
    gradients of the model again after every weight moves by one float32
    ulp (:func:`_ulp_perturbed`): the largest leaf's move, relative to its
    max |g|, and the gradient limit is it where it exceeds
    SHARDED_TRAIN_TOL's."""
    import gc

    from repro_torch._device import float32_math
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cfg = _sharded_config(run)
    params = lm.init_params(cfg, seed=SEED, dtype=torch.float32, device=device)
    batch = _sharded_train_batch(torch, run, cfg, device)
    floor = None
    if run.get("floor"):
        with float32_math():
            _, g0 = lm.value_and_grad(params, batch)
            _, g1 = lm.value_and_grad(_ulp_perturbed(torch, params), batch)
        floor = max(((g1[n] - g).abs().max() / g.abs().max()).item() for n, g in g0.items())
        del g0, g1
    torch.cuda.reset_peak_memory_stats(device)
    loss, grads, v, routes = _train_step_read(torch, params, batch)
    n_params = sum(p.numel() for p in params.parameters())
    del params, v
    host = {n: g.cpu() for n, g in grads.items()}
    want = {"loss": loss, "path": path, "routes": routes.choices, "floor": floor,
            "gmax": {n: g.abs().max().item() for n, g in grads.items()}}
    limit = max(SHARDED_TRAIN_TOL["grad"], floor or 0.0)
    want["delta"] = {n: limit * g for n, g in want["gmax"].items()}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    del grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    need = sum(t.numel() * t.element_size() for t in host.values())
    free = shutil.disk_usage(Path(path).parent).free
    require(free > need, f"{run['label']}: {need / 2**30:.1f} GiB of reference to save, "
            f"{free / 2**30:.1f} GiB free under {Path(path).parent}")
    torch.save(host, path)
    log("train-tp", f"{run['label']}: the unsharded step alone, {n_params / 1e9:.3f} B "
        f"parameters, loss {loss:.6f}, {len(routes.choices)} MoE route calls, "
        + ("" if floor is None else f"one-ulp weight floor {floor:.3e} of a leaf's max |g|, ")
        + f"peak {peak:.1f} GiB allocated; "
        f"{t1 - t0:.1f} s; {need / 2**30:.1f} GiB of gradients saved for the ranks "
        f"({free / 2**30:.0f} GiB were free) in {time.perf_counter() - t1:.1f} s")
    return want


def _digest(torch, t) -> tuple:
    """Three exact integer sums of ``t``'s bits (plain, squared, weighted by
    position), a chunk at a time: equal tensors give equal digests, and two
    that differ in any bit all but surely do not."""
    flat = t.detach().contiguous().view(-1).view(torch.int32)
    sums = [0, 0, 0]
    for start in range(0, flat.numel(), 1 << 24):
        b = flat[start:start + (1 << 24)].to(torch.int64)
        pos = torch.arange(start, start + b.numel(), device=b.device)
        sums = [sums[0] + int(b.sum()), sums[1] + int((b * b).sum()),
                sums[2] + int((b * pos).sum())]
    return tuple(sums)


def _first_step_window(torch, opt, p, g, delta: float) -> dict:
    """Where one step of AdamW ``opt`` from zero moments puts ``p``, and
    its v, when the gradient lies within ``delta`` of ``g``: {"p": (lo,
    hi), "v": (lo, hi), "mid": the step of ``g`` itself, "open": the
    elements with |g| <= delta}.  From zero moments the update is monotone
    in g and v grows with |g|, so the steps of the window's ends bound
    both, each widened by two float32 ulps (and 1e-11, the update's own
    rounding).  tests/_torch_tp_ranks.py's ``first_step_windows``, a leaf
    at a time."""
    from repro_torch.optim import apply_updates

    zero = torch.zeros((), dtype=torch.float32, device=p.device).expand(p.shape)

    def step(grad):
        state = {"step": torch.zeros((), dtype=torch.int32, device=p.device),
                 "m": {"w": zero}, "v": {"w": zero}}
        updates, state = opt.update({"w": grad}, state, {"w": p})
        return apply_updates({"w": p}, updates)["w"], state["v"]["w"]

    def widen(a, b, floor):
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        pad = torch.maximum(lo.abs(), hi.abs()).mul_(2.0 ** -22).add_(floor)
        return lo.sub_(pad), hi.add_(pad)

    out = {"p": widen(step(g - delta)[0], step(g + delta)[0], 1e-11),
           "v": widen(step((g.abs() - delta).clamp_(min=0.0))[1], step(g.abs() + delta)[1], 0.0),
           "mid": step(g)[0], "open": int((g.abs() <= delta).sum())}
    return out


STEP_CHECK_CHUNK = 1 << 24   # elements of a leaf a window is formed over at once


def _outside(x, window) -> float:
    """How far the farthest element of ``x`` lies outside ``window``."""
    lo, hi = window
    return max((lo - x).clamp_(min=0.0).max().item(), (x - hi).clamp_(min=0.0).max().item())


class _RssGrowth:
    """How far this process's resident set grows over a block, bytes: its
    peak, sampled every 10 ms from ``/proc/self/statm`` (mapped file pages
    count), less its size on entry (``growth``); and the growth of
    ``getrusage``'s peak (``ru_growth``: 0 where an earlier peak was
    higher)."""

    def _now(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    @staticmethod
    def _ru() -> int:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._now())

    def __enter__(self):
        import threading

        self.start = self.peak = self._now()
        self._ru0 = self._ru()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._now())
        self.growth, self.ru_growth = self.peak - self.start, self._ru() - self._ru0


def _state_digests(torch, params, state) -> dict:
    """:func:`_digest` of every parameter piece, AdamW moment piece and the step."""
    out = {("params", n): _digest(torch, p) for n, p in params.named_parameters()}
    out.update({(k, n): _digest(torch, t) for k in ("m", "v") for n, t in state[k].items()})
    out["step"] = int(state["step"])
    return out


def _ckpt_round_trip(torch, params, state, plan, mesh, path, device) -> dict:
    """On every rank of a phase 10d run, after its first step (``params``,
    ``state``): ``ckpt.save_sharded`` into ``path``, then
    ``ckpt.restore_sharded`` into a fresh model and state.  The digests of
    the state saved and of the state restored (each rank's slices of the
    file: equal on every rank, the file is the ranks' pieces put
    together; a step from equal states repeats bit for bit, phase 10a);
    the save's and the restore's seconds and peak RSS growth, the file's
    bytes.  The directory is removed."""
    import torch.distributed as dist

    from repro_torch import ckpt

    cfg, saved = params.cfg, _state_digests(torch, params, state)
    torch.cuda.synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    with _RssGrowth() as save_rss:
        ckpt.save_sharded(path, params, state, plan, mesh, step=int(state["step"]))
    save_s = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    with _RssGrowth() as restore_rss:
        model, st, meta = ckpt.restore_sharded(path, cfg, plan, mesh, device=device)
        torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    restored = _state_digests(torch, model, st)
    nbytes = (Path(path) / "arrays.npz").stat().st_size
    del model, st
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(path)
    return {"saved": saved, "restored": restored, "meta_step": meta["step"],
            "bytes": nbytes, "save_s": save_s,
            "save_rss": (save_rss.growth, save_rss.ru_growth), "restore_s": restore_s,
            "restore_rss": (restore_rss.growth, restore_rss.ru_growth)}


def _sharded_train_rank(runs: list, paths: list, deltas: list, choices: list,
                        wave=None) -> list:
    """One rank of phase 10d, in its own process (``run_ranks`` joined the
    process group and set its card), each run freed before the next, on
    its mesh: the runs of the spawn's mesh first; for a run on a smaller
    mesh every rank leaves the process group and the first ones join a new
    one of that size (over a file store beside ``paths``), the others
    taking no further part (None for each of their runs).  The
    rank's shard drawn by ``init_params_sharded`` (seed as the unsharded
    model; in waves of ``wave`` ranks, :func:`_in_waves`) takes one ``make_train_step`` on its rows
    (:func:`_train_step_read`), its launch counts set to 0 just before and
    read just after; its MoE blocks take the unsharded run's expert
    choices for its rows (``choices``, :class:`_RouteForce`).  Held
    against the unsharded step's gradients
    (``paths``, mapped, each leaf's slice read alone): each leaf piece's
    largest gradient difference; how far its parameters after the step,
    and its v, lie outside the window that the step allows a gradient
    within ``deltas`` of the unsharded one (:func:`_first_step_window`;
    AdamW is elementwise), with the elements whose sign that leaves open
    and the largest difference of the others from the step of the
    unsharded gradient itself; and a digest of each piece, for the ranks
    that hold the same one."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import axis_coords, make_mesh
    from repro_torch.models import moe

    for name in ("flash_attention", "flash_attention_bwd", "wkv", "wkv_bwd"):   # phase 2's
        require(_build.library_path(name).exists(),
                f"rank {dist.get_rank()}: {name} was not built by phase 2")
    device = torch.device("cuda", torch.cuda.current_device())
    rank, shape, mesh = dist.get_rank(), None, None
    out = []
    for run, path, delta, chosen in zip(runs, paths, deltas, choices):
        if run["mesh"] != shape:
            shape, size = run["mesh"], run["mesh"][0] * run["mesh"][1]
            if size != dist.get_world_size():   # a smaller mesh: a process group of its own
                dist.destroy_process_group()
                if rank >= size:
                    out += [None] * (len(runs) - len(out))
                    return out
                store = Path(path).parent / f"store_{shape[0]}x{shape[1]}"
                dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                        world_size=size)
            mesh = make_mesh(*shape, device_type="cuda")
            coords = axis_coords(mesh)
        cfg = _sharded_config(run)
        plan = sharding.plan_for(cfg, run["scheme"])
        t0 = time.perf_counter()
        params = _in_waves(torch, device, wave, lambda: sharding.init_params_sharded(
            cfg, plan, mesh, seed=SEED, dtype=torch.float32, device=device))
        # the step's start kept on the host: four ranks of qwen2-moe 2x2
        # share the card, and with a second copy of each rank's 3.3 GiB of
        # parameters on it a rank's check once found 0.37 GiB of its 79 GiB
        # free for a 0.58 GiB leaf (H100 80GB HBM3)
        start = {n: p.detach().to("cpu", copy=True) for n, p in params.named_parameters()}
        batch = sharding.local_batch(cfg, _sharded_train_batch(torch, run, cfg, device), mesh)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t1 = time.perf_counter()
        rows = run["batch"] // run["mesh"][0]
        rows = slice(coords["data"][0] * rows, (coords["data"][0] + 1) * rows)
        kept = {}   # the step's state, for the checkpoint's round trip

        def keep(state):
            if run.get("ckpt"):
                kept.update(step=state["step"], v=state["v"],
                            m={n: m.clone() for n, m in state["m"].items()})

        _build.reset_launches()
        with _FlashLog() as flash_log:
            loss, grads, v, routes = _train_step_read(torch, params, batch,
                                                      _RouteForce(moe, chosen, rows), keep)
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        launches = dict(_build.LAUNCHES)
        ref = torch.load(path, mmap=True, weights_only=True)
        opt = _sharded_train_opt()
        named = dict(params.named_parameters())
        grad_err, step_err = {}, {}
        for n, g in grads.items():
            want = sharding.local_slice(ref[n], plan[n], coords,
                                        sharding.model_parts(cfg, n)).to(device)
            err = {"p": 0.0, "v": 0.0, "open": 0, "settled": 0.0, "elements": want.numel()}
            flat = [t.detach().reshape(-1) for t in (start[n], g, want, named[n], v[n])]
            grad_err[n] = 0.0
            for at in range(0, want.numel(), STEP_CHECK_CHUNK):   # temporaries a chunk long
                p0, g1, g_ref, p1, v1 = (t[at:at + STEP_CHECK_CHUNK] for t in flat)
                p0 = p0.to(device)
                grad_err[n] = max(grad_err[n], (g1 - g_ref).abs().max().item())
                win = _first_step_window(torch, opt, p0, g_ref, delta[n])
                settled = (p1 - win["mid"]).abs().mul_(g_ref.abs() > delta[n]).max().item()
                err = {"p": max(err["p"], _outside(p1, win["p"])),
                       "v": max(err["v"], _outside(v1, win["v"])),
                       "open": err["open"] + win["open"],
                       "settled": max(err["settled"], settled), "elements": err["elements"]}
                del win
            step_err[n] = err
            del want, flat
        out.append({
            "rank": dist.get_rank(), "coords": coords, "loss": loss,
            "grad_err": grad_err, "step_err": step_err,
            "grad_digest": {n: _digest(torch, g) for n, g in grads.items()},
            "param_digest": {n: _digest(torch, p) for n, p in named.items()},
            "launches": launches, "forms": flash_log.forms,
            "routes": {"calls": len(routes.choices), "differ": routes.differ,
                       "total": routes.total, "gap": routes.gap},
            "init_s": t1 - t0, "step_s": t2 - t1,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved(device) / 2**30,
            "params": sum(p.numel() for p in named.values())})
        if kept:
            grads = None
            out[-1]["ckpt"] = _ckpt_round_trip(torch, params, kept, plan, mesh,
                                               Path(path).parent / "ckpt", device)
        del params, named, start, grads, v, batch, ref, kept
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _check_sharded_train(torch, run: dict, ranks: list, want: dict, checked: set) -> None:
    """Phase 10d's checks of one run against the unsharded step: the loss;
    every gradient leaf within the limit of its max |g|; each parameter
    after the step, and its v, inside the step's window; for a MoE model,
    every rank's route calls as many as the unsharded run's and each
    expert choice of its own that differs from the one it took a tie; every
    piece two ranks hold bit for bit; the launches and flash forms of every
    rank."""
    from repro_torch import sharding
    from repro_torch.models import lm

    cfg = _sharded_config(run)
    label, tol = run["label"], dict(SHARDED_TRAIN_TOL)
    if want["floor"] is not None:   # the gradient limit or the floor, whichever is larger
        tol["grad"] = max(tol["grad"], want["floor"])
    plan = sharding.plan_for(cfg, run["scheme"])
    shapes = {n: tuple(p.shape) for n, p in sharding.meta_params(cfg).items()}
    for r in ranks:
        expected = lm.train_step_launches(cfg, _model_of(r))   # the rank's heads'
        require(r["loss"] == ranks[0]["loss"],
                f"{label}: rank {r['rank']}'s loss differs from rank 0's")
        require(r["launches"] == expected,
                f"{label}: rank {r['rank']} launched {r['launches']}, expected {expected}")
        require_checked(label, r["forms"], checked)
    loss_rel = abs(ranks[0]["loss"] - want["loss"]) / abs(want["loss"])
    worst_g = max((max(r["grad_err"][n] for r in ranks) / (want["gmax"][n] or 1.0), n)
                  for n in want["gmax"])
    worst_p = max((max(r["step_err"][n]["p"] for r in ranks), n) for n in want["gmax"])
    worst_v = max((max(r["step_err"][n]["v"] for r in ranks), n) for n in want["gmax"])
    settled = max((max(r["step_err"][n]["settled"] for r in ranks), n) for n in want["gmax"])
    n_open = sum(r["step_err"][n]["open"] for r in ranks for n in want["gmax"])
    n_all = sum(r["step_err"][n]["elements"] for r in ranks for n in want["gmax"])
    lr = float(_sharded_train_schedule()(torch.ones(())))
    routing = ""
    if want["routes"]:
        for r in ranks:
            require(r["routes"]["calls"] == len(want["routes"]),
                    f"{label}: rank {r['rank']} routed {r['routes']['calls']} times, the "
                    f"unsharded run {len(want['routes'])}")
        differ = sum(r["routes"]["differ"] for r in ranks)
        total = sum(r["routes"]["total"] for r in ranks)
        gap = max(r["routes"]["gap"] for r in ranks)
        routing = (f"; the ranks took the unsharded run's top-{cfg.top_k} expert choices: "
                   f"{differ} of their own {total} differ, each a tie (largest gate gap "
                   f"{gap:.3e}, limit {ROUTE_TIE})")
        require(gap <= ROUTE_TIE, f"{label}: an expert choice differs from the unsharded "
                f"run's by a gate gap of {gap}")
    shared = 0
    for what in ("grad_digest", "param_digest"):
        seen = {}
        for r in ranks:
            for n, d in r[what].items():   # the same runs of a leaf: KV replicas too
                parts = sharding.model_parts(cfg, n)
                at = (n, tuple(tuple(sharding._ranges(w, e, r["coords"], parts))
                               for w, e in zip(shapes[n], plan[n])))
                if at in seen:
                    shared += 1
                    require(seen[at] == d, f"{label}: rank {r['rank']}'s {what} of {n} differs "
                            "from another rank's piece of the same slice")
                seen.setdefault(at, d)
    log("train-tp", f"{label}: {run['mesh'][0]}x{run['mesh'][1]} over gloo on one card "
        f"({run['scheme']}, batch {run['batch']} x {run['seq']}), "
        f"{ranks[0]['params'] / 1e9:.3f} B parameters a rank; loss {ranks[0]['loss']:.6f} "
        f"against {want['loss']:.6f} (relative {loss_rel:.2e}; limit {tol['loss']}); worst "
        f"gradient leaf {worst_g[1]} {worst_g[0]:.3e} of its max |g| (limit "
        f"{tol['grad']:.3e}"
        + ("" if want["floor"] is None else
           f": {SHARDED_TRAIN_TOL['grad']} or the one-ulp floor {want['floor']:.3e}")
        + f"){routing}; the step "
        f"(first rate {lr:.3e}): parameters outside their window by at most {worst_p[0]:.3e} "
        f"({worst_p[1]}), v by {worst_v[0]:.3e} ({worst_v[1]}); {n_open} of {n_all} elements "
        f"with |g| within the limit (sign open, window ~2 lr), the others at most "
        f"{settled[0]:.3e} from the unsharded gradient's step ({settled[1]}); "
        f"{shared} pieces held by two ranks, each bit-equal; launches by rank "
        f"{_launch_line([r['launches'] for r in ranks])} (lm.train_step_launches of each "
        f"rank's heads); init "
        f"{[round(r['init_s'], 2) for r in ranks]} s, step {[round(r['step_s'], 3) for r in ranks]}"
        f" s (the ranks time-slice one card); peak {[round(r['peak_gib'], 1) for r in ranks]} "
        f"GiB allocated, {[round(r['reserved_gib'], 1) for r in ranks]} GiB reserved; rank 0: "
        f"step {ranks[0]['step_s']:.4f} s, max_memory_allocated {ranks[0]['peak_gib']:.4f} GiB")
    require(loss_rel <= tol["loss"], f"{label}: loss {loss_rel}")
    require(worst_g[0] <= tol["grad"], f"{label}: gradient {worst_g}, limit {tol['grad']}")
    require(worst_p[0] == 0.0, f"{label}: parameter {worst_p[1]} {worst_p[0]} outside its window")
    require(worst_v[0] == 0.0, f"{label}: v of {worst_v[1]} {worst_v[0]} outside its window")
    if "ckpt" in ranks[0]:
        _check_ckpt_round_trip(run, ranks)


def _gib(growth: tuple) -> str:
    """An :class:`_RssGrowth`'s (sampled, getrusage) growth in GiB."""
    return f"{growth[0] / 2**30:.3f} (getrusage {growth[1] / 2**30:.3f})"


def _check_ckpt_round_trip(run: dict, ranks: list) -> None:
    """Phase 10d's checkpoint round trip (:func:`_ckpt_round_trip`): every
    rank's restored parameters, moments and step bit-equal to the ones it
    saved (its slices of the file: together the file is the ranks'
    pieces), and the step in ``meta.json``."""
    label = run["label"]
    for r in ranks:
        got = r["ckpt"]
        differ = [k for k, v in got["saved"].items() if got["restored"].get(k) != v]
        require(not differ and len(got["restored"]) == len(got["saved"]),
                f"{label}: rank {r['rank']} restored {len(differ)} pieces other than it "
                f"saved, e.g. {differ[:3]}")
        require(got["meta_step"] == got["saved"]["step"] == 1,
                f"{label}: rank {r['rank']}: step {got['meta_step']} in meta.json")
    ck = ranks[0]["ckpt"]
    save_s = max(r["ckpt"]["save_s"] for r in ranks)
    restore_s = max(r["ckpt"]["restore_s"] for r in ranks)
    log("train-tp", f"{label}: sharded checkpoint (ckpt.save_sharded / restore_sharded, "
        f"gloo through the host): {ck['bytes'] / 1e9:.3f} GB written by rank 0 in "
        f"{save_s:.2f} s ({ck['bytes'] / 1e9 / save_s:.3f} GB/s; its RSS grew "
        f"{_gib(ck['save_rss'])} GiB at peak), restored by every rank in {restore_s:.2f} s "
        f"(RSS growth {'; '.join(_gib(r['ckpt']['restore_rss']) for r in ranks)} GiB); "
        f"the {len(ck['saved'])} parameters, moments and step of every rank restored bit "
        f"for bit; round trip {save_s + restore_s:.1f} s")


def phase_sharded_training(torch, device, checked: set) -> dict:
    """Phase 10d (at most SHARDED_TRAIN_BUDGET_S): SHARDED_TRAIN over one
    2x2 spawn of ranks sharing the card through gloo (a 1x2 run on the
    first two, :func:`_sharded_train_rank`), each run against the
    unsharded step, computed first in this process, kept on the host and
    freed from the card before the ranks start.  Returns each run's rank-0
    launches of its train step."""
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    card = f"cuda:{torch.cuda.current_device()}"
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"run{i}.pt") for i in range(len(SHARDED_TRAIN))]
        wants = [_unsharded_step(torch, run, device, path)
                 for run, path in zip(SHARDED_TRAIN, paths)]
        torch.cuda.empty_cache()
        log("train-tp", f"starting 4 ranks; {memory(torch)}")
        t0 = time.perf_counter()
        # the ranks' allocators grow their segments in place (the spawned
        # processes read the setting; this one's allocator is set already):
        # otherwise each leaves ~2 GiB of the shared card reserved in pieces
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            results = run_ranks(_sharded_train_rank, 4, list(SHARDED_TRAIN), paths,
                                [w["delta"] for w in wants], [w["routes"] for w in wants],
                                backend="gloo", devices=[card] * 4,
                                timeout=SHARDED_TIMEOUT_S, store_dir=tmp)
        finally:
            if alloc_conf is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        log("train-tp", f"4 ranks on {card} trained {len(SHARDED_TRAIN)} runs in "
            f"{time.perf_counter() - t0:.1f} s (spawn, init, a step each)")
    launches = {}
    for i, run in enumerate(SHARDED_TRAIN):
        ranks = [res[i] for res in results if res[i] is not None]
        require(len(ranks) == run["mesh"][0] * run["mesh"][1],
                f"{run['label']}: {len(ranks)} ranks took part")
        _check_sharded_train(torch, run, ranks, wants[i], checked)
        launches[run["label"]] = ranks[0]["launches"]
    seconds = time.perf_counter() - t_phase
    log("train-tp", f"phase 10d took {seconds:.1f} s (budget {SHARDED_TRAIN_BUDGET_S:.0f} s)")
    require(seconds <= SHARDED_TRAIN_BUDGET_S, f"phase 10d took {seconds:.1f} s")
    return launches


# phase 10f's ranks draw their shards eight at a time: all 16 at once do not
# fit (gemma3-4b's float32 embedding and its scaled copy, 5.4 GB a rank).
# They keep the default allocator: with expandable segments (phase 10d's)
# the spawn took 132.6-159.0 s against 78.5 s (H100 80GB HBM3, 700 W).
SHARED_KV_WAVE = 8


def _shared_kv_rank(serve: list, train: list, paths: list, deltas: list, choices: list
                    ) -> tuple:
    """One rank of phase 10f, in its own process: phase 6b's rank on the
    ``serve`` runs, then phase 10d's on the ``train`` runs (one mesh after
    another over the same 16 ranks), each shard drawn in waves of
    SHARED_KV_WAVE ranks."""
    return (_sharded_rank(serve, SHARED_KV_WAVE),
            _sharded_train_rank(train, paths, deltas, choices, SHARED_KV_WAVE))


def phase_shared_kv(torch, device, checked: dict, trained: set) -> dict:
    """Phase 10f: SHARED_KV_SERVE and SHARED_KV_TRAIN over one spawn of
    SHARED_KV_RANKS ranks sharing the card through gloo
    (:func:`_shared_kv_rank`, loading phase 2's builds), each against the
    unsharded model or step, computed first in this process and freed from
    the card before the ranks start; phase 6b's checks for the serving
    runs, phase 10d's for the training runs, each rank's launches its own
    heads' count.  The spawn's seconds are held to SHARED_KV_BUDGET_S.
    Returns each run's launches by rank."""
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    card = f"cuda:{torch.cuda.current_device()}"
    with tempfile.TemporaryDirectory() as tmp:
        served = [_unsharded(torch, run, device, {}) for run in SHARED_KV_SERVE]
        paths = [str(Path(tmp) / f"run{i}.pt") for i in range(len(SHARED_KV_TRAIN))]
        stepped = [_unsharded_step(torch, run, device, path)
                   for run, path in zip(SHARED_KV_TRAIN, paths)]
        torch.cuda.empty_cache()
        log("shared-kv", f"starting {SHARED_KV_RANKS} ranks; {memory(torch)}")
        t0 = time.perf_counter()
        results = run_ranks(_shared_kv_rank, SHARED_KV_RANKS, list(SHARED_KV_SERVE),
                            list(SHARED_KV_TRAIN), paths, [w["delta"] for w in stepped],
                            [w["routes"] for w in stepped], backend="gloo",
                            devices=[card] * SHARED_KV_RANKS, timeout=SHARDED_TIMEOUT_S,
                            store_dir=tmp)
        spawn_s = time.perf_counter() - t0
    log("shared-kv", f"{SHARED_KV_RANKS} ranks on {card} served {len(SHARED_KV_SERVE)} runs and "
        f"trained {len(SHARED_KV_TRAIN)} in {spawn_s:.1f} s (spawn, init, serve, a step each; "
        f"budget {SHARED_KV_BUDGET_S:.0f} s)")
    launches = {}
    for i, run in enumerate(SHARED_KV_SERVE):
        ranks = [res[0][i] for res in results]
        _check_sharded(torch, run, ranks, served[i], checked)
        launches[run["label"]] = [r["launches"] for r in ranks]
    for i, run in enumerate(SHARED_KV_TRAIN):
        ranks = [res[1][i] for res in results]
        _check_sharded_train(torch, run, ranks, stepped[i], trained)
        launches[run["label"]] = [r["launches"] for r in ranks]
    log("shared-kv", f"phase 10f took {time.perf_counter() - t_phase:.1f} s")
    require(spawn_s <= SHARED_KV_BUDGET_S, f"phase 10f's spawn took {spawn_s:.1f} s")
    return launches


def shared_kv_rows(torch, device, shared: dict, errs: dict) -> list:
    """Phase 8's rows for the flash forward and backward at model index
    0's heads of SHARED_KV_TIMED, bfloat16, beside SDPA, each with phase
    10f's rank-0 launches of the run it names (``timed_from``; gemma3-4b
    only serves there, so its backward row's launches are 0)."""
    from repro_torch import sharding

    rows = []
    for run in SHARED_KV_TIMED:
        cfg = _sharded_config(run)
        data, model = run["mesh"]
        (_, n_q), (_, n_kv) = sharding.attn_heads(cfg, model, 0)
        calls = [(label, form) for form, label in model_flash_calls(
            cfg, run["batch"] // data, model, run["seq"], index=0).items()]
        rank0 = shared[run["timed_from"]][0]
        fwd = [(run["label"], f"{run['label']}: {label} ({n_q} / {n_kv} heads) training", *form)
               for label, form in calls]
        bwd = [(f"{run['label']}: {label} ({n_q} / {n_kv} heads) training", *form[:3])
               for label, form in calls]
        rows += family_flash_rows(torch, device, {run["label"]: rank0}, errs, cases=fwd,
                                  key="shared_kv_run")
        rows += flash_bwd_rows(torch, device, None, errs["flash_attention_bwd"], cases=bwd,
                               launches=rank0.get("flash_attention_bwd", 0), first=False)
    return rows


def _train_4card_rank(runs: list, ckpt_dir: str) -> list:
    """One rank of the four-card training (NCCL, a card a rank): each run's
    TRAIN_STEPS steps of ``make_train_step`` on one repeated batch (the
    rank's rows), the launch counts of each step set to 0 just before it
    and read just after, each run freed before the next.  A run with
    ``resume`` saves its state after that many steps (``ckpt.save_sharded``
    into ``ckpt_dir``), and after the last step, its model and state
    freed, restores it (``ckpt.restore_sharded``) and takes the steps after
    ``resume`` again (rank 0 removes the file once every rank has
    restored): their losses, the save's and the restore's seconds and peak
    RSS growth."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch import ckpt, sharding
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule

    torch.backends.cuda.matmul.allow_tf32 = False       # phase_device's settings
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", torch.cuda.current_device())
    out = []
    for run in runs:
        cfg = get_config(run["arch"])
        mesh = make_mesh(*run["mesh"], device_type="cuda")
        t0 = time.perf_counter()
        params = sharding.init_params_sharded(cfg, sharding.plan_for(cfg, run["scheme"]), mesh,
                                              seed=SEED, dtype=torch.float32,
                                              compute_dtype=torch.bfloat16, device=device)
        plan = sharding.plan_for(cfg, run["scheme"])
        opt = adamw(cosine_schedule(TRAIN_LR, warmup=2, total=TRAIN_STEPS))
        state = opt.init(dict(params.named_parameters()))
        step = lm.make_train_step(opt)
        batch = sharding.local_batch(cfg, synthetic_batch(
            cfg, run["batch"], run["seq"], torch.Generator(device=device).manual_seed(SEED)), mesh)
        torch.cuda.synchronize(device)
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        losses, seconds, counts, resumed = [], [], [], {}
        with _FlashLog() as flash_log:
            for i in range(TRAIN_STEPS):
                torch.cuda.synchronize(device)
                _build.reset_launches()
                t0 = time.perf_counter()
                params, state, metrics = step(params, state, batch)
                losses.append(metrics["loss"].item())     # a sync
                seconds.append(time.perf_counter() - t0)
                counts.append(dict(_build.LAUNCHES))
                if i + 1 == run.get("resume"):
                    dist.barrier()
                    t0 = time.perf_counter()
                    with _RssGrowth() as rss:
                        ckpt.save_sharded(ckpt_dir, params, state, plan, mesh, step=i + 1,
                                          config={"arch": run["arch"]})
                    resumed.update(save_s=time.perf_counter() - t0,
                                   save_rss=(rss.growth, rss.ru_growth))
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            n_params = sum(p.numel() for p in params.parameters())
            if resumed:
                del params, state
                gc.collect()
                torch.cuda.empty_cache()
                dist.barrier()
                t0 = time.perf_counter()
                with _RssGrowth() as rss:
                    params, state, _ = ckpt.restore_sharded(ckpt_dir, cfg, plan, mesh,
                                                            device=device,
                                                            compute_dtype=torch.bfloat16)
                    torch.cuda.synchronize(device)
                resumed.update(restore_s=time.perf_counter() - t0,
                               restore_rss=(rss.growth, rss.ru_growth), losses=[])
                dist.barrier()
                if dist.get_rank() == 0:   # its host memory, where TMPDIR is a tmpfs
                    shutil.rmtree(ckpt_dir)
                for _ in range(run["resume"], TRAIN_STEPS):
                    params, state, metrics = step(params, state, batch)
                    resumed["losses"].append(metrics["loss"].item())
        out.append({"rank": dist.get_rank(), "losses": losses, "seconds": seconds,
                    "launches": counts, "forms": flash_log.forms, "init_s": init_s,
                    "peak_gib": peak, "params": n_params, "resumed": resumed})
        del params, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_4card(torch, checked: set) -> dict:
    """--sharded-4card's training: TRAIN_4CARD over NCCL, a card a rank;
    each run's loss must fall TRAIN_MIN_DROP in TRAIN_STEPS steps, the
    ranks' losses equal, every step's launches ``lm.train_step_launches``
    and every flash form checked in phase 3.  Prints the warm step time,
    tok/s, model-FLOP utilisation of the four cards, each card's peak and
    launch/dryrun.py's forecast of the bytes a rank holds beside it.  A run
    with ``resume`` first checks that its checkpoint's bytes are free on
    the disk (it stops, naming them, where they are not), and its resumed
    steps' losses must be the uninterrupted run's, bit for bit."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.roofline import PEAK_FLOPS_BF16, model_flops
    from repro_torch.models import lm

    # the ranks' allocator grows its segments in place: gemma3-4b's float32
    # logits over 262,144 words (8.6 GB, and as many for their loss and
    # gradient) otherwise leave ~20 GiB of a card reserved in pieces too
    # small to reuse (one card, 6 layers: out of memory at 55 GiB allocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ckpt_dir = Path(tempfile.mkdtemp(prefix="ckpt_"))
    for run in TRAIN_4CARD:
        if run.get("resume"):   # float32 masters and AdamW's m and v, whole
            cfg = get_config(run["arch"])
            need = 12 * sum(p.numel() for p in lm.init_params(cfg, device="meta").parameters())
            free = shutil.disk_usage(ckpt_dir).free
            log("train-4", f"{run['label']}: its checkpoint needs {need} bytes "
                f"({need / 1e9:.1f} GB); {free / 1e9:.1f} GB free under {ckpt_dir}")
            if free < need:
                shutil.rmtree(ckpt_dir)
            require(free >= need, f"{run['label']}: the checkpoint needs {need} bytes, "
                    f"{free} are free under {ckpt_dir}")
    t0 = time.perf_counter()
    try:
        results = run_ranks(_train_4card_rank, 4, list(TRAIN_4CARD), str(ckpt_dir / "state"),
                            backend="nccl", devices=[f"cuda:{i}" for i in range(4)],
                            timeout=1800)
    finally:
        shutil.rmtree(ckpt_dir)
    log("train-4", f"four cards over NCCL: {len(TRAIN_4CARD)} runs in "
        f"{time.perf_counter() - t0:.1f} s of the spawn's 1800 s timeout (spawn, init, "
        f"{TRAIN_STEPS} steps each)")
    out = {}
    for i, run in enumerate(TRAIN_4CARD):
        ranks = [res[i] for res in results]
        cfg = get_config(run["arch"])
        label = run["label"]
        want = lm.train_step_launches(cfg)
        losses = ranks[0]["losses"]
        for r in ranks:
            require(r["losses"] == losses, f"{label}: rank {r['rank']}'s losses {r['losses']} "
                    f"differ from rank 0's {losses}")
            require(all(c == want for c in r["launches"]),
                    f"{label}: rank {r['rank']} launches {r['launches']}, expected {want} a step")
            require_checked(label, r["forms"], checked)
        require(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
        require(losses[-1] <= losses[0] - TRAIN_MIN_DROP,
                f"{label}: loss fell {losses[0] - losses[-1]:.4f} nat in {TRAIN_STEPS} steps")
        warm = statistics.median(max(r["seconds"][j] for r in ranks)
                                 for j in range(1, TRAIN_STEPS))
        shape = InputShape("train", run["seq"], run["batch"], "train")
        mfu = model_flops(cfg, shape) / warm / (4 * PEAK_FLOPS_BF16)
        held = sum(p.numel() for p in lm.init_params(cfg, device="meta").parameters())
        data, model = run["mesh"]
        sizes = {"data": data, "model": model}
        forecast = (4 * dryrun.param_bytes(cfg, sizes, run["scheme"])
                    + dryrun.batch_bytes(cfg, shape, sizes)) / 2**30
        peak = max(r["peak_gib"] for r in ranks)
        if label in COUNTED_4CARD:
            counted = counted_step(cfg, run["batch"], run["seq"], sizes, run["scheme"])
            forecast_line = f"{_counted_line(counted, peak)} (rank 0)"
        else:
            forecast_line = (f"dryrun's forecast {forecast:.1f} GiB a rank (parameters, "
                             f"gradients, AdamW m and v, batch; no activations)")
        log("train-4", f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{ranks[0]['params'] / 1e9:.3f} B parameters a rank (drawn in "
            f"{[round(r['init_s'], 1) for r in ranks]} s); loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} in {TRAIN_STEPS} steps (limit: down {TRAIN_MIN_DROP}), the same "
            f"on every rank; warm step median {warm:.4f} s ({run['batch'] * run['seq'] / warm:.0f} "
            f"tok/s, model-FLOP utilisation {mfu:.1%} of 4 x 989 TFLOP/s, from "
            f"ArchConfig.param_count's {cfg.param_count() / 1e9:.2f} B parameters, the model "
            f"holds {held / 1e9:.3f} B); peak "
            f"{[round(r['peak_gib'], 1) for r in ranks]} GiB allocated a card, "
            f"{forecast_line}; launches a step {ranks[0]['launches'][-1]}")
        out[label] = {"losses": losses, "step_s": warm, "mfu": mfu, "held_params": held,
                      "peak_gib": [r["peak_gib"] for r in ranks], "forecast_gib": forecast,
                      "launches": ranks[0]["launches"][-1]}
        if label in COUNTED_4CARD:
            out[label]["counted_peak_gib"] = counted["peak_bytes"] / 2**30
            out[label]["counted_terms"] = counted["terms"]
            require(counted["peak_bytes"] / 2**30 >= COUNT_PEAK_FLOOR * peak,
                    f"{label}: counted peak {counted['peak_bytes'] / 2**30:.2f} GiB is more "
                    f"than {1 - COUNT_PEAK_FLOOR:.0%} below the measured {peak:.2f} GiB")
        if run.get("resume"):
            out[label]["resume"] = _check_4card_resume(run, ranks, held)
    return out


def _check_4card_resume(run: dict, ranks: list, held: int) -> dict:
    """The resumed steps' losses against the uninterrupted run's, bit for
    bit, on every rank; the save's and the restore's seconds, GB/s and
    rank 0's (the writer's) peak RSS growth."""
    after = run["resume"]
    for r in ranks:
        got = r["resumed"]["losses"]
        require(got == r["losses"][after:], f"{run['label']}: rank {r['rank']}'s steps "
                f"{after + 1}-{TRAIN_STEPS} from the checkpoint gave {got!r}, the uninterrupted "
                f"run {r['losses'][after:]!r}")
    gb = 12 * held / 1e9   # float32 masters and AdamW's m and v
    save_s = max(r["resumed"]["save_s"] for r in ranks)
    restore_s = max(r["resumed"]["restore_s"] for r in ranks)
    res = {"gb": gb, "save_s": save_s, "restore_s": restore_s,
           "save_rss": ranks[0]["resumed"]["save_rss"],
           "restore_rss": [r["resumed"]["restore_rss"] for r in ranks]}
    log("train-4", f"{run['label']}: saved after step {after} (ckpt.save_sharded, {gb:.1f} GB) "
        f"in {save_s:.1f} s ({gb / save_s:.2f} GB/s; rank 0's RSS grew "
        f"{_gib(res['save_rss'])} GiB at peak), restored into fresh models after step "
        f"{TRAIN_STEPS} in {restore_s:.1f} s ({gb / restore_s:.2f} GB/s over the four ranks; "
        f"RSS growth {'; '.join(_gib(x) for x in res['restore_rss'])} GiB); steps "
        f"{after + 1}-{TRAIN_STEPS} again: losses {ranks[0]['resumed']['losses']}, the "
        f"uninterrupted run's bit for bit on every rank")
    return res


# The backward's timed shapes (phase 8 and --time-kernels): tinyllama's
# training call and gemma3's local and global layers.
FLASH_BWD_TIMED = (TRAINED_FORMS[0], *TRAINED_FORMS[2:4])


def flash_bwd_bound(dims, causal: bool, window) -> tuple[float, str]:
    """The backward's least time: 10 hd flops per valid (query head, key)
    pair at the bfloat16 peak, or q, k, v, o, dO, lse read and dq, dk, dv
    written once (bf16, lse float32): ``flash_bwd_cost``, the formula the
    dry run counts each launch with."""
    from repro_torch.kernels.flash_attention.flash_attention_bwd import flash_bwd_cost

    flops, nbytes = flash_bwd_cost(*dims, causal=causal, window=window)
    return bound(nbytes, flops, PEAK_BF16_FLOPS)


def flash_fwd_bound(dims, causal: bool = True, window=None, q_offset: int = 0
                    ) -> tuple[float, str]:
    """The forward's least time (bfloat16, no lse): 4 hd flops per valid
    (query head, key) pair at the bfloat16 peak, or q, k, v read and o
    written once: ``flash_fwd_cost``, the formula the dry run counts each
    launch with."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_fwd_cost

    flops, nbytes = flash_fwd_cost(*dims, causal=causal, window=window, q_offset=q_offset)
    return bound(nbytes, flops, PEAK_BF16_FLOPS)


def flash_bwd_rows(torch, device, train, errs, cases=FLASH_BWD_TIMED, launches=None,
                   first: bool = True) -> list:
    """Phase 8's rows for the backward kernel at tinyllama's and gemma3's
    training shapes (bfloat16; or ``cases``, in TRAINED_FORMS' layout, with
    ``launches`` their path's backward launches): kernel, plain twin and
    SDPA's backward (``torch.autograd`` through
    ``scaled_dot_product_attention``, timed as the yardstick only) beside
    the bound: 10 hd flops per valid (query head, key) pair at the bfloat16
    peak, or q, k, v, o, dO, lse read and dq, dk, dv written once.  The
    first row (with ``first``) is the kernel's own, ``flash_attention_bwd``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda)

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    rows = []
    for label, dims, causal, window in cases:
        form = flash_form(dims, causal, window, 0, None)
        B, Sq, Skv, Hq, Hkv, hd = dims
        (q, k, v, do), kw = flash_bwd_operands(torch, gen, device, form, torch.bfloat16)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        ms = time_ms(torch, lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw), iters=10)
        plain_ms = time_ms(torch, lambda: flash_attention_bwd_plain(q, k, v, o, do, lse, **kw),
                           warmup=1, iters=3)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(Sq, device=device)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=mask is None and causal,
                                                  enable_gqa=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                            retain_graph=True), iters=10)
        b_ms, b_by = flash_bwd_bound(dims, causal, window)
        log("time", f"flash backward {label}: q {tuple(q.shape)} k {tuple(k.shape)} bf16 {kw}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
        rows.append({
            "name": ("flash_attention_bwd" if first and not rows
                     else f"flash_attention_bwd[{label}]"),
            "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:98",
            "note": "the reference's custom VJP (_flash_bwd) is plain JAX; the TPU kernel "
                    "src/repro/kernels/flash_attention/flash_attention.py:100 is forward only",
            "launches": (train["run_launches"]["flash_attention_bwd"] if launches is None
                         else launches),
            "max_abs_err": (max(errs[torch.bfloat16]) if launches is None
                            else errs["by_case"][(form, torch.bfloat16)]),
            "max_abs_err_f32": (max(errs[torch.float32]) if launches is None
                                else errs["by_case"][(form, torch.float32)]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "ported": 20,
            "redesigned": REDESIGNED_IN["flash_attention_bwd"],
        })
        del q, k, v, do, o, lse, qt, kt, vt, sdpa_out, dot
        torch.cuda.empty_cache()
    return rows


# The WKV backward's timed shape (phase 8 and --time-kernels): rwkv6's
# training call, bfloat16 r, k, v at the model's decays.
WKV_BWD_TIMED = (4, 2048, 32, 64)
# The kernels of one WKV backward launch (csrc/wkv_bwd.cu), each run once.
WKV_BWD_KERNELS = ("wkv_bwd_chunk_tc", "wkv_bwd_scan", "wkv_bwd_grad_tc", "wkv_bwd_du")
PEAK_3XTF32_FLOPS = 495e12 / 3  # float32-accurate products as three TF32 passes


def wkv_bwd_bytes(B: int, S: int, H: int, hd: int, rkv_bytes: int) -> float:
    """The WKV backward's least bytes: r, k, v (``rkv_bytes`` each), w, dout,
    u and the chunk-start states read and dr, dk, dv, dw (float32), du and
    dstate0 written once (``wkv_bwd_cost``)."""
    from repro_torch.kernels.wkv.wkv import wkv_bwd_cost

    return wkv_bwd_cost(B, S, H, hd, rkv_bytes=rkv_bytes)[2]


def wkv_bwd_bound(B: int, S: int, H: int, hd: int, rkv_bytes: int) -> tuple[float, str]:
    """The WKV backward's least time at the rates its kernels run on: 12 hd^2
    + 2 T hd flops a step on the TF32 tensor cores as 3xTF32 (a third of 495
    TFLOP/s: five hd x hd products a sub-block and M = V dout^T in
    wkv_bwd_grad_tc, G_c in wkv_bwd_chunk_tc; T = 16 steps a sub-block),
    the pair terms' 8 T hd flops a step on the FP32 cores beside them, or
    ``wkv_bwd_bytes`` at the memory rate, whichever takes longest
    (``wkv_bwd_cost``, the formula the dry run counts each launch with)."""
    from repro_torch.kernels.wkv.wkv import wkv_bwd_cost

    tc, fp32, nbytes = wkv_bwd_cost(B, S, H, hd, rkv_bytes=rkv_bytes)
    t_tc = tc / PEAK_3XTF32_FLOPS * 1e3
    t_fp32 = fp32 / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max((t_bytes, "bytes"), (max(t_tc, t_fp32), "operations"))


def wkv_bwd_bound_stepwise(B: int, S: int, H: int, hd: int, rkv_bytes: int
                           ) -> tuple[float, str]:
    """The bound the stepwise WKV backward was held to, kept so that its
    rows compare: 12 flops a step and state entry (recomputing the state 2;
    dS 2; dr, dk, dv and dw 2 each) at the FP32 rate, or ``wkv_bwd_bytes``
    at the memory rate."""
    return bound(wkv_bwd_bytes(B, S, H, hd, rkv_bytes), 12.0 * B * S * H * hd * hd)


def wkv_bwd_rows(torch, device, train, errs) -> list:
    """Phase 8's row for the WKV backward at rwkv6's training shape: the
    kernel and its plain twin beside the bound; no library call computes
    it."""
    from repro_torch.kernels.wkv import wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda
    from repro_torch.launch.kernel_times import kernel_times

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    (r, k, v, w, u), dout, _, _ = wkv_bwd_operands(torch, gen, WKV_BWD_TIMED, False,
                                                   torch.bfloat16, False, False, device)
    _, _, starts = wkv_cuda(r, k, v, w, u, return_starts=True)
    ms = time_ms(torch, lambda: wkv_bwd_cuda(r, k, v, w, u, dout, starts), iters=10)
    traced = kernel_times(lambda: wkv_bwd_cuda(r, k, v, w, u, dout, starts), iters=10)
    require(sorted(n.split("<")[0] for n in traced.launches) == sorted(WKV_BWD_KERNELS)
            and all(n == 10 for n in traced.launches.values()),
            f"ten WKV backward calls ran {traced.launches}")
    plain_ms = time_ms(torch, lambda: wkv_bwd_plain(r, k, v, w, u, dout), warmup=1, iters=3)
    b_ms, b_by = wkv_bwd_bound(*WKV_BWD_TIMED, rkv_bytes=2)
    old_ms, old_by = wkv_bwd_bound_stepwise(*WKV_BWD_TIMED, rkv_bytes=2)
    log("time", f"wkv backward r {tuple(r.shape)} bf16 (rwkv6 training): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}; 3xTF32 and FP32 "
        f"rates), {b_ms / ms:.1%} of the bound; the stepwise kernel's bound {old_ms:.4f} ms "
        f"({old_by}), {old_ms / ms:.1%} of it; by kernel (torch.profiler, ms a call, each once "
        f"a call; the trace lost {traced.pad_lost} padding kernels): "
        + ", ".join(f"{name} {t:.4f}" for name, t in traced.ms.items()))
    del r, k, v, w, u, dout, starts
    torch.cuda.empty_cache()
    return [{
        "name": "wkv_bwd", "route": "cuda", "source": "src/repro_torch/csrc/wkv_bwd.cu",
        "replaces": "src/repro/models/ssm.py:303",
        "note": "the reference differentiates rwkv_time_mix's scan with JAX's autodiff; the "
                "TPU kernel src/repro/kernels/wkv/wkv.py:53 is forward only",
        "launches": train["rwkv"]["run_launches"]["wkv_bwd"], "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "stepwise_bound_ms": old_ms, "stepwise_bound_by": old_by, "ms_by_kernel": traced.ms,
        "library_ms": None, "ported": 22, "redesigned": REDESIGNED_IN["wkv_bwd"],
    }]


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
    entry (``wkv_cost`` with a state0)."""
    return wkv_bound(B, 1, H, hd, rkv_bytes, state0=True)


def wkv_bound(B: int, S: int, H: int, hd: int, rkv_bytes: int, state0: bool = False
              ) -> tuple[float, str]:
    """The least time of a WKV forward at the FP32 rate: ``wkv_cost``, the
    formula the dry run counts each launch with."""
    from repro_torch.kernels.wkv.wkv import wkv_cost

    flops, nbytes = wkv_cost(B, S, H, hd, rkv_bytes=rkv_bytes, state0=state0)
    return bound(nbytes, flops)


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
    b_ms, b_by = flash_fwd_bound((B, S, S, Hq, Hkv, hd))
    log("time", f"flash prefill q {tuple(q.shape)} k {tuple(k.shape)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
        "launches": launches["tinyllama-1.1b"].get("flash_attention", 0),
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
    b3, b3_by = flash_fwd_bound((B, S, S, Hq3, Hkv3, hd3))
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
    keys = pos + 1   # the keys the query sees, each read once
    b_ms, b_by = flash_fwd_bound((B, 1, keys, Hq, Hkv, hd), q_offset=pos)
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
    b_ms, b_by = wkv_bound(B, S, H, hd, rkv_bytes=2)
    log("time", f"wkv prefill r {tuple(ops[0].shape)} ({plan.route}, chunk {plan.chunk}): "
        f"kernel {ms:.4f} ms with bfloat16 r, k, v (the serving path's), {ms_f32:.4f} ms "
        f"float32; plain {plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by})")
    rows.append({
        "name": "wkv", "route": "cuda", "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv/wkv.py:53",
        "launches": launches["rwkv6-1.6b"].get("wkv", 0), "max_abs_err": max(errs["wkv"]),
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


def family_flash_case(torch, gen, device, case):
    """The bfloat16 operands of a FAMILY_FLASH case, the wrapper's keyword
    arguments, the SDPA call computing the same function and the bound."""
    import torch.nn.functional as F

    _, label, (B, Sq, Skv, Hq, Hkv, hd), causal, window, q_off, slots = case
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf16)

    q = randn(B, Sq, Hq, hd)
    k, v = randn(B, slots or Skv, Hkv, hd)[:, :Skv], randn(B, slots or Skv, Hkv, hd)[:, :Skv]
    kw = dict(causal=causal, window=window, q_offset=q_off)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal and q_off:                       # decode: the keys up to the query
        kt, vt = kt[:, :, :q_off + Sq], vt[:, :, :q_off + Sq]
    mask = None
    if window is not None:                     # SDPA takes a window only as a mask
        qpos = torch.arange(Sq, device=device)[:, None] + q_off
        kpos = torch.arange(kt.shape[2], device=device)[None, :]
        mask = kpos > qpos - window
        if causal:
            mask = mask & (kpos <= qpos)

    is_causal = causal and mask is None and q_off == 0

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True)

    # the backend SDPA's dispatcher picks for these operands
    sdpa.backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, mask, 0.0, is_causal, enable_gqa=True)).name
    b = flash_fwd_bound((B, Sq, Skv, Hq, Hkv, hd), causal, window, q_off)
    return (q, k, v), kw, sdpa, b


# The four-card runs whose per-rank training shapes phase 8 times (their
# forms: granite-8b 8 / 2 heads at 1x4 and 16 / 4 at 2x2, hd 128; zamba2-7b's
# shared block 8 / 8 at 1x4, hd 112; gemma3-4b's local and global layers 2
# / 1 at 1x4, hd 256).
TRAIN_4CARD_TIMED = ("granite-8b tp_only 1x4", "granite-8b fsdp_tp 2x2",
                     "zamba2-7b tp_only 1x4", "gemma3-4b tp_only 1x4")


def sharded_train_rows(torch, device, tp_train: dict, errs: dict) -> list:
    """Phase 8's rows for the flash forward and backward at a rank's
    bfloat16 training shapes of the four-card runs (TRAIN_4CARD_TIMED),
    beside SDPA, each with phase 10d's per-rank launches of the same
    architecture's sharded step (the same kernels)."""
    step_of = {run["arch"]: run["label"] for run in SHARDED_TRAIN}
    rows = []
    for run in TRAIN_4CARD:
        if run["label"] not in TRAIN_4CARD_TIMED:
            continue
        step = step_of[run["arch"]]
        calls = sharded_train_flash_calls((run,))
        fwd = [(step, f"{label} training", *form) for label, form in calls]
        bwd = [(f"{label} training", *form[:3]) for label, form in calls]
        rows += family_flash_rows(torch, device, tp_train, errs, cases=fwd,
                                  key="sharded_train_run")
        rows += flash_bwd_rows(torch, device, None, errs["flash_attention_bwd"], cases=bwd,
                               launches=tp_train[step]["flash_attention_bwd"], first=False)
    return rows


WKV_RANK_HEADS = 8   # a rank's WKV heads of rwkv6-1.6b's 32 over a model axis of 4


def wkv_rank_rows(torch, device, tp_serve: dict, tp_train: dict, errs: dict) -> list:
    """Phase 8's rows for the WKV kernels on a rank's heads, WKV_RANK_HEADS
    of rwkv6's 32 (bfloat16 r, k, v): the prefill at the serving shape and
    one decode step from a carried state (replayed from a CUDA graph), and
    the backward at the training shape, each beside its plain twin and its
    bound (no library call computes either); the launches are a rank's in
    phase 6b's and 10d's rwkv6 runs (16 heads a rank over 1x2: the same
    kernels)."""
    from repro_torch.kernels.wkv import (wkv_bwd_cuda, wkv_bwd_plain, wkv_cuda, wkv_plain,
                                         wkv_plan)

    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    H, hd = WKV_RANK_HEADS, 64
    B, S = LM_BATCH, LM_PROMPT
    ops = wkv_inputs(torch, gen, B, S, H, hd, device)
    bf = tuple(a.to(torch.bfloat16) if i < 3 else a for i, a in enumerate(ops))
    ms = time_ms(torch, lambda: wkv_cuda(*bf))
    plain_ms = time_ms(torch, lambda: wkv_plain(*bf), warmup=1, iters=3)
    b_ms, b_by = wkv_bound(B, S, H, hd, rkv_bytes=2)
    step = tuple(a.to(torch.bfloat16) if i < 3 else a
                 for i, a in enumerate(wkv_inputs(torch, gen, B, 1, H, hd, device)))
    state = torch.randn((B, H, hd, hd), generator=gen, device=device)
    dec_ms = graph_ms(torch, lambda: wkv_cuda(*step, state), reps=20)
    dec_plain_ms = graph_ms(torch, lambda: wkv_plain(*step, state), reps=20)
    dec_b_ms, dec_b_by = wkv_decode_bound(B, H, hd, rkv_bytes=2)
    log("time", f"wkv a rank's {H} of 32 heads: prefill r {tuple(bf[0].shape)} bf16 "
        f"({wkv_plan(S).route}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.4f} ms ({b_by}); decode (graph replay) kernel {dec_ms:.4f} ms, plain "
        f"{dec_plain_ms:.4f} ms, bound {dec_b_ms:.4f} ms ({dec_b_by})")
    del ops, bf, step, state
    dims = (TRAIN_BATCH, TRAIN_SEQ, H, hd)
    (r, k, v, w, u), dout, _, _ = wkv_bwd_operands(torch, gen, dims, False, torch.bfloat16,
                                                   False, False, device)
    _, _, starts = wkv_cuda(r, k, v, w, u, return_starts=True)
    bwd_ms = time_ms(torch, lambda: wkv_bwd_cuda(r, k, v, w, u, dout, starts), iters=10)
    bwd_plain_ms = time_ms(torch, lambda: wkv_bwd_plain(r, k, v, w, u, dout), warmup=1, iters=3)
    bwd_b_ms, bwd_b_by = wkv_bwd_bound(*dims, rkv_bytes=2)
    log("time", f"wkv backward a rank's {H} of 32 heads: r {tuple(r.shape)} bf16: kernel "
        f"{bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, library none, bound {bwd_b_ms:.4f} ms "
        f"({bwd_b_by}), {bwd_b_ms / bwd_ms:.1%} of the bound")
    del r, k, v, w, u, dout, starts
    torch.cuda.empty_cache()
    serve_run = next(run["label"] for run in SHARDED_RUNS if run["arch"] == "rwkv6-1.6b")
    train_run = next(run["label"] for run in SHARDED_TRAIN if run["arch"] == "rwkv6-1.6b")
    common = {"route": "cuda", "library_ms": None, "heads": f"{H} of 32 (a rank's over 1x4)",
              "launches_path": "a rank's rwkv6 run in phases 6b (serving) and 10d (training), "
                               "16 heads a rank over 1x2"}
    return [
        {"name": f"wkv[a rank's {H} heads]", "source": "src/repro_torch/csrc/wkv.cu",
         "replaces": "src/repro/kernels/wkv/wkv.py:53",
         "launches": tp_serve[serve_run].get("wkv", 0) + tp_train[train_run]["wkv"],
         "max_abs_err": max(errs["wkv_rank"]), "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "decode_ms": dec_ms,
         "decode_plain_ms": dec_plain_ms, "decode_bound_ms": dec_b_ms,
         "decode_bound_by": dec_b_by, **common},
        {"name": f"wkv_bwd[a rank's {H} heads]", "source": "src/repro_torch/csrc/wkv_bwd.cu",
         "replaces": "src/repro/models/ssm.py:303",
         "launches": tp_train[train_run]["wkv_bwd"],
         "max_abs_err": errs["wkv_bwd_by_label"][next(
             label for label, dims, *_ in WKV_BWD_FORMS if dims == (TRAIN_BATCH, TRAIN_SEQ, H, hd))],
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_b_ms, "bound_by": bwd_b_by,
         **common},
    ]


def family_flash_rows(torch, device, launches, errs, cases=FAMILY_FLASH, key="family") -> list:
    """Phase 8's rows for the newer families' flash calls (FAMILY_FLASH;
    with ``cases``, another list in its layout, such as phase 6b's per-rank
    calls, ``launches`` keyed by its first field): kernel, plain twin and
    SDPA (the backend its dispatcher picks) beside the bound.  Decode-sized
    calls are replayed from CUDA graphs."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    rows = []
    for case in cases:
        arch, label, (B, Sq, Skv, Hq, Hkv, hd) = case[:3]
        form = flash_form(*case[2:])
        (q, k, v), kw, sdpa, (b_ms, b_by) = family_flash_case(torch, gen, device, case)
        if Sq == 1:
            ms = graph_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw), reps=20)
            plain_ms = graph_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), reps=20)
            lib_ms = graph_ms(torch, sdpa, reps=20)
        else:
            ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw))
            plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), iters=5)
            lib_ms = time_ms(torch, sdpa)
        log("time", f"flash {label}: q {tuple(q.shape)} k {tuple(k.shape)} bf16 {kw}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({sdpa.backend}), "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
        rows.append({
            "name": f"flash_attention[{label}]", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
            "launches": launches[arch].get("flash_attention", 0),
            "max_abs_err": errs["flash_attention"]["by_case"][(form, torch.bfloat16)],
            "max_abs_err_f32": errs["flash_attention"]["by_case"][(form, torch.float32)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_backend": sdpa.backend,
            key: arch,
        })
        del q, k, v
    return rows


def time_kernels(torch) -> dict:
    """Milliseconds of the imported ``repro_torch``'s tsgemm, bfloat16
    flash-attention (forward and backward), float32 WKV and proximity
    wrappers at phase 8's main-path shapes (the wrappers' calls that earlier
    trees also take), and the bounds of the flash, proximity and WKV decode
    cases."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
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
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    bounds = {}
    for label, dims, causal, window in FLASH_BWD_TIMED:
        (qb, kb, vb, dob), kw = flash_bwd_operands(
            torch, gen, device, flash_form(dims, causal, window, 0, None), bf16)
        ob, lseb = flash_attention_cuda(qb, kb, vb, return_lse=True, **kw)
        key = f"flash backward {label}"
        ms[key] = time_ms(torch, lambda: flash_attention_bwd_cuda(qb, kb, vb, ob, dob, lseb, **kw),
                          iters=10)
        bounds[key] = flash_bwd_bound(dims, causal, window)[0]
        del qb, kb, vb, dob, ob, lseb
    torch.cuda.empty_cache()
    for case in FAMILY_FLASH:
        label, hd = case[1], case[2][5]
        if hd not in HEAD_DIMS:       # a tree from before the head dim was ported
            continue
        (qf, kf, vf), kw, _, (b_ms, _) = family_flash_case(torch, gen, device, case)
        if case[2][1] == 1:
            ms[f"flash {label} (graph replay)"] = graph_ms(
                torch, lambda: flash_attention_cuda(qf, kf, vf, **kw), reps=20)
        else:
            ms[f"flash {label}"] = time_ms(torch, lambda: flash_attention_cuda(qf, kf, vf, **kw))
        bounds[f"flash {label}"] = b_ms
        del qf, kf, vf
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
    if "wkv_bwd" in _build.KERNELS:   # trees from before the WKV backward lack it
        from repro_torch.kernels.wkv import wkv_bwd_cuda

        (r, k, v, w, u), dout, _, _ = wkv_bwd_operands(torch, gen, WKV_BWD_TIMED, False, bf16,
                                                       False, False, device)
        _, _, starts = wkv_cuda(r, k, v, w, u, return_starts=True)
        ms["wkv backward bf16"] = time_ms(
            torch, lambda: wkv_bwd_cuda(r, k, v, w, u, dout, starts), iters=10)
        bounds["wkv backward bf16"] = wkv_bwd_bound(*WKV_BWD_TIMED, rkv_bytes=2)[0]
        del r, k, v, w, u, dout, starts
    fed = Federation(torch, device)
    bounds.update({
        "wkv decode (graph replay)": wkv_decode_bound(LM_BATCH, H, hd, rkv_bytes=4)[0],
        "wkv decode bf16 (graph replay)": wkv_decode_bound(LM_BATCH, H, hd, rkv_bytes=2)[0]})
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
    ap.add_argument("--sharded-4card", action="store_true",
                    help="only phase 6b's four-card runs over NCCL and granite-8b's "
                         "four-card training (with phase 3's flash checks they need); needs "
                         "four cards")
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
    if args.sharded_4card:
        require(device["count"] >= 4, f"--sharded-4card needs four cards, not {device['count']}")
        from repro_torch.kernels import _build
        cuda = torch.device("cuda")
        _build.build_all(["flash_attention", "flash_attention_bwd", "wkv"])
        bwd = {torch.float32: [], torch.bfloat16: [], "by_case": {}}
        check_flash_bwd(torch, cuda, bwd, calls=sharded_train_flash_calls(TRAIN_4CARD))
        trained = {form for form, _ in bwd["by_case"]}
        errs = {torch.float32: [], torch.bfloat16: [], "by_case": {}}
        check_flash(torch, cuda, errs)
        checked = {"bfloat16": {f for f, d in errs["by_case"] if d == torch.bfloat16},
                   "float32": {f for f, d in errs["by_case"] if d == torch.float32}}
        serving = phase_sharded_serving(torch, cuda, {}, checked, one_card=False)
        print(json.dumps({"device": device["smi"], "sharded_4card": serving,
                          "train_4card": phase_train_4card(torch, trained)}))
        return 0
    t_start = time.perf_counter()

    def done(phase):
        log("time", f"{phase} done at {time.perf_counter() - t_start:.1f} s; {memory(torch)}")

    phase_build()
    done("phase 2 (build)")
    fed = Federation(torch, torch.device("cuda"))
    errs = {"proximity": [], "tsgemm": [], "wkv": [], "wkv_bwd": [], "wkv_rank": [],
            "wkv_bwd_by_label": {},
            "flash_attention": {torch.float32: [], torch.bfloat16: [], "by_case": {}},
            "flash_attention_bwd": {torch.float32: [], torch.bfloat16: [], "by_case": {}}}
    check_proximity(torch, fed, errs["proximity"])
    check_tsgemm(torch, fed.device, errs["tsgemm"])
    check_flash(torch, fed.device, errs["flash_attention"])
    check_flash_bwd(torch, fed.device, errs["flash_attention_bwd"])
    check_wkv(torch, fed.device, errs["wkv"], errs["wkv_rank"])
    check_wkv_bwd(torch, fed.device, errs["wkv_bwd"], errs["wkv_bwd_by_label"])
    done("phase 3 (kernels vs plain)")
    main_path = phase_main_path(torch, fed)
    any_rank = phase_any_rank(torch, fed.device)
    done("phases 4 and 4b (PACFL)")
    sharded = phase_sharded(torch, fed.device, main_path)
    done("phase 4c (sharded proximity)")
    fl = phase_fl(torch, fed.device, main_path)
    families = phase_families(torch, fed.device, main_path, fl)
    done("phases 5 and 9 (FL, model families)")
    # the PACFL (p = 3 and p = 16), FL and family paths' launches, each
    # counted from 0 over its run
    paths = (main_path, any_rank, fl, families)
    launches = dict(sum((collections.Counter(x["launches"]) for x in paths), collections.Counter()))
    routes = sum((collections.Counter(x["routes"]) for x in paths), collections.Counter())
    launches["proximity_by_route"] = {m: routes[("proximity", m)] for m in
                                      ("eq3", "eq2", "eq3_any_rank", "eq2_any_rank")}
    checked = {form for form, dtype in errs["flash_attention"]["by_case"]
               if dtype == torch.bfloat16}
    lm_outputs = {}
    lm_launches = phase_lm_serving(torch, fed.device, checked, lm_outputs)
    done("phase 6 (LM serving)")
    checked_by = {"bfloat16": checked, "float32": {
        form for form, dtype in errs["flash_attention"]["by_case"] if dtype == torch.float32}}
    tp_launches = phase_sharded_serving(torch, fed.device, lm_outputs, checked_by)
    del lm_outputs
    done("phase 6b (sharded serving)")
    phase_lm_float32(torch, fed.device)
    done("phase 7 (LM float32)")
    trained = {form for form, dtype in errs["flash_attention_bwd"]["by_case"]}
    training = phase_lm_training(torch, fed.device, trained)
    done("phase 10 (LM training)")
    phase_counted_training(torch, training)
    done("phase 10e (the dry run's count of phase 10's steps)")
    tp_train = phase_sharded_training(torch, fed.device, trained)
    log("train-4", f"{', '.join(r['label'] for r in TRAIN_4CARD)}: not run here: granite-8b, "
        f"zamba2-7b and gemma3-4b at full depth train over four cards under python3 "
        f"chip_smoke.py --sharded-4card (this machine has {device['count']})")
    done("phase 10d (sharded training)")
    shared_kv = phase_shared_kv(torch, fed.device, checked_by, trained)
    done("phase 10f (shared KV heads over 16 ranks)")
    rows = phase_timings(torch, fed, launches, errs)
    rows += lm_kernel_timings(torch, fed.device, lm_launches, errs)
    rows += family_flash_rows(torch, fed.device, lm_launches, errs)
    rows += family_flash_rows(torch, fed.device, tp_launches, errs,
                              cases=sharded_flash_timed(), key="sharded_run")
    rows += flash_bwd_rows(torch, fed.device, training, errs["flash_attention_bwd"])
    rows += sharded_train_rows(torch, fed.device, tp_train, errs)
    rows += shared_kv_rows(torch, fed.device, shared_kv, errs)
    rows += wkv_rank_rows(torch, fed.device, tp_launches, tp_train, errs)
    rows += wkv_bwd_rows(torch, fed.device, training, errs["wkv_bwd"])
    # phase 4c's window and times beside the proximity row's own counts
    next(r for r in rows if r["name"] == "proximity")["sharded"] = {
        "launches": sharded["launches"].get("proximity", 0), "cards": sharded["ndev"],
        "strips_of_one_card": SHARDED_STRIPS, "seconds": sharded["seconds"],
        "ms": {f"{k[0]} {k[1]}": v for k, v in sharded.items()
               if isinstance(k, tuple) and k[-1] == "ms"}}
    done("phase 8 (timings)")
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
