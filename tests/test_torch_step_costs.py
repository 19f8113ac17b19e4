"""The dry run's count of a step (``launch/step_costs.py``) and its roofline.

One rank's step runs on ``meta`` tensors and is counted.  On the CPU, at
``reduced()`` size unless said otherwise:

* FLOPs against the reference's: one attention (tinyllama-1.1b), one MoE
  (qwen2-moe-a2.7b), one Mamba2 (zamba2-7b) and one RWKV6 (rwkv6-1.6b)
  family, a train step (AdamW included) and a prefill on one device, the
  count within 5% of ``repro.launch.hlo_analysis.analyze_hlo`` over the
  compiled HLO of the reference's jitted step at the same shapes (FLOPs
  depend on shapes alone), at a sequence (64) where the attention or WKV
  core is under 5% of the step.  Two differences are the port's design and
  are added to its count: the reference's prefill forms every position's
  logits and keeps the last, the port forms only the last's; and the
  kernels count only the (query, key) pairs the mask leaves, where the
  reference's chunked attention computes every pair (that is the core
  kept under 5%);
* the kernel terms apart, against a direct count of valid (query, key)
  pairs (a loop over the queries) and of recurrence steps: 4 hd flops a
  pair forward, 10 hd backward; WKV 5 flops a step and state entry
  forward, 12 hd^2 + 2 T hd + 8 T hd a step backward;
* collectives against real ranks: at 2x2 ``fsdp_tp`` (ranks 0 and 3) and
  1x2 ``tp_only`` (both ranks) the ``meta`` rank's record equals, exactly
  and in order, what gloo CPU ranks record through the same hook
  (``count_collectives``) while they run the step (one ``run_ranks`` spawn
  of four, 2x2 then 1x2, in a thread beside the other tests);
* launches: a train step's counted kernel launches are
  ``lm.train_step_launches(cfg)``, a prefill's and a decode step's
  ``lm.attention_calls`` and ``lm.wkv_calls``, for every family;
* the roofline: its three terms by hand from a counted record, the
  rank-to-node mapping and the reference's ring factors;
* ``chip_smoke.py``'s bounds read the kernels' cost formulas and are what
  its own arithmetic gave before (the formulas it held, copied here);
* a train step's peak holds its state and its loss's float32 logits.

* the dry run's records (``launch/dryrun.py``) at the reference's
  production meshes, 16x16 and 2x16x16, every architecture at every input
  shape at full width, one super-block of each stage deep (the whole
  ``--all --mesh both`` at full depth takes minutes): ``check_plan``
  accepts every plan (KV heads fewer than 16 shared by replica groups),
  each with positive roofline terms, a counted peak at or above its
  plan-only bytes and a ``useful_ratio``.
"""
import dataclasses
import functools
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_step_costs_ranks as cost_ranks
from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.roofline import _RING as REF_RING
from repro.models import lm as ref_lm
from repro_torch import sharding
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels.wkv import wkv_bwd_plan
from repro_torch.launch import dryrun, roofline, step_costs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 0.05
CORE_SHARE = 0.05
B, S = 2, 64
FAMILIES = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "zamba2-7b", "rwkv6-1.6b")
SPAWN_TIMEOUT_S = 300.0
# (label, arch, scheme, kind, batch, seq): on 2x2, then on 1x2
QUAD = [("granite 2x2 fsdp_tp", "granite-8b", "fsdp_tp", "train", 4, 20),
        ("zamba2 2x2 fsdp_tp", "zamba2-7b", "fsdp_tp", "train", 4, 20),
        ("qwen2-moe 2x2 fsdp_tp", "qwen2-moe-a2.7b", "fsdp_tp", "train", 4, 20),
        # 4 query heads over one KV head: the two model ranks share it, and
        # its k and v gradients are summed over them (axis kv_replicas)
        ("tinyllama 4/1 heads 2x2 fsdp_tp", "tinyllama-1.1b", "fsdp_tp", "train", 4, 20,
         (("n_heads", 4), ("n_kv_heads", 1)))]
PAIR = [("rwkv6 1x2 tp_only", "rwkv6-1.6b", "tp_only", "train", 4, 20),
        ("gemma3 1x2 tp_only", "gemma3-4b", "tp_only", "train", 2, 20),
        ("whisper 1x2 tp_only prefill", "whisper-medium", "tp_only", "prefill", 2, 20)]


def _count(arch, kind, batch=B, seq=S, sizes=None, scheme="fsdp_tp", coords=None, changes=()):
    sizes = tuple((sizes or {"data": 1, "model": 1}).items())
    coords = None if coords is None else tuple(coords.items())
    return _counted(arch, kind, batch, seq, sizes, scheme, coords, changes)


@functools.lru_cache(maxsize=None)
def _counted(arch, kind, batch, seq, sizes, scheme, coords, changes=()):
    """count_step of ``arch`` at reduced() size, float32 (as the CPU runs),
    with ``changes`` ((field, value) pairs) to its configuration."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    return step_costs.count_step(cfg, InputShape(kind, seq, batch, kind), dict(sizes), scheme,
                                 None if coords is None else dict(coords),
                                 compute_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _reference_flops(arch, kind):
    """analyze_hlo's FLOPs of the reference's jitted step (shapes only)."""
    cfg = ref_get_config(arch).reduced()
    params = jax.eval_shape(lambda k: ref_lm.init_params(cfg, k), jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if kind == "train":
        opt = ref_optim.adamw(3e-4)
        args = (params, jax.eval_shape(opt.init, params), batch)
        step = ref_lm.make_train_step(cfg, opt)
    else:
        args = (params, batch)
        step = ref_lm.make_prefill_step(cfg)
    return analyze_hlo(jax.jit(step).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_match_reference(arch, kind):
    counted = _count(arch, kind)
    assert counted["kernel_flops"] < CORE_SHARE * counted["flops"], counted["kernels"]
    got = counted["flops"]
    if kind == "prefill":   # the reference's head over every position but the last
        cfg = get_config(arch).reduced()
        got += 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_padded
    want = _reference_flops(arch, kind)
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want, got / want)


def _pairs(Sq, Skv, causal=True, window=None):
    """Valid (query, key) pairs, one query at a time."""
    total = 0
    for i in range(Sq):
        keys = range(Skv) if not causal else range(min(i + 1, Skv))
        total += sum(1 for j in keys if window is None or j > i - window)
    return total


def _attention_flops(cfg, kind, batch, seq):
    """Each flash call's forward (and backward) FLOPs from a direct count of
    its pairs: the decoder's self-attention (local layers with the window),
    zamba2's shared block, whisper's encoder and cross attention."""
    hd, Hq = cfg.resolved_head_dim, cfg.n_heads
    fwd = 0.0
    for stage in lm.stages_for(cfg):
        if stage.kind == "attn":
            for sub in stage.sub:
                window = cfg.window if sub == "local" else None
                fwd += stage.repeats * _pairs(seq, seq, window=window)
                if stage.cross_attn:
                    fwd += stage.repeats * _pairs(seq, cfg.encoder_seq, causal=False)
        if stage.shared_attn:
            fwd += stage.repeats * _pairs(seq, seq)
    fwd += cfg.encoder_layers * _pairs(cfg.encoder_seq, cfg.encoder_seq, causal=False)
    per_pair = 4.0 * hd * Hq * batch
    if kind == "prefill":
        return fwd * per_pair
    return fwd * per_pair * 2 + fwd * 10.0 * hd * Hq * batch   # remat: forward twice


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "zamba2-7b",
                                  "gemma3-4b", "whisper-medium", "rwkv6-1.6b"])
def test_kernel_terms_match_direct_counts(arch, kind):
    cfg = get_config(arch).reduced()
    counted = _count(arch, kind)["kernels"]
    if cfg.block_kind == "rwkv6":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        steps = B * S * H * cfg.n_layers   # recurrence steps of every layer
        fwd = 5.0 * steps * hd * hd
        assert counted["wkv"]["flops"] == pytest.approx(fwd * (2 if kind == "train" else 1))
        if kind == "train":
            assert counted["wkv_bwd"]["flops"] == pytest.approx(
                steps * (12.0 * hd * hd + 2 * 16 * hd + 8 * 16 * hd))
        return
    want = _attention_flops(cfg, kind, B, S)
    got = sum(k["flops"] for name, k in counted.items() if name.startswith("flash"))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launches_match_model_counts(arch):
    cfg = get_config(arch).reduced()
    assert step_costs.launches(_count(arch, "train")) == lm.train_step_launches(cfg)
    for kind, prefill in (("prefill", True), ("decode", False)):
        want = {"flash_attention": lm.attention_calls(cfg, prefill), "wkv": lm.wkv_calls(cfg)}
        got = step_costs.launches(_count(arch, kind))
        assert got == {k: n for k, n in want.items() if n}, kind


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The gloo ranks' spawn, started with the module's first test and run
    in a thread beside the others."""
    store = tmp_path_factory.mktemp("step_costs")
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(run_ranks, cost_ranks.collectives_rank, 4, str(store), QUAD, PAIR,
                          backend="gloo", timeout=SPAWN_TIMEOUT_S, store_dir=str(store))


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned.result()


@pytest.mark.parametrize("case", QUAD + PAIR, ids=lambda c: c[0])
def test_collectives_match_real_ranks(ranks, case):
    label, arch, scheme, kind, batch, seq, *changes = case
    quad = case in QUAD
    sizes = {"data": 2, "model": 2} if quad else {"data": 1, "model": 2}
    for res in (ranks[::3] if quad else ranks[:2]):   # 2x2: ranks 0 and 3, apart on both axes
        coords = res["quad_coords" if quad else "pair_coords"]
        counted = _count(arch, kind, batch, seq, sizes, scheme, coords, *changes)
        assert res[label], label   # the step ran collectives
        assert counted["collective_log"] == res[label], (label, coords)


def test_roofline_terms():
    """build_report's three terms from a counted record by hand: the
    reference's ring factors, NVLink inside a node of 8 ranks, InfiniBand
    across nodes."""
    assert set(roofline.RING) == set(REF_RING)
    for kind, f in roofline.RING.items():
        assert all(f(g) == REF_RING[kind](g) for g in (2, 4, 16))
    single = {"data": 16, "model": 16}
    assert not roofline.spans_nodes({"data": 2, "model": 4}, "data")
    assert not roofline.spans_nodes(single | {"model": 8}, "model")
    assert roofline.spans_nodes(single, "model") and roofline.spans_nodes(single, "data")
    assert roofline.link_bw({"data": 2, "model": 4}, "model") == 450e9
    assert roofline.link_bw(single, "model") == 50e9
    sizes = {"data": 2, "model": 2}
    cfg = get_config("granite-8b").reduced()
    shape = InputShape("train", 20, 4, "train")
    counted = _count("granite-8b", "train", 4, 20, sizes)
    links = {"data": 450e9, "model": 50e9}
    r = roofline.build_report(arch="granite-8b", shape_name="t", mesh_name="2x2", n_chips=4,
                              counted=counted, cfg=cfg, shape=shape, links=links)
    coll = sum(c["bytes"] * (2 if c["kind"] == "all-reduce" else 1) * (2 - 1) / 2
               / links[c["axis"]] for c in counted["collective_log"])
    assert r.compute_s == pytest.approx(counted["flops"] / 989e12)
    assert r.memory_s == pytest.approx(counted["bytes"] / 3.35e12)
    assert r.collective_s == pytest.approx(coll) and coll > 0
    assert r.dominant == max(("compute", "memory", "collective"),
                             key=lambda t: getattr(r, f"{t}_s"))
    assert r.useful_ratio == pytest.approx(roofline.model_flops(cfg, shape) / 4 / counted["flops"])
    assert r.bytes_per_device == counted["peak_bytes"] and r.fits_hbm
    assert sum(r.collective_counts.values()) == len(counted["collective_log"])


def _old_pairs(Sq, Skv, causal, window, q_offset):
    total = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(Skv, pos + 1) if causal else Skv
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def test_chip_smoke_bounds_unchanged():
    """chip_smoke.py's bounds, now read from the kernels' cost formulas,
    against the arithmetic it held before them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c

    for _, dims, causal, window in c.TRAINED_FORMS:
        B_, Sq, Skv, Hq, Hkv, hd = dims
        pairs = _old_pairs(Sq, Skv, causal, window, 0)
        assert c.flash_bwd_bound(dims, causal, window) == c.bound(
            2.0 * (4 * B_ * Sq * Hq * hd + 4 * B_ * Skv * Hkv * hd) + 4.0 * B_ * Hq * Sq,
            10.0 * B_ * Hq * hd * pairs, c.PEAK_BF16_FLOPS)
    for case in c.FAMILY_FLASH:
        _, _, (B_, Sq, Skv, Hq, Hkv, hd), causal, window, q_off, _ = case
        pairs = _old_pairs(Sq, Skv, causal, window, q_off)
        assert c.flash_fwd_bound((B_, Sq, Skv, Hq, Hkv, hd), causal, window, q_off) == c.bound(
            2.0 * (2 * B_ * Sq * Hq * hd + 2 * B_ * Skv * Hkv * hd),
            4.0 * B_ * Hq * hd * pairs, c.PEAK_BF16_FLOPS)
    Bl, Sl, pos = c.LM_BATCH, c.LM_PROMPT, c.LM_PROMPT + c.LM_TOKENS - 1
    for Hq, Hkv, hd in ((32, 4, 64), (24, 8, 128)):
        assert c.flash_fwd_bound((Bl, Sl, Sl, Hq, Hkv, hd)) == c.bound(
            2.0 * (2 * Bl * Sl * Hq * hd + 2 * Bl * Sl * Hkv * hd),
            4.0 * Bl * Hq * hd * Sl * (Sl + 1) / 2, c.PEAK_BF16_FLOPS)
    keys = pos + 1
    assert c.flash_fwd_bound((Bl, 1, keys, 32, 4, 64), q_offset=pos) == c.bound(
        2.0 * (2 * Bl * 32 * 64 + 2 * Bl * keys * 4 * 64), 4.0 * Bl * 32 * 64 * keys,
        c.PEAK_BF16_FLOPS)
    for H, rkv in ((32, 2), (8, 2), (32, 4)):
        n = Bl * Sl * H * 64
        assert c.wkv_bound(Bl, Sl, H, 64, rkv_bytes=2) == c.bound(
            2.0 * 3 * n + 4.0 * (2 * n + H * 64 + Bl * H * 64 * 64), 5.0 * n * 64)
        n1 = Bl * H * 64
        assert c.wkv_decode_bound(Bl, H, 64, rkv) == c.bound(
            rkv * 3.0 * n1 + 4.0 * (2 * n1 + H * 64 + 2 * Bl * H * 64 * 64), 5.0 * n1 * 64)
    for dims in (c.WKV_BWD_TIMED, (4, 1024, 8, 64)):
        Bw, Sw, H, hd = dims
        n = Bw * Sw * H * hd
        starts = Bw * H * wkv_bwd_plan(Sw).n_chunks * hd * hd
        nbytes = 2 * 3.0 * n + 4.0 * (2 * n + H * hd + starts) + 4.0 * (
            4 * n + H * hd + Bw * H * hd * hd)
        steps = Bw * Sw * H
        t_tc = (12.0 * hd + 2.0 * 16) * steps * hd / c.PEAK_3XTF32_FLOPS * 1e3
        t_fp32 = 8.0 * 16 * steps * hd / c.PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / c.PEAK_BYTES_PER_S * 1e3
        assert c.wkv_bwd_bound(*dims, rkv_bytes=2) == max(
            (t_bytes, "bytes"), (max(t_tc, t_fp32), "operations"))
        assert c.wkv_bwd_bound_stepwise(*dims, rkv_bytes=2) == c.bound(
            nbytes, 12.0 * Bw * Sw * H * hd * hd)


def test_peak_counts_the_state_and_the_logits():
    """A train step's peak holds at least its parameters, gradients and
    AdamW moments, and the float32 logits of its loss."""
    cfg = get_config("gemma3-4b").reduced()
    counted = _count("gemma3-4b", "train", 2, 64)
    n = sum(p.numel() for p in lm.init_params(cfg, device="meta").parameters())
    logits = 2 * 63 * cfg.vocab_padded * 4
    assert counted["peak_bytes"] >= 4 * n * 4 + logits
    assert math.isfinite(counted["bytes"]) and counted["bytes"] > 0


def _one_superblock(cfg):
    """``cfg`` at full width, one super-block of each stage deep (gemma3's 5
    local + 1 global layers, zamba2's 6 Mamba2 layers and its shared block,
    one encoder layer)."""
    layers = sum(cfg.swa_pattern) if cfg.swa_pattern else (cfg.attn_every or 1)
    return dataclasses.replace(cfg, n_layers=layers, encoder_layers=min(cfg.encoder_layers, 1))


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_records_at_the_production_meshes(mesh):
    sizes = dryrun.mesh_sizes(mesh)
    accepted = 0
    for arch in ARCH_NAMES:
        full = get_config(arch)
        cfg = _one_superblock(full)
        for shape in INPUT_SHAPES:
            rec = dryrun.record(cfg, shape, sizes, "fsdp_tp")
            if dryrun.skip_reason(full, INPUT_SHAPES[shape]):
                assert rec["status"] == "skip"
                continue
            assert rec["port_executes"] and rec["refusal"] is None, (arch, shape)
            r = rec["roofline"]
            accepted += 1
            assert min(r["compute_s"], r["memory_s"], r["collective_s"]) > 0, (arch, shape, r)
            assert r["dominant"] == max(("compute", "memory", "collective"),
                                        key=lambda t: r[f"{t}_s"])
            assert r["bytes_per_device"] == rec["peak_bytes_per_rank"]
            assert rec["peak_bytes_per_rank"] >= rec["total_bytes_per_rank"], (arch, shape)
            assert r["useful_ratio"] > 0 and r["step_flops"] > 0 and r["step_bytes"] > 0
            assert rec["collectives"] and rec["top_ops"] and rec["top_bytes"]
            assert "sequence" in r["note"] or "residual" in r["note"]
    # every record but the 7 long_500k skips of full-attention architectures
    assert accepted == {"single": 33, "multi": 33}[mesh]
