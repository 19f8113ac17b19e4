"""Port parity: the sharding rules and the device mesh.

The port's plans (``repro_torch.sharding``: a tuple of axis names or None a
dimension, keyed by port parameter name) against the reference's
``PartitionSpec`` trees, leaf for leaf, at full width: both sides abstract
(the reference through ``jax.eval_shape``, the port on ``device="meta"``),
so nothing is allocated.  Every parameter of all ten configurations under
``fsdp_tp``, ``tp_only`` and ``ddp``; AdamW's state; batches and caches
with and without the pod axis, at batch 1 and 8, below and above the 8192
slots from which the reference shards a cache's sequence.  The reference's
stacked stage leaves map to the port's super-blocks through
``repro_torch.convert.lm_leaves`` (the converter's own walk), their leading
stacked ``None`` dropped.  Then the plans the port executes (every family),
the ones it refuses, each with its reason, a Mamba2 rank's component cut,
and the mesh helpers' own refusals.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as ref_sharding
from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.convert import lm_leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm, ssm
from repro_torch.models.layers import MeshAxis
from repro_torch.optim import adamw

SCHEMES = ("fsdp_tp", "tp_only", "ddp")


def _port_spec(ref_spec: P, index) -> tuple:
    """The reference's spec as the port writes it: its entries, the
    leading stacked ``None`` dropped for a stage leaf."""
    spec = tuple(ref_spec)
    if index is not None:
        assert spec[0] is None, spec
        spec = spec[1:]
    return spec


def _meta(arch):
    return lm.init_params(get_config(arch), device="meta")


def _ref_params(arch):
    return ref_lm.abstract_params(ref_get_config(arch))


def _by_port_name(model, ref_tree) -> dict:
    """{port name: the reference's spec for it}, every port parameter once."""
    out = {}
    for name, _, spec, index in lm_leaves(model, ref_tree):
        assert name not in out, name
        out[name] = _port_spec(spec, index)
    assert set(out) == {n for n, _ in model.named_parameters()}
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, scheme):
    model = _meta(arch)
    want = _by_port_name(model, ref_sharding.param_specs(_ref_params(arch), ref_get_config(arch),
                                                         scheme=scheme))
    got = sharding.param_specs(model, get_config(arch), scheme=scheme)
    assert got == want
    assert sharding.plan_for(get_config(arch), scheme) == got


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_specs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    aparams = _ref_params(arch)
    aopt = jax.eval_shape(ref_adamw(1e-3).init, aparams)
    ref = ref_sharding.opt_state_specs(aopt, aparams,
                                       ref_sharding.param_specs(aparams, ref_cfg))
    model = _meta(arch)
    state = adamw(1e-3).init(dict(model.named_parameters()))
    got = sharding.opt_state_specs(state, sharding.param_specs(model, cfg))
    assert set(got) == set(ref) == {"step", "m", "v"}
    assert got["step"] == tuple(ref["step"]) == ()
    for key in ("m", "v"):
        assert got[key] == _by_port_name(model, ref[key])
    # a moment the plan does not name is replicated, as the reference's is
    extra = sharding.opt_state_specs({"m": {"x": torch.zeros((3, 4), device="meta")}}, {})
    assert extra == {"m": {"x": (None, None)}}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium", "internvl2-26b"])
def test_batch_specs_match_reference(arch, multi_pod):
    cfg = get_config(arch)
    for B in (1, 8):
        shapes = {"tokens": (B, 128), "step": ()}
        if cfg.vision_tokens:
            shapes["vision_embeds"] = (B, cfg.vision_tokens, cfg.d_model)
        if cfg.is_enc_dec:
            shapes["encoder_frames"] = (B, cfg.encoder_seq, cfg.d_model)
        ref = ref_sharding.batch_specs(
            ref_get_config(arch), {k: jax.ShapeDtypeStruct(s, jax.numpy.float32)
                                   for k, s in shapes.items()},
            multi_pod=multi_pod, global_batch=B)
        got = sharding.batch_specs(cfg, {k: torch.empty(s, device="meta")
                                         for k, s in shapes.items()},
                                   multi_pod=multi_pod, global_batch=B)
        assert got == {k: tuple(v) for k, v in ref.items()}


def _flat(node, path=()):
    """(path, leaf) pairs of a cache tree or its spec tree: dicts by key,
    NamedTuples by field, lists by index."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, path + (k,))
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from _flat(v, path + (f,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flat(v, path + (i,))
    else:
        yield path, node


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_reference(arch, multi_pod):
    """Every cache leaf (KV caches and rings, cross caches, Mamba2 and RWKV6
    states) at 4096 and 32768 slots, batch 1 and 8."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model = _meta(arch)
    for B, S in ((8, 4096), (8, 32768), (1, 32768), (1, 4096)):
        acache = ref_lm.abstract_cache(ref_cfg, B, S)
        ref = ref_sharding.cache_specs(ref_cfg, acache, multi_pod=multi_pod, global_batch=B)
        cache = lm.init_cache(model, B, S)
        got = sharding.cache_specs(cfg, cache, multi_pod=multi_pod, global_batch=B)
        want = {}   # the reference's dicts come back with sorted keys: compare by path
        for si, stage_ref in enumerate(ref):
            ref_leaves = list(_flat(stage_ref))
            for r in range(len(cache[si])):
                want.update({(si, r) + path: _port_spec(spec, r) for path, spec in ref_leaves})
        got_leaves = dict(_flat(got))
        assert got_leaves == want
        shapes = dict(_flat(cache))
        for path, spec in got_leaves.items():   # every spec fits its leaf's rank
            assert len(spec) == shapes[path].ndim, path


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _reduced(arch, **changes):
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def test_plan_check_accepts_what_it_executes():
    cfg = _reduced("llama4-scout-17b-a16e", n_experts=16)
    for scheme in ("fsdp_tp", "tp_only"):
        assert sharding.check_plan(cfg, sharding.plan_for(cfg, scheme), {"data": 1, "model": 4})
    assert sharding.check_plan(cfg, sharding.plan_for(cfg, "tp_only"), {"data": 2, "model": 2})
    # FSDP and tensor parallelism together (training and serving alike)
    assert sharding.check_plan(cfg, sharding.plan_for(cfg, "fsdp_tp"), {"data": 2, "model": 2})
    assert not sharding.check_plan(cfg, sharding.plan_for(cfg, "fsdp_tp"),
                                   {"data": 2, "model": 1})
    # ddp shards no weight: every family, any mesh
    for arch in ("rwkv6-1.6b", "whisper-medium", "zamba2-7b"):
        c = _reduced(arch)
        assert not sharding.check_plan(c, sharding.plan_for(c, "ddp"), {"data": 2, "model": 2})
    assert not sharding.check_plan(cfg, sharding.plan_for(cfg, "tp_only"), {"data": 4, "model": 1})
    # KV heads fewer than the model axis's ranks: 4 KV heads over 8, each
    # shared by two ranks that split its query heads (sharding.attn_heads)
    tiny = _reduced("tinyllama-1.1b")
    assert sharding.check_plan(tiny, sharding.plan_for(tiny, "tp_only"), {"model": 8})


@pytest.mark.parametrize("case", [
    ("fsdp_tp over data 2", "tinyllama-1.1b", {"d_model": 255}, "fsdp_tp",
     {"data": 2, "model": 2}, r"embed: dim 1 \(255\)"),
    # 4 KV heads (of 8 query heads) and 3 ranks: neither divides the other
    ("query heads 8 over 3", "tinyllama-1.1b", {}, "tp_only", {"model": 3},
     "4 KV heads .* neither divides"),
    ("6 KV heads over 4", "tinyllama-1.1b", {"n_heads": 6, "n_kv_heads": 6}, "tp_only",
     {"model": 4}, "6 KV heads .* neither divides"),
    ("expert F 126 over 4", "qwen2-moe-a2.7b", {"expert_d_ff": 126}, "tp_only", {"model": 4},
     r"dim 2 \(126\)"),
    ("48 experts over 32", "llama4-scout-17b-a16e",
     {"n_experts": 48, "n_heads": 32, "n_kv_heads": 32}, "tp_only", {"model": 32},
     r"dim 0 \(48\)"),
    ("vocab_padded 512 over 3", "tinyllama-1.1b", {"n_heads": 6, "n_kv_heads": 3}, "tp_only",
     {"model": 3}, r"embed: dim 0 \(512\)"),
    # attention's 8 / 8 heads divide; 4 Mamba heads of 128 do not
    ("Mamba heads 4 over 8", "zamba2-7b", {"ssm_head_dim": 128}, "tp_only", {"model": 8},
     "4 Mamba heads"),
    ("WKV heads 4 over 8", "rwkv6-1.6b", {"rwkv_head_dim": 64}, "fsdp_tp",
     {"data": 2, "model": 8}, "4 WKV heads"),
], ids=lambda c: c[0])
def test_plan_check_refuses_what_does_not_divide(case):
    _, arch, changes, scheme, sizes, match = case
    cfg = _reduced(arch, **changes)
    with pytest.raises(ValueError, match=match):
        sharding.check_plan(cfg, sharding.plan_for(cfg, scheme), sizes)


@pytest.mark.parametrize("scheme,sizes", [("tp_only", {"model": 2}),
                                          ("fsdp_tp", {"data": 2, "model": 2})])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "gemma3-4b", "whisper-medium"])
def test_plan_check_accepts_the_recurrent_and_encoder_families(arch, scheme, sizes):
    """Mamba2 (with zamba2's shared attention block), RWKV6, the
    sliding-window rings and the encoder-decoder execute sharded, at reduced
    size and at full width, on a mesh that divides their heads."""
    for cfg in (_reduced(arch), get_config(arch)):
        assert sharding.check_plan(cfg, sharding.plan_for(cfg, scheme), sizes)
        # FSDP alone: no weight over model
        assert not sharding.check_plan(cfg, sharding.plan_for(cfg, scheme), {"data": 2})


def test_component_cut_is_what_the_mamba_forward_reads():
    """A rank's ``in_proj`` and ``conv_w`` (``mamba_parts``) give it its
    heads' z, x and dt and all of B and C of the unsharded projection, and
    its conv channels; ``local_shape`` counts B and C whole; the replicated
    vectors give it its heads' entries."""
    cfg = _reduced("zamba2-7b")
    d_in, hd, H, N = ssm.mamba_dims(cfg)
    m = 4
    block = lm.init_params(cfg, seed=1, dtype=torch.float32, device="cpu").stages[0][0]["sub0"]
    plan = sharding.plan_for(cfg, "tp_only")
    u = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(0))
    z, xbc, dt = ssm._split_proj(block, cfg, u, torch.float32)
    for i in range(m):
        coords, axis = {"model": (i, m)}, MeshAxis(None, m, i)
        piece = {}
        for name, t in block.named_parameters():
            full = f"stages.0.0.sub0.{name}"
            parts = sharding.mamba_parts(cfg, full)
            piece[name] = sharding.local_slice(t, plan[full], coords, parts)
            assert tuple(piece[name].shape) == sharding.local_shape(
                tuple(t.shape), plan[full], {"model": m}, parts), name
        w = ssm._mamba_weights(ssm.Mamba(**piece), cfg, axis)
        z_l, xbc_l, dt_l = ssm._split_proj(w, cfg, u, torch.float32, axis)
        ch, hs = slice(i * d_in // m, (i + 1) * d_in // m), slice(i * H // m, (i + 1) * H // m)
        assert torch.allclose(z_l, z[..., ch], rtol=0, atol=1e-6)
        assert torch.allclose(xbc_l, torch.cat([xbc[..., ch], xbc[..., d_in:]], -1), rtol=0,
                              atol=1e-6)
        assert torch.allclose(dt_l, dt[..., hs], rtol=0, atol=1e-6)
        conv = torch.cat([torch.arange(d_in)[ch], torch.arange(d_in, d_in + 2 * N)])
        assert torch.equal(w.conv_w, block.conv_w[:, conv])
        assert torch.equal(w.conv_b, block.conv_b[conv])
        for name in ("A_log", "D_skip", "dt_bias"):
            assert torch.equal(getattr(w, name), getattr(block, name)[hs])
        assert torch.equal(w.out_norm, block.out_norm[ch])
        assert torch.equal(w.out_proj, block.out_proj[ch])


def test_plan_check_refuses_other_layouts_and_names():
    cfg = _reduced("tinyllama-1.1b")
    plan = sharding.plan_for(cfg, "tp_only")
    with pytest.raises(ValueError, match="tp_only layout"):
        sharding.check_plan(cfg, {**plan, "embed": (None, None)}, {"model": 2})
    with pytest.raises(ValueError, match="plan names"):
        sharding.check_plan(cfg, {k: v for k, v in plan.items() if k != "lm_head"}, {"model": 2})
    with pytest.raises(ValueError, match="spec"):
        sharding.check_plan(cfg, {**plan, "final_norm": (None, None)}, {"model": 2})
    with pytest.raises(ValueError, match="unknown scheme"):
        sharding.plan_for(cfg, "zero3")
    q = "stages.0.0.sub0.attn.q"
    with pytest.raises(ValueError, match="several axes"):
        sharding.check_plan(cfg, {**plan, q: (("data", "model"), None)}, {"data": 2, "model": 2})
    with pytest.raises(ValueError, match="two dimensions over data"):
        sharding.check_plan(cfg, {**plan, q: ("data", "data")}, {"data": 2})


def test_local_slice_is_tensor_split():
    t = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    coords = {"pod": (1, 2), "data": (0, 2), "model": (2, 4)}
    got = sharding.local_slice(t, (("pod", "data"), None, "model"), coords)
    want = t.tensor_split(4, 0)[2].tensor_split(4, 2)[2]
    assert torch.equal(got, want)
    assert torch.equal(sharding.local_slice(t, (None, "data", None), {}), t)   # no such axis


def test_mesh_helpers():
    assert tmesh.mesh_device_count(1, 4) == 4 and tmesh.mesh_device_count(2, 4, pod=2) == 16
    assert tmesh.parse_mesh("2x4") == (2, 4) and tmesh.parse_mesh("1X1") == (1, 1)
    for bad in ("4", "0x2", "ax2", "1x2x2"):
        with pytest.raises(ValueError, match="DATAxMODEL"):
            tmesh.parse_mesh(bad)
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_mesh(1, 2, device_type="cpu")
    with pytest.raises(ValueError, match="nccl or gloo"):
        tmesh.init_ranks("mpi", rank=0, world_size=1)
