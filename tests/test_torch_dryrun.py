"""Port parity: ``launch/dryrun.py``'s per-rank bytes against the reference's plan.

For every architecture under ``fsdp_tp``, ``tp_only`` and ``ddp`` on the
reference's production meshes, 16x16 and 2x16x16: each rank's float32
parameter bytes equal what the reference's ``param_specs`` over
``ref_lm.abstract_params`` gives, each leaf's dimensions divided (rounded
up) by its axes' sizes, with no device.  A train step's AdamW state is
twice its float32 parameters.  granite-8b's train step does not fit 80 GB
a card over 4x1 ``ddp`` and does over 1x4 ``tp_only`` and 2x2 ``fsdp_tp``.
gemma3-4b's train step at 16x16 fits with its logits vocab-parallel and
would not with them gathered.  The launcher writes one JSON record a
combination.
"""
import functools
import json
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as ref_sharding
from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import lm

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = ref_get_config(arch)
    return cfg, ref_lm.abstract_params(cfg)


def _mamba_columns(cfg, name, m):
    """A rank's columns of a Mamba2 ``in_proj`` (z | x | B C | dt) or
    ``conv_w`` (x | B C) split over a model axis of ``m``: its heads' share
    of z, x and dt, and B and C whole, as the port executes the reference's
    plan (None for any other leaf)."""
    if cfg.block_kind != "mamba2" or name not in ("in_proj", "conv_w"):
        return None
    d_in = cfg.ssm_expand * cfg.d_model
    H, N = d_in // cfg.ssm_head_dim, cfg.ssm_state
    split = 2 * d_in + H if name == "in_proj" else d_in
    return -(-split // m) + 2 * N


def _head_columns(cfg, name, m):
    """A rank's columns of ``q``, ``k``, ``v`` (rows of ``o``) over a model
    axis of ``m`` by the head rule: whole KV heads, Hkv / m a rank or one
    shared by m / Hkv ranks, and model index 0's query heads (the most: a
    shared KV head's G query heads split with the larger pieces first);
    None for any other leaf."""
    if name not in ("q", "k", "v", "o"):
        return None
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if name in ("k", "v"):
        return hd * max(1, Hkv // m)
    if Hkv % m == 0:
        return hd * Hq // m
    return hd * -(-(Hq // Hkv) // (m // Hkv))


def _ref_bytes(arch, scheme, sizes):
    """Each rank's bytes of the reference's plan; Mamba2's ``in_proj`` and
    ``conv_w`` hold B and C whole over ``model`` (``_mamba_columns``), and
    attention's ``q``, ``k``, ``v`` and ``o`` whole heads
    (``_head_columns``)."""
    cfg, aparams = _abstract(arch)
    specs = ref_sharding.param_specs(aparams, cfg, scheme=scheme)
    total = 0
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(aparams)[0],
                                  jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        shape = list(leaf.shape)
        for dim, entry in enumerate(tuple(spec)):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            shape[dim] = -(-shape[dim] // math.prod(sizes[a] for a in axes))
            key = getattr(path[-1], "key", None)
            cols = _mamba_columns(cfg, key, sizes["model"])
            if cols is None:
                cols = _head_columns(cfg, key, sizes["model"])
            if entry == "model" and cols is not None:
                shape[dim] = cols
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("scheme", ["fsdp_tp", "tp_only", "ddp"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_bytes_match_reference_plan(arch, scheme, mesh):
    sizes = MESHES[mesh]
    got = dryrun.param_bytes(get_config(arch), sizes, scheme)
    assert got == _ref_bytes(arch, scheme, sizes)


def test_train_record_counts_adamw_and_fits():
    for mesh, scheme, fits in (("4x1", "ddp", False), ("1x4", "tp_only", True),
                               ("2x2", "fsdp_tp", True)):
        rec = dryrun.dryrun_one("granite-8b", "train_4k", mesh, scheme=scheme)
        parts = rec["bytes_per_rank"]
        assert parts["adamw_m_v"] == 2 * parts["params"] == 2 * parts["grads"]
        assert rec["card_bytes"] == 80e9 and "80 GB" in rec["card"]
        assert rec["fits"] is fits, (mesh, scheme, rec["total_bytes_per_rank"])
        assert rec["port_executes"] and rec["peak_bytes_per_rank"] >= rec["total_bytes_per_rank"]
    # 8.25 B float32 parameters, replicated over four data ranks
    ddp = dryrun.dryrun_one("granite-8b", "train_4k", "4x1", scheme="ddp")
    assert abs(ddp["bytes_per_rank"]["params"] / 4 / 8.25e9 - 1) < 0.01


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "gemma3-4b", "whisper-medium"])
def test_recurrent_and_encoder_families_execute(arch):
    """The families with Mamba2, RWKV6, sliding-window or cross-attention
    blocks execute their plans over 1x4 and 2x2, each rank's bytes counting
    a Mamba2 rank's B and C columns whole.  zamba2-7b's training state (6.75
    B parameters: 108 GB of float32 parameters, gradients and AdamW
    moments) fits no card alone and fits four."""
    for mesh, scheme in (("1x4", "tp_only"), ("2x2", "fsdp_tp")):
        rec = dryrun.dryrun_one(arch, "train_4k", mesh, scheme=scheme)
        assert rec["port_executes"] and rec["refusal"] is None, rec["refusal"]
        assert rec["bytes_per_rank"]["params"] == _ref_bytes(
            arch, scheme, dryrun.mesh_sizes(mesh))
        if arch == "zamba2-7b":
            assert rec["fits"], (mesh, rec["total_bytes_per_rank"])
    one = dryrun.dryrun_one(arch, "train_4k", "1x1", scheme="ddp")
    assert one["port_executes"]
    if arch == "zamba2-7b":
        assert not one["fits"] and 6.7e9 < one["bytes_per_rank"]["params"] / 4 < 6.8e9


def _gathered_loss(params, batch):
    """``lm.lm_loss`` with the whole vocabulary's logits gathered on every
    rank (``lm.forward``'s serving path), the loss the train step took
    before its vocab-parallel form."""
    tokens = batch["tokens"]
    logits, _, aux = lm.forward(params, tokens, mode="train", return_aux=True)
    logits = logits[:, :-1].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tokens[:, 1:, None])[..., 0]
    return torch.mean(logz - gold) + lm.AUX_LOSS_COEF * aux


def test_vocab_parallel_loss_fits_16x16(monkeypatch):
    """gemma3-4b's train_4k step on the reference's 16x16 mesh (16 rows of
    4096 tokens a rank, 262,144 vocabulary columns) never gathers its logits:
    its counted peak fits an 80 GB card with room, and its all-reduce over
    ``model`` is at least one float32 copy of the whole logits below the
    same step's with them gathered, whose peak does not fit."""
    def refuse(*args):
        raise AssertionError("the train step gathered its logits")

    with monkeypatch.context() as patched:
        patched.setattr(lm, "_gather_vocab", refuse)
        rec = dryrun.dryrun_one("gemma3-4b", "train_4k", "single")
    with monkeypatch.context() as patched:
        patched.setattr(lm, "lm_loss", _gathered_loss)
        gathered = dryrun.dryrun_one("gemma3-4b", "train_4k", "single")
    assert rec["roofline"]["fits_hbm"] and not gathered["roofline"]["fits_hbm"]
    assert rec["peak_bytes_per_rank"] < 30 * 2**30
    B, S, V = 16, 4096, get_config("gemma3-4b").vocab_padded
    model = rec["collectives"]["all-reduce over model"]["bytes"]
    assert model < 140e9
    assert gathered["collectives"]["all-reduce over model"]["bytes"] - model >= B * (S - 1) * V * 4


def test_serving_records_and_refusals():
    rec = dryrun.dryrun_one("llama3.2-3b", "decode_32k", "single", scheme="tp_only")
    # 128 rows over 16 data ranks; 8 KV heads over 16: each shared by two
    # ranks, one whole KV head's cache a rank (its 3 query heads split 2 / 1)
    cfg = get_config("llama3.2-3b")
    kv = 2 * cfg.n_layers * (128 // 16) * 32768 * 1 * cfg.resolved_head_dim * 2
    assert rec["bytes_per_rank"]["cache"] == kv
    assert rec["port_executes"] and rec["refusal"] is None and rec["roofline"] is not None
    # 8 KV heads and 3 ranks: neither divides, the plan is refused with the
    # reason and the caches counted whole
    refused = dryrun.dryrun_one("llama3.2-3b", "decode_32k", "1x3", scheme="tp_only")
    assert not refused["port_executes"] and "neither divides" in refused["refusal"]
    assert refused["roofline"] is None
    assert refused["bytes_per_rank"]["cache"] == 2 * cfg.n_layers * 128 * 32768 * (
        cfg.n_kv_heads * cfg.resolved_head_dim * 2)
    skip = dryrun.dryrun_one("granite-8b", "long_500k", "multi")
    assert skip["status"] == "skip" and skip["mesh"] == "2x16x16"


def test_cli_writes_json(tmp_path):
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k", "--mesh", "2x2",
                        "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert path.name == "granite-8b__train_4k__2x2__fsdp_tp.json"
    assert rec["status"] == "ok" and rec["fits"] and rec["ranks"] == 4
