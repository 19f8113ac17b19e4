"""The LM model zoo's serving path: batched prefill and greedy decode.

Port of ``repro.models.lm`` for the families this slice carries: dense
global-attention models (tinyllama-1.1b, and llama3.2-3b and granite-8b,
which share its blocks) and RWKV6 (rwkv6-1.6b).  A model is a list of
*stages*, each ``repeats`` identical super-blocks; where the reference scans
over stacked parameters, the port loops over an ``nn.ModuleList`` (eager
PyTorch has no scan or remat to gain from).  Attention runs through the
flash-attention kernel and the WKV recurrence through the WKV kernel on
CUDA (:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.ssm`).

Modes: ``prefill`` (full sequence, fills the caches when given) and
``decode`` (one token at host-known position ``decode_pos``; KV caches are
updated in place).  The logits keep the padded vocabulary
(``cfg.vocab_padded``), as the reference's do.

Not ported yet, each raising ``NotImplementedError`` that names ROADMAP
Queue 1's "the rest of the LM zoo": MoE blocks, Mamba2 / zamba2, sliding-window ring caches
(gemma3), encoder-decoder (whisper), the vision stub (internvl2) and the
training step (``mode="train"``, ``lm_loss``, ``make_train_step``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.attention import NOT_PORTED, Attn, attend, init_attn, init_attn_cache
from repro_torch.models.layers import (
    MLP,
    dense_init,
    embed_init,
    init_mlp,
    mlp_apply,
    mm,
    param,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# Stage specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSpec:
    kind: str                  # "attn" | "mamba" | "rwkv"
    repeats: int               # super-blocks in the stage
    sub: tuple[str, ...]       # per-sublayer kinds: "global"|"local"|"m"|"rwkv"
    shared_attn: bool = False  # zamba2: shared attention after each super-block
    cross_attn: bool = False   # whisper decoder


def stages_for(cfg: ArchConfig) -> list[StageSpec]:
    if cfg.block_kind == "rwkv6":
        return [StageSpec("rwkv", cfg.n_layers, ("rwkv",))]
    if cfg.block_kind == "mamba2":
        if cfg.attn_every:
            full = cfg.n_layers // cfg.attn_every
            rem = cfg.n_layers - full * cfg.attn_every
            stages = [StageSpec("mamba", full, ("m",) * cfg.attn_every, shared_attn=True)]
            if rem:
                stages.append(StageSpec("mamba", rem, ("m",)))
            return stages
        return [StageSpec("mamba", cfg.n_layers, ("m",))]
    cross = cfg.is_enc_dec
    if cfg.swa_pattern is not None:
        n_local, n_global = cfg.swa_pattern
        blk = n_local + n_global
        full = cfg.n_layers // blk
        rem = cfg.n_layers - full * blk
        stages = [StageSpec("attn", full, ("local",) * n_local + ("global",) * n_global)]
        if rem:
            stages.append(StageSpec("attn", rem, ("local",)))
        return stages
    return [StageSpec("attn", cfg.n_layers, ("global",), cross_attn=cross)]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family this slice does not carry."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE blocks")
    if cfg.block_kind == "mamba2":
        missing.append("Mamba2 blocks")
    if cfg.swa_pattern is not None:
        missing.append("sliding-window ring caches")
    if cfg.is_enc_dec:
        missing.append("the encoder-decoder")
    if cfg.vision_tokens:
        missing.append("the vision stub")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    """Pre-norm attention + gated MLP block (the reference's keys)."""

    def __init__(self, ln1: torch.Tensor, attn: Attn, ln2: torch.Tensor, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = param(ln1), attn, param(ln2), mlp


class LM(nn.Module):
    """A model's parameters and its compute dtype.

    ``stages[si][r]`` is super-block ``r`` of stage ``si``: a ``ModuleDict``
    of sub-layers ``sub0, sub1, ...``, each the reference's stacked
    parameters at index ``r``.
    """

    def __init__(self, cfg: ArchConfig, compute_dtype: torch.dtype, embed: torch.Tensor,
                 lm_head: Optional[torch.Tensor], final_norm: torch.Tensor,
                 stages: list[list[dict]]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embed = param(embed)
        self.lm_head = None if lm_head is None else param(lm_head)
        self.final_norm = param(final_norm)
        self.stages = nn.ModuleList(
            nn.ModuleList(nn.ModuleDict(sb) for sb in stage) for stage in stages
        )


def _init_block(gen, cfg: ArchConfig, stage: StageSpec, device) -> nn.Module:
    d = cfg.d_model
    if stage.kind == "rwkv":
        return ssm.init_rwkv(gen, cfg, device)
    zeros = torch.zeros((d,), dtype=torch.float32, device=device)
    return AttnBlock(
        zeros.clone(),
        init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, device),
        zeros.clone(),
        init_mlp(gen, d, cfg.d_ff, device),
    )


def init_params(cfg: ArchConfig, *, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> LM:
    """The port's own seeded initialization (a ``torch.Generator`` on the
    device; ``device="meta"`` allocates nothing, for :mod:`repro_torch.convert`).

    The distributions are the reference's; the draws are not.  Weights of
    two or more dimensions are stored in ``dtype`` (the reference casts them
    to its compute dtype before use), vectors in float32.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    Vp, D = cfg.vocab_padded, cfg.d_model
    embed = embed_init(gen, Vp, D, dev)
    lm_head = None if cfg.tie_embeddings else dense_init(gen, D, Vp, dev, scale=D ** -0.5)
    stages = [
        [{f"sub{i}": _init_block(gen, cfg, stage, dev) for i in range(len(stage.sub))}
         for _ in range(stage.repeats)]
        for stage in stages_for(cfg)
    ]
    model = LM(cfg, dtype, embed, lm_head, torch.zeros((D,), device=dev), stages)
    for p in model.parameters():
        if p.ndim >= 2:
            p.data = p.data.to(dtype)
    return model


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(params: LM, batch: int, seq_len: int) -> list[list[dict]]:
    """One list per stage, one dict per super-block: ``{"sub0": {"kv":
    AttnCache}}`` for attention (in the compute dtype) or ``{"sub0":
    RWKVState}`` for RWKV6, on the parameters' device."""
    cfg = params.cfg
    device = params.embed.device
    caches = []
    for stage in stages_for(cfg):
        entries = []
        for _ in range(stage.repeats):
            entry = {}
            for i in range(len(stage.sub)):
                if stage.kind == "attn":
                    entry[f"sub{i}"] = {"kv": init_attn_cache(
                        batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                        dtype=params.compute_dtype, device=device)}
                else:
                    entry[f"sub{i}"] = ssm.init_rwkv_state(cfg, batch, device)
            entries.append(entry)
        caches.append(entries)
    return caches


# ---------------------------------------------------------------------------
# Block and stage application
# ---------------------------------------------------------------------------


def _apply_attn_block(p: AttnBlock, cfg: ArchConfig, x: torch.Tensor, *, kind: str,
                      q_pos: torch.Tensor, cache: Optional[dict],
                      decode_pos: Optional[int], dtype: torch.dtype):
    window = cfg.window if kind == "local" else None
    h = rmsnorm(x, p.ln1, cfg.norm_eps, dtype)
    attn_out, new_kv = attend(
        p.attn, h,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.resolved_head_dim,
        theta=cfg.rope_theta, q_pos=q_pos, causal=True, window=window,
        chunk=cfg.attn_chunk, cache=None if cache is None else cache["kv"],
        decode_pos=decode_pos, dtype=dtype,
    )
    x = x + attn_out
    h2 = rmsnorm(x, p.ln2, cfg.norm_eps, dtype)
    y = mlp_apply(p.mlp, h2, cfg.act, dtype)
    return x + y, None if cache is None else {"kv": new_kv}


def _apply_rwkv_block(p: ssm.RWKV, cfg: ArchConfig, x: torch.Tensor, *,
                      state: Optional[ssm.RWKVState], dtype: torch.dtype):
    h = rmsnorm(x, p.ln1, cfg.norm_eps, dtype)
    tm_out, state = ssm.rwkv_time_mix(p, cfg, h, state, dtype)
    x = x + tm_out
    h2 = rmsnorm(x, p.ln2, cfg.norm_eps, dtype)
    cm_out, state = ssm.rwkv_channel_mix(p, cfg, h2, state, dtype)
    return x + cm_out, state


def _apply_stage(stage_params: nn.ModuleList, stage: StageSpec, cfg: ArchConfig,
                 x: torch.Tensor, *, cache: Optional[list], q_pos: torch.Tensor,
                 decode_pos: Optional[int], dtype: torch.dtype):
    new_cache: Optional[list] = None if cache is None else []
    for r, superblock in enumerate(stage_params):
        entry = {}
        for i, kind in enumerate(stage.sub):
            p = superblock[f"sub{i}"]
            c = None if cache is None else cache[r][f"sub{i}"]
            if stage.kind == "attn":
                x, entry[f"sub{i}"] = _apply_attn_block(
                    p, cfg, x, kind=kind, q_pos=q_pos, cache=c,
                    decode_pos=decode_pos, dtype=dtype,
                )
            else:
                x, entry[f"sub{i}"] = _apply_rwkv_block(p, cfg, x, state=c, dtype=dtype)
        if new_cache is not None:
            new_cache.append(entry)
    return x, new_cache


# ---------------------------------------------------------------------------
# Full forward and steps
# ---------------------------------------------------------------------------


def forward(
    params: LM,
    tokens: torch.Tensor,                 # (B, S) integer
    *,
    mode: str = "prefill",                # prefill | decode
    cache: Optional[list] = None,
    decode_pos: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[list]]:
    """Returns (logits (B, S, vocab_padded) in the compute dtype, new cache)."""
    cfg = params.cfg
    check_supported(cfg)
    if mode == "train":
        raise NotImplementedError(f"the LM train step is not ported: {NOT_PORTED}")
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and (cache is None or decode_pos is None):
        raise ValueError("decode needs a cache and decode_pos")
    dtype = params.compute_dtype
    B, S = tokens.shape
    x = params.embed[tokens].to(dtype)
    if mode == "decode":
        q_pos = torch.full((1,), decode_pos, dtype=torch.int64, device=tokens.device)
    else:
        q_pos = torch.arange(S, dtype=torch.int64, device=tokens.device)
        decode_pos = None

    new_caches: Optional[list] = None if cache is None else []
    for si, stage in enumerate(stages_for(cfg)):
        x, nc = _apply_stage(
            params.stages[si], stage, cfg, x,
            cache=None if cache is None else cache[si],
            q_pos=q_pos, decode_pos=decode_pos, dtype=dtype,
        )
        if new_caches is not None:
            new_caches.append(nc)

    x = rmsnorm(x, params.final_norm, cfg.norm_eps, dtype)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return mm(x, head, dtype), new_caches


def make_prefill_step(max_len: Optional[int] = None):
    """prefill_step(params, tokens (B, S)) -> (last-position logits, cache
    sized for ``max_len`` tokens, default S)."""

    def prefill_step(params: LM, tokens: torch.Tensor):
        B, S = tokens.shape
        cache = init_cache(params, B, max_len or S)
        logits, cache = forward(params, tokens, mode="prefill", cache=cache)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step():
    """serve_step(params, cache, tokens (B, 1), pos) -> (logits, cache):
    one token at position ``pos`` against the cache."""

    def serve_step(params: LM, cache: list, tokens: torch.Tensor, pos: int):
        logits, cache = forward(params, tokens, mode="decode", cache=cache, decode_pos=pos)
        return logits[:, -1], cache

    return serve_step
