"""The LM model zoo: training, batched prefill and greedy decode.

Port of ``repro.models.lm`` for all ten configurations: dense global
attention (tinyllama-1.1b, llama3.2-3b, granite-8b), sliding-window local
layers with ring caches (gemma3-4b, 5 local : 1 global), MoE blocks
(qwen2-moe-a2.7b, llama4-scout-17b-a16e), Mamba2 with one shared attention
block applied after each super-block (zamba2-7b), RWKV6 (rwkv6-1.6b), the
encoder-decoder with cross-attention (whisper-medium) and the vision stub,
whose embeddings overwrite the prompt's leading positions
(internvl2-26b, llama4-scout).

A model is a list of *stages*, each ``repeats`` identical super-blocks;
where the reference scans over stacked parameters, the port loops over an
``nn.ModuleList``; in training each super-block runs under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint`` of its scan body).  Attention runs through the
flash-attention kernels and the WKV recurrence through the WKV kernel on
CUDA (:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.ssm`);
MoE and Mamba2 are plain PyTorch, as the reference computes them outside
its Pallas kernels.

Modes: ``train`` (full sequence, no cache, the MoE blocks' Switch loss
summed over every attention block), ``prefill`` (full sequence, fills the
caches when given) and ``decode`` (one token at host-known position
``decode_pos``; caches are updated in place).  The logits keep the padded
vocabulary (``cfg.vocab_padded``), as the reference's do.
:func:`lm_loss` is the next-token cross entropy in float32 plus
``AUX_LOSS_COEF`` times the Switch loss, and :func:`make_train_step` one
optimizer step over it (:mod:`repro_torch.optim`), with gradient
accumulation over microbatches.  A model that trains keeps float32 masters
(``init_params(dtype=torch.float32, compute_dtype=...)``) and computes in
its compute dtype, each weight cast where it is used.

Sharded (tensor and expert parallel over a mesh's model axis,
:mod:`repro_torch.sharding`), a model holds one rank's slices and its
``model_axis``; activations are replicated over the axis (Megatron-style).
The embedding is vocab-parallel (ids outside the rank's rows give zero
rows, summed over the axis: exact), attention head-parallel, the MLP and
MoE as :mod:`repro_torch.models.layers` and :mod:`repro_torch.models.moe`
say, and the head vocab-parallel.  The train step's loss takes the rank's
logits columns as they are (:func:`cross_entropy`: each position's
logsumexp put together over the axis from the ranks', the gold logit from
the rank holding it), so no rank forms the whole vocabulary's logits;
serving gathers one position's by summing disjoint slices into a zeroed
buffer (exact).  Every collective is an autograd Function
(:class:`repro_torch.models.layers.MeshAxis`), so a sharded model trains: each replicated leaf's gradient comes out whole on every model
rank, each sharded leaf's as the rank's slice.  Weights held as the rank's
piece over the data axis (``fsdp``, FSDP) are gathered inside each
super-block, under its checkpoint, so only one super-block's whole weights
live at a time and the recomputation gathers them again.  The batch's rows
split over ``row_axes``: :func:`value_and_grad` averages the loss and the
gradients over them, and the MoE blocks' Switch loss reads the whole
batch.  Every family runs sharded: Mamba2 and RWKV6 blocks on the rank's
heads (:mod:`repro_torch.models.ssm`), zamba2's shared attention block
and whisper's encoder and cross attention head-parallel like any
attention, the recurrent states and ring caches at the rank's heads.
Where the KV heads are fewer than the model axis's ranks, each is held
whole by a replica group that splits its query heads
(``sharding.attn_heads``; a rank may hold none): its cache is on every
rank of the group, and its k and v gradients, each rank's from its own
query heads, are summed over the group (``kv_axis``), so the replicas
step alike.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.attention import (
    Attn,
    attend,
    cross_prefill,
    init_attn,
    init_attn_cache,
)
from repro_torch.models.layers import (
    MLP,
    Fsdp,
    Keep,
    MeshAxis,
    dense_init,
    embed_init,
    init_mlp,
    keep_all,
    mlp_apply,
    mm,
    param,
    rmsnorm,
    scoped,
)
from repro_torch.models.moe import MoE, init_moe, moe_apply

AUX_LOSS_COEF = 0.01

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


def encoder_stages(cfg: ArchConfig) -> list[StageSpec]:
    return [StageSpec("attn", cfg.encoder_layers, ("global",))]


def rank_heads(cfg: ArchConfig, axis: Optional[MeshAxis]) -> tuple[int, int]:
    """(query heads, KV heads) of attention a rank holds on the model
    ``axis`` (``sharding.attn_heads``; the whole model's without one)."""
    if axis is None:
        return cfg.n_heads, cfg.n_kv_heads
    from repro_torch.sharding import attn_heads

    (_, n_q), (_, n_kv) = attn_heads(cfg, axis.size, axis.rank)
    return n_q, n_kv


def attention_calls(cfg: ArchConfig, prefill: bool, model: tuple[int, int] = (1, 0)) -> int:
    """Attention calls (flash launches on the card) in one forward: one per
    attention layer, two with cross-attention, one per application of the
    shared block, and at prefill one per encoder layer; none on a rank of
    a model axis (``model``: its size and the rank's index) that holds no
    query head."""
    calls = 0
    for stage in stages_for(cfg):
        if stage.kind == "attn":
            calls += stage.repeats * len(stage.sub) * (2 if stage.cross_attn else 1)
        calls += stage.repeats if stage.shared_attn else 0
    calls += cfg.encoder_layers if prefill else 0
    if calls and model[0] > 1 and rank_heads(cfg, MeshAxis(None, *model))[0] == 0:
        return 0
    return calls


def wkv_calls(cfg: ArchConfig) -> int:
    """WKV calls (WKV kernel launches on the card) in one forward: one per
    RWKV6 layer."""
    return sum(stage.repeats * len(stage.sub) for stage in stages_for(cfg)
               if stage.kind == "rwkv")


def train_step_launches(cfg: ArchConfig, model: tuple[int, int] = (1, 0)) -> dict:
    """Kernel launches of one training step on the card (one
    :func:`value_and_grad`), by kernel: each attention and WKV call's
    forward kernel once, twice with ``cfg.remat`` (the super-block runs
    again in the backward), and its backward kernel once; on a rank of a
    model axis (``model``: its size and the rank's index), its own
    (:func:`attention_calls`).  Kernels the model does not call are left
    out."""
    forwards = 2 if cfg.remat else 1
    out = {}
    attn, rwkv = attention_calls(cfg, True, model), wkv_calls(cfg)
    if attn:
        out.update(flash_attention=forwards * attn, flash_attention_bwd=attn)
    if rwkv:
        out.update(wkv=forwards * rwkv, wkv_bwd=rwkv)
    return out


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    """Pre-norm attention block (the reference's keys): ``ln1``, ``attn``,
    ``ln2`` and either ``mlp`` or ``moe``; with cross-attention also
    ``lnx`` and ``xattn``."""

    def __init__(self, ln1: torch.Tensor, attn: Attn, ln2: torch.Tensor, *,
                 mlp: Optional[MLP] = None, moe: Optional[MoE] = None,
                 lnx: Optional[torch.Tensor] = None, xattn: Optional[Attn] = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("an attention block takes exactly one of mlp and moe")
        if (lnx is None) != (xattn is None):
            raise ValueError("cross-attention takes both lnx and xattn")
        self.ln1, self.attn, self.ln2 = param(ln1), attn, param(ln2)
        self.mlp, self.moe = mlp, moe
        self.lnx = None if lnx is None else param(lnx)
        self.xattn = xattn


def _stage_list(stages: list[list[dict]]) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleList(nn.ModuleDict(sb) for sb in stage) for stage in stages)


class Encoder(nn.Module):
    """The encoder of an encoder-decoder: its own ``stages`` and ``final_norm``."""

    def __init__(self, final_norm: torch.Tensor, stages: list[list[dict]]):
        super().__init__()
        self.final_norm = param(final_norm)
        self.stages = _stage_list(stages)


class LM(nn.Module):
    """A model's parameters and its compute dtype (the dtype of its
    activations and products; weights of two or more dimensions are cast
    to it where they are used, so they may be stored wider).

    ``stages[si][r]`` is super-block ``r`` of stage ``si``: a ``ModuleDict``
    of sub-layers ``sub0, sub1, ...``, each the reference's stacked
    parameters at index ``r``.  ``shared_attn`` is zamba2's one shared
    attention block, ``encoder`` whisper's encoder.  ``model_axis`` is
    None, or the mesh axis a sharded model's slices are spread over;
    ``row_axes`` the mesh axes the batch's rows split over; ``fsdp`` None,
    or the weights held as the rank's piece over the data axis;
    ``kv_axis`` None, or the replica group sharing the rank's KV head
    (:mod:`repro_torch.sharding` sets all four).
    """

    def __init__(self, cfg: ArchConfig, compute_dtype: torch.dtype, embed: torch.Tensor,
                 lm_head: Optional[torch.Tensor], final_norm: torch.Tensor,
                 stages: list[list[dict]], *, shared_attn: Optional[AttnBlock] = None,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embed = param(embed)
        self.lm_head = None if lm_head is None else param(lm_head)
        self.final_norm = param(final_norm)
        self.stages = _stage_list(stages)
        self.shared_attn = shared_attn
        self.encoder = encoder
        self.model_axis: Optional[MeshAxis] = None
        self.row_axes: tuple[MeshAxis, ...] = ()
        self.fsdp: Optional[Fsdp] = None
        self.kv_axis: Optional[MeshAxis] = None


def _init_attn_block(gen, cfg: ArchConfig, cross: bool, device, moe: bool,
                     keep: Keep = keep_all) -> AttnBlock:
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def attn(name):
        return init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, device,
                         keep=scoped(keep, f"{name}."))

    ffn = ({"moe": init_moe(gen, cfg, device, keep=scoped(keep, "moe."))} if moe
           else {"mlp": init_mlp(gen, d, cfg.d_ff, device, keep=scoped(keep, "mlp."))})
    xattn = {"lnx": zeros(), "xattn": attn("xattn")} if cross else {}
    return AttnBlock(zeros(), attn("attn"), zeros(), **ffn, **xattn)


def _to_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Weights of two or more dimensions in ``dtype``, vectors stay float32."""
    for p in module.parameters():
        if p.ndim >= 2:
            p.data = p.data.to(dtype)
    return module


def _init_block(gen, cfg: ArchConfig, stage: StageSpec, device, dtype,
                keep: Keep = keep_all) -> nn.Module:
    if stage.kind == "rwkv":
        block = ssm.init_rwkv(gen, cfg, device, keep)
    elif stage.kind == "mamba":
        block = ssm.init_mamba(gen, cfg, device, keep)
    else:
        block = _init_attn_block(gen, cfg, stage.cross_attn, device, cfg.is_moe, keep)
    return _to_dtype(block, dtype)


def _init_stages(gen, cfg: ArchConfig, specs: list[StageSpec], device, dtype,
                 keep: Keep = keep_all, prefix: str = "stages."):
    return [
        [{f"sub{i}": _init_block(gen, cfg, stage, device, dtype,
                                 scoped(keep, f"{prefix}{si}.{r}.sub{i}."))
          for i in range(len(stage.sub))}
         for r in range(stage.repeats)]
        for si, stage in enumerate(specs)
    ]


def init_params(cfg: ArchConfig, *, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None,
                compute_dtype: Optional[torch.dtype] = None, keep: Keep = keep_all) -> LM:
    """The port's own seeded initialization (a ``torch.Generator`` on the
    device; ``device="meta"`` allocates nothing, for :mod:`repro_torch.convert`).

    The distributions are the reference's; the draws are not.  Weights of
    two or more dimensions are stored in ``dtype``, vectors in float32: the
    reference casts every per-super-block weight of two or more dimensions
    (``conv_w`` too) to its compute dtype before use, and its matmuls cast
    the embedding, the head and the shared attention block's weights, so
    the same products round the same way.  Each block is cast as it is
    made, so the float32 draws of only one block are held at a time.
    ``compute_dtype`` (default ``dtype``) is the dtype the model computes
    in: training keeps float32 masters (``dtype=torch.float32``) and
    computes in bfloat16 on the card, as the reference does.  ``keep``
    (:data:`repro_torch.models.layers.Keep`) takes every drawn weight by
    its parameter name and returns the part the model holds (a sharded
    init's slice, :func:`repro_torch.sharding.init_params_sharded`); the
    draws do not change.
    """
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    Vp, D = cfg.vocab_padded, cfg.d_model
    embed = keep("embed", embed_init(gen, Vp, D, dev)).to(dtype)
    lm_head = (None if cfg.tie_embeddings
               else keep("lm_head", dense_init(gen, D, Vp, dev, scale=D ** -0.5)).to(dtype))
    specs = stages_for(cfg)
    stages = _init_stages(gen, cfg, specs, dev, dtype, keep)
    shared = None
    if any(s.shared_attn for s in specs):
        # one set of shared-attention-block params (zamba2), never MoE
        shared = _to_dtype(_init_attn_block(gen, cfg, False, dev, moe=False,
                                            keep=scoped(keep, "shared_attn.")), dtype)
    encoder = None
    if cfg.is_enc_dec:
        encoder = Encoder(torch.zeros((D,), device=dev),
                          _init_stages(gen, cfg, encoder_stages(cfg), dev, dtype, keep,
                                       prefix="encoder.stages."))
    return LM(cfg, compute_dtype or dtype, embed, lm_head, torch.zeros((D,), device=dev),
              stages, shared_attn=shared, encoder=encoder)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _cache_len(cfg: ArchConfig, kind: str, seq_len: int) -> int:
    if kind == "local":
        return min(cfg.window, seq_len)
    return seq_len


def init_cache(params: LM, batch: int, seq_len: int) -> list[list[dict]]:
    """One list per stage, one dict per super-block, on the parameters'
    device: ``{"sub0": {"kv": AttnCache}}`` for attention (a ring of
    ``min(window, seq_len)`` slots for a local layer; with ``"cross"``, the
    cross-attention cache of ``encoder_seq`` slots padded to a multiple of
    128), ``{"sub0": MambaState}`` or ``RWKVState`` for the recurrent
    blocks, and ``"shared": {"kv": AttnCache}`` for each application of the
    shared attention block.  KV caches are in the compute dtype."""
    cfg = params.cfg
    device = params.embed.device
    dtype = params.compute_dtype
    hd = cfg.resolved_head_dim
    # a sharded model's cache holds the rank's KV heads (a shared one on
    # every rank of its group), its recurrent states the rank's heads
    axis = params.model_axis

    def kv(slots):
        return init_attn_cache(batch, slots, rank_heads(cfg, axis)[1], hd, dtype=dtype,
                               device=device)

    caches = []
    for stage in stages_for(cfg):
        entries = []
        for _ in range(stage.repeats):
            entry = {}
            for i, kind in enumerate(stage.sub):
                if stage.kind == "attn":
                    entry[f"sub{i}"] = {"kv": kv(_cache_len(cfg, kind, seq_len))}
                    if stage.cross_attn:
                        entry[f"sub{i}"]["cross"] = kv(cfg.encoder_seq + (-cfg.encoder_seq) % 128)
                elif stage.kind == "mamba":
                    entry[f"sub{i}"] = ssm.init_mamba_state(cfg, batch, dtype, device, axis)
                else:
                    entry[f"sub{i}"] = ssm.init_rwkv_state(cfg, batch, device, axis)
            if stage.shared_attn:
                entry["shared"] = {"kv": kv(seq_len)}
            entries.append(entry)
        caches.append(entries)
    return caches


# ---------------------------------------------------------------------------
# Block and stage application
# ---------------------------------------------------------------------------


def _apply_attn_block(p: AttnBlock, cfg: ArchConfig, x: torch.Tensor, *, kind: str,
                      q_pos: torch.Tensor, cache: Optional[dict],
                      decode_pos: Optional[int], enc_out: Optional[torch.Tensor],
                      dtype: torch.dtype, causal: bool = True,
                      axis: Optional[MeshAxis] = None, rows: tuple = ()):
    window = cfg.window if kind == "local" else None
    n_q, n_kv = rank_heads(cfg, axis)   # the rank's heads (sharding.attn_heads)
    heads = dict(n_heads=n_q, n_kv=n_kv, hd=cfg.resolved_head_dim, axis=axis)
    h = rmsnorm(x, p.ln1, cfg.norm_eps, dtype)
    attn_out, _ = attend(
        p.attn, h, **heads,
        theta=cfg.rope_theta, q_pos=q_pos, causal=causal, window=window,
        chunk=cfg.attn_chunk, cache=None if cache is None else cache["kv"],
        decode_pos=decode_pos, dtype=dtype,
    )
    x = x + attn_out

    if p.xattn is not None:
        hx = rmsnorm(x, p.lnx, cfg.norm_eps, dtype)
        if decode_pos is not None:
            # cross K/V already cached (projected at prefill)
            out, _ = attend(
                p.xattn, hx, **heads,
                theta=cfg.rope_theta, q_pos=q_pos, chunk=cfg.attn_chunk,
                cache=cache["cross"], cross_len=cfg.encoder_seq, dtype=dtype,
            )
        else:
            out = cross_prefill(
                p.xattn, hx, enc_out, **heads, q_pos=q_pos, chunk=cfg.attn_chunk,
                cache=None if cache is None else cache["cross"], dtype=dtype,
            )
        x = x + out

    h2 = rmsnorm(x, p.ln2, cfg.norm_eps, dtype)
    if p.moe is not None:
        y, aux = moe_apply(p.moe, h2, cfg, dtype, axis, rows)
    else:
        y, aux = mlp_apply(p.mlp, h2, cfg.act, dtype, axis), None
    return x + y, cache, aux


def _apply_mamba_block(p: ssm.Mamba, cfg: ArchConfig, x: torch.Tensor, *,
                       state: Optional[ssm.MambaState], decode: bool, dtype: torch.dtype,
                       axis: Optional[MeshAxis] = None):
    h = rmsnorm(x, p.ln, cfg.norm_eps, dtype)
    if decode:
        out, state = ssm.mamba_decode(p, cfg, h, state, dtype, axis)
    elif state is not None:  # prefill: outputs + final recurrent state
        out, state = ssm.mamba_ssd(p, cfg, h, dtype, return_state=True, axis=axis)
    else:
        out = ssm.mamba_ssd(p, cfg, h, dtype, axis=axis)
    return x + out, state


def _apply_rwkv_block(p: ssm.RWKV, cfg: ArchConfig, x: torch.Tensor, *,
                      state: Optional[ssm.RWKVState], dtype: torch.dtype,
                      axis: Optional[MeshAxis] = None):
    h = rmsnorm(x, p.ln1, cfg.norm_eps, dtype)
    tm_out, state = ssm.rwkv_time_mix(p, cfg, h, state, dtype, axis)
    x = x + tm_out
    h2 = rmsnorm(x, p.ln2, cfg.norm_eps, dtype)
    cm_out, state = ssm.rwkv_channel_mix(p, cfg, h2, state, dtype, axis)
    return x + cm_out, state


def _superblock(superblock: nn.ModuleDict, stage: StageSpec, cfg: ArchConfig,
                x: torch.Tensor, *, entry_cache: Optional[dict], q_pos: torch.Tensor,
                decode_pos: Optional[int], enc_out: Optional[torch.Tensor],
                shared_attn: Optional[AttnBlock], dtype: torch.dtype, causal: bool,
                axis: Optional[MeshAxis] = None, rows: tuple = ()):
    """One super-block: its sub-layers, then the shared attention block
    where the stage has one.  Returns (x, cache entry, Switch loss summed
    over its MoE blocks, float32, or None without one)."""
    entry = {}
    aux = None
    for i, kind in enumerate(stage.sub):
        p = superblock[f"sub{i}"]
        c = None if entry_cache is None else entry_cache[f"sub{i}"]
        if stage.kind == "attn":
            x, entry[f"sub{i}"], a = _apply_attn_block(
                p, cfg, x, kind=kind, q_pos=q_pos, cache=c, decode_pos=decode_pos,
                enc_out=enc_out, dtype=dtype, causal=causal, axis=axis, rows=rows,
            )
            aux = _add(aux, a)
        elif stage.kind == "mamba":
            x, entry[f"sub{i}"] = _apply_mamba_block(
                p, cfg, x, state=c, decode=decode_pos is not None, dtype=dtype, axis=axis)
        else:
            x, entry[f"sub{i}"] = _apply_rwkv_block(p, cfg, x, state=c, dtype=dtype, axis=axis)
    if stage.shared_attn:
        # one parameter set, each application with its own KV cache
        x, entry["shared"], a = _apply_attn_block(
            shared_attn, cfg, x, kind="global", q_pos=q_pos,
            cache=None if entry_cache is None else entry_cache["shared"],
            decode_pos=decode_pos, enc_out=None, dtype=dtype, causal=causal, axis=axis,
            rows=rows,
        )
        aux = _add(aux, a)
    return x, entry, aux


def _add(total: Optional[torch.Tensor], a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A sum of Switch losses that stays None until there is one (serving's
    dense models add no operations)."""
    return a if total is None else total if a is None else total + a


def _apply_stage(stage_params: nn.ModuleList, stage: StageSpec, cfg: ArchConfig,
                 x: torch.Tensor, *, cache: Optional[list], q_pos: torch.Tensor,
                 decode_pos: Optional[int], enc_out: Optional[torch.Tensor],
                 shared_attn: Optional[AttnBlock], dtype: torch.dtype, causal: bool = True,
                 remat: bool = False, axis: Optional[MeshAxis] = None, rows: tuple = (),
                 fsdp: Optional[Fsdp] = None):
    """The stage's super-blocks in order -> (x, new cache, Switch loss or
    None).  With ``remat`` each super-block runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, only its input kept.  With ``fsdp`` each super-block's
    weights, and the shared attention block's where the stage applies it,
    are gathered inside it (inside its checkpoint): the shared block's
    gradient pieces add up over its applications."""
    new_cache: Optional[list] = None if cache is None else []
    aux = None

    @contextlib.contextmanager
    def gathered(superblock):
        with contextlib.ExitStack() as stack:
            if fsdp is not None:
                stack.enter_context(fsdp.gathered(superblock))
                if stage.shared_attn:
                    stack.enter_context(fsdp.gathered(shared_attn))
            yield

    for r, superblock in enumerate(stage_params):
        kw = dict(entry_cache=None if cache is None else cache[r], q_pos=q_pos,
                  decode_pos=decode_pos, shared_attn=shared_attn, dtype=dtype, causal=causal,
                  axis=axis, rows=rows)
        if remat:
            def body(x, enc_out, superblock=superblock, kw=kw):
                with gathered(superblock):
                    x, _, a = _superblock(superblock, stage, cfg, x, enc_out=enc_out, **kw)
                return x, a
            x, a = checkpoint(body, x, enc_out, use_reentrant=False)
        else:
            with gathered(superblock):
                x, entry, a = _superblock(superblock, stage, cfg, x, enc_out=enc_out, **kw)
            if new_cache is not None:
                new_cache.append(entry)
        aux = _add(aux, a)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full forward and steps
# ---------------------------------------------------------------------------


def forward(
    params: LM,
    tokens: torch.Tensor,                 # (B, S) integer
    *,
    mode: str = "prefill",                # train | prefill | decode
    cache: Optional[list] = None,
    decode_pos: Optional[int] = None,
    vision_embeds: Optional[torch.Tensor] = None,   # (B, n_vision, D), not at decode
    encoder_frames: Optional[torch.Tensor] = None,  # (B, encoder_seq, D), not at decode
    last_only: bool = False,
    return_aux: bool = False,
):
    """Returns (logits (B, S, vocab_padded) in the compute dtype, or (B, 1,
    vocab_padded) with ``last_only``, and the new cache), and with
    ``return_aux`` also the float32 Switch loss summed over every attention
    block (0 without MoE), as the reference's ``forward`` returns it.

    In train and prefill mode the vision embeddings replace the leading
    positions of the token embeddings, and the encoder-decoder runs its
    encoder (non-causal self-attention with RoPE) over the frames first;
    decode reads both from the caches.  Train mode takes no cache and, with
    ``cfg.remat``, recomputes each super-block in the backward.  On a mesh
    the rank's vocab-parallel logits are gathered whole on every rank (what
    serving's greedy argmax reads); :func:`lm_loss` never gathers them."""
    axis = params.model_axis
    with _whole_over_data(params):
        x, new_caches, aux_total = _trunk(
            params, tokens, mode=mode, cache=cache, decode_pos=decode_pos,
            vision_embeds=vision_embeds, encoder_frames=encoder_frames, last_only=last_only)
        logits = _head(params, x)
        if axis is not None:
            logits = _gather_vocab(logits, axis, params.compute_dtype)
    if not return_aux:
        return logits, new_caches
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, new_caches, aux_total


def _whole_over_data(params: LM):
    """The block within which the embedding, the head and the final norm
    are whole over the data axis (FSDP); nothing to do without FSDP."""
    return contextlib.nullcontext() if params.fsdp is None else params.fsdp.gathered(params, False)


def _trunk(params: LM, tokens: torch.Tensor, *, mode: str, cache: Optional[list] = None,
           decode_pos: Optional[int] = None, vision_embeds: Optional[torch.Tensor] = None,
           encoder_frames: Optional[torch.Tensor] = None, last_only: bool = False):
    """:func:`forward` up to the head, called under :func:`_whole_over_data`:
    the final-normed hidden state (B, S or 1, D) in the compute dtype, the
    new cache and the Switch loss (None without MoE)."""
    cfg = params.cfg
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and (cache is None or decode_pos is None):
        raise ValueError("decode needs a cache and decode_pos")
    if mode == "train" and cache is not None:
        raise ValueError("train mode takes no cache")
    if mode != "decode" and cfg.is_enc_dec and encoder_frames is None:
        raise ValueError(f"{cfg.name} {mode} needs encoder_frames")
    dtype = params.compute_dtype
    remat = mode == "train" and cfg.remat
    axis = params.model_axis
    rows = params.row_axes if mode == "train" else ()   # the Switch loss over the batch
    B, S = tokens.shape
    x = (params.embed[tokens].to(dtype) if axis is None
         else _embed_sharded(params, tokens, dtype))
    if mode == "decode":
        q_pos = torch.full((1,), decode_pos, dtype=torch.int64, device=tokens.device)
    else:
        q_pos = torch.arange(S, dtype=torch.int64, device=tokens.device)
        decode_pos = None
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            if nv > S:
                raise ValueError(f"{nv} vision embeddings do not fit a prompt of {S} tokens")
            x = torch.cat([vision_embeds.to(dtype), x[:, nv:]], dim=1)

    enc_out = None
    if cfg.is_enc_dec and mode != "decode":
        e = encoder_frames.to(dtype)
        e_pos = torch.arange(e.shape[1], dtype=torch.int64, device=e.device)
        for si, stage in enumerate(encoder_stages(cfg)):
            e, _, _ = _apply_stage(
                params.encoder.stages[si], stage, cfg, e, cache=None, q_pos=e_pos,
                decode_pos=None, enc_out=None, shared_attn=None, dtype=dtype, causal=False,
                remat=remat, axis=axis, rows=rows, fsdp=params.fsdp,
            )
        enc_out = rmsnorm(e, params.encoder.final_norm, cfg.norm_eps, dtype)

    aux_total = None
    new_caches: Optional[list] = None if cache is None else []
    for si, stage in enumerate(stages_for(cfg)):
        x, nc, aux = _apply_stage(
            params.stages[si], stage, cfg, x,
            cache=None if cache is None else cache[si],
            q_pos=q_pos, decode_pos=decode_pos, enc_out=enc_out,
            shared_attn=params.shared_attn, dtype=dtype, remat=remat, axis=axis, rows=rows,
            fsdp=params.fsdp,
        )
        aux_total = _add(aux_total, aux)
        if new_caches is not None:
            new_caches.append(nc)

    if last_only:
        x = x[:, -1:]
    return rmsnorm(x, params.final_norm, cfg.norm_eps, dtype), new_caches, aux_total


def _head(params: LM, x: torch.Tensor) -> torch.Tensor:
    """The logits of the final-normed ``x`` in the compute dtype: the whole
    padded vocabulary, or on a mesh the rank's vocab-parallel columns (the
    head's, or the tied embedding's rows)."""
    head = params.embed.T if params.cfg.tie_embeddings else params.lm_head
    if params.model_axis is not None:
        x = params.model_axis.copy(x)
    return mm(x, head, params.compute_dtype)


def _embed_sharded(params: LM, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Vocab-parallel embedding: the rank holds rows [v0, v0 + V_l) of the
    table; ids outside them give zero rows."""
    axis, table = params.model_axis, params.embed
    V_l = table.shape[0]
    local = tokens - axis.rank * V_l
    inside = (local >= 0) & (local < V_l)
    rows = table[local.clamp(0, V_l - 1)].float()
    rows = torch.where(inside[..., None], rows, 0.0)
    # reduction over the model axis: one rank's row and zeros, exact
    return axis.reduce(rows).to(dtype)


def _gather_vocab(logits: torch.Tensor, axis: MeshAxis, dtype: torch.dtype) -> torch.Tensor:
    """The rank's vocab-parallel logits (..., V_l) placed into a zeroed
    (..., V_l * size) buffer at its columns and summed over the model
    axis: a gather written as an exact all-reduce of disjoint slices.
    Serving's only: the train step's loss never gathers them."""
    V_l = logits.shape[-1]
    full = logits.new_zeros((*logits.shape[:-1], V_l * axis.size), dtype=torch.float32)
    full[..., axis.rank * V_l:(axis.rank + 1) * V_l] = logits
    return axis.reduce(full).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[label]`` in float32, of
    ``labels``' shape.  With ``axis``, ``logits`` are the rank's
    vocab-parallel columns [rank * V_l, (rank + 1) * V_l) and no rank forms
    the whole vocabulary (Megatron's vocab-parallel cross entropy): each
    rank's logsumexp over its columns is put together with the others' over
    the axis and reduced by one more logsumexp (that concat's backward keeps
    the rank's piece: every rank computes the same loss), and the gold logit
    is the one of the rank holding the label, summed with zeros over the
    axis (exact)."""
    logits = logits.float()
    if axis is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return logz - gold
    V_l = logits.shape[-1]
    logz = torch.logsumexp(axis.concat(torch.logsumexp(logits, dim=-1)[None], 0), dim=0)
    local = labels - axis.rank * V_l
    inside = (local >= 0) & (local < V_l)
    gold = torch.gather(logits, -1, local.clamp(0, V_l - 1)[..., None])[..., 0]
    return logz - axis.reduce(torch.where(inside, gold, 0.0))


def lm_loss(params: LM, batch: dict) -> torch.Tensor:
    """Next-token cross entropy over every position of ``batch["tokens"]``,
    the logits in float32, plus ``AUX_LOSS_COEF`` times the Switch loss: the
    reference's ``lm_loss`` (its ``cfg`` is the model's).  On a mesh the
    logits stay the rank's vocab-parallel columns (:func:`cross_entropy`),
    as the reference's ``logits`` sharding keeps them."""
    tokens = batch["tokens"]
    with _whole_over_data(params):
        x, _, aux = _trunk(params, tokens, mode="train",
                           vision_embeds=batch.get("vision_embeds"),
                           encoder_frames=batch.get("encoder_frames"))
        logits = _head(params, x)[:, :-1]
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ce = cross_entropy(logits, tokens[:, 1:], params.model_axis)
    return torch.mean(ce) + AUX_LOSS_COEF * aux


@contextlib.contextmanager
def _recording(params: LM) -> Iterator[dict]:
    """The model's parameters by name, recording gradients inside the block
    (they are created without, so serving builds no graph)."""
    named = dict(params.named_parameters())
    saved = {n: p.requires_grad for n, p in named.items()}
    try:
        for p in named.values():
            p.requires_grad_(True)
        yield named
    finally:
        for n, p in named.items():
            p.requires_grad_(saved[n])


def _value_and_grad(params: LM, batch: dict) -> tuple[torch.Tensor, dict]:
    """(:func:`lm_loss`, its gradient by parameter name) of this rank's
    rows; zeros where the loss does not reach a parameter."""
    with torch.enable_grad(), _recording(params) as named:
        loss = lm_loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named.items(), grads)}


def value_and_grad(params: LM, batch: dict, *, microbatches: int = 1
                   ) -> tuple[torch.Tensor, dict]:
    """(:func:`lm_loss`, its gradient by parameter name): the reference's
    ``jax.value_and_grad(lm_loss)``.  A parameter the loss does not reach
    gets zeros, as JAX gives them.

    ``microbatches > 1`` splits the batch along its first dim and
    accumulates float32 gradients (and the loss) over the pieces, divided by
    their count, as the reference's scan does: activation memory bounded at
    the cost of one forward and backward per piece.

    On a mesh (``params.row_axes``) ``batch`` is this rank's rows
    (:func:`repro_torch.sharding.local_batch`, with the same
    ``microbatches``): the loss comes back averaged over the ranks the rows
    split over (every rank holds the same), each gradient as the rank's
    piece of the whole batch's gradient: summed over those axes (a weight's
    piece over the data axis already by its gather's reduce-scatter) and
    divided by their ranks.  With equal rows on each rank that is the
    reference's mean over the global batch.  Then each ``k`` and ``v``
    gradient of a KV head a replica group shares (``params.kv_axis``),
    each rank's from its own query heads, is summed over the group, last,
    so every replica holds the same sum."""
    if microbatches == 1:
        loss, grads = _value_and_grad(params, batch)
    else:
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        loss, grads = torch.zeros((), dtype=torch.float32, device=params.embed.device), None
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, g = _value_and_grad(params, mb)
            loss = loss + l
            if grads is None:
                grads = {k: t.float() for k, t in g.items()}
            else:
                for k, t in g.items():
                    grads[k] += t
            del g
        loss = loss / microbatches
        grads = {k: t / microbatches for k, t in grads.items()}
    if params.row_axes:
        loss, grads = _mean_over_rows(params, loss, grads)
    if params.kv_axis is not None:
        for name, g in grads.items():
            if name.rsplit(".", 1)[-1] in ("k", "v"):
                params.kv_axis.all_reduce_(g)
    return loss, grads


def _mean_over_rows(params: LM, loss: torch.Tensor, grads: dict) -> tuple[torch.Tensor, dict]:
    """The loss and the gradients summed over the axes the batch's rows
    split over, divided by their ranks (in place).  A piece over the data
    axis (FSDP) came out of its gather's backward summed over data
    already."""
    axes = params.row_axes
    n = math.prod(a.size for a in axes)
    gathered = params.fsdp.dims if params.fsdp is not None else {}
    loss = loss.clone()
    for a in axes:
        a.all_reduce_(loss)
    for name, g in grads.items():
        for a in axes:
            if not (name in gathered and a is params.fsdp.axis):
                a.all_reduce_(g)
        g.div_(n)
    return loss / n, grads


# The optimizer steps the parameters in about this many groups of equal
# bytes, each group's gradients freed as it is stepped, so a step holds the
# new moments and one group's updates beside the gradients not yet used
# (about 3 P beside the old state, P the parameters' bytes) instead of
# every gradient, moment and update at once (5 P).
UPDATE_GROUPS = 8


def _groups(named: dict, n: int) -> list[list[str]]:
    """``named``'s names in order, cut into groups of about 1 / n of the
    elements each (a leaf larger than that is a group alone)."""
    total = sum(p.numel() for p in named.values())
    groups, cur, size = [], [], 0
    for name, p in named.items():
        cur.append(name)
        size += p.numel()
        if size * n >= total:
            groups.append(cur)
            cur, size = [], 0
    return groups + [cur] if cur else groups


def make_train_step(optimizer, *, microbatches: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss"}).

    ``optimizer`` is a :class:`repro_torch.optim.Optimizer` whose state was
    made by ``optimizer.init(dict(params.named_parameters()))``.  The step
    updates the model's parameters in place and returns the model; the
    gradients are :func:`value_and_grad`'s with ``microbatches``.  The
    optimizer runs on ``UPDATE_GROUPS`` groups of the parameters in turn
    (it is elementwise and its state keyed by name, so the result is the
    same as one call's).  On a mesh each rank updates its own pieces (its
    state the rank's pieces) and the loss is the global batch's.
    """
    from repro_torch.optim import apply_updates

    def train_step(params: LM, opt_state: dict, batch: dict):
        loss, grads = value_and_grad(params, batch, microbatches=microbatches)
        named = {n: p.detach() for n, p in params.named_parameters()}
        new_state: dict = {}
        for group in _groups(named, UPDATE_GROUPS):
            g = {n: grads.pop(n) for n in group}
            state = {k: {n: v[n] for n in group} if isinstance(v, Mapping) else v
                     for k, v in opt_state.items()}
            part = {n: named[n] for n in group}
            updates, state = optimizer.update(g, state, part)
            del g
            with torch.no_grad():
                for n, p in apply_updates(part, updates).items():
                    named[n].copy_(p)
            del updates
            for k, v in state.items():
                if isinstance(v, Mapping):
                    new_state.setdefault(k, {}).update(v)
                else:
                    new_state[k] = v
        return params, new_state, {"loss": loss}

    return train_step


def make_prefill_step(max_len: Optional[int] = None):
    """prefill_step(params, batch) -> (last-position logits, cache sized for
    ``max_len`` tokens, default S).  ``batch`` is the reference's dict:
    ``"tokens"`` (B, S) and, where the model takes them, ``"vision_embeds"``
    and ``"encoder_frames"``.  Only the last position's logits are formed."""

    def prefill_step(params: LM, batch: dict):
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = init_cache(params, B, max_len or S)
        logits, cache = forward(
            params, tokens, mode="prefill", cache=cache,
            vision_embeds=batch.get("vision_embeds"),
            encoder_frames=batch.get("encoder_frames"), last_only=True,
        )
        return logits[:, -1], cache

    return prefill_step


def make_serve_step():
    """serve_step(params, cache, tokens (B, 1), pos) -> (logits, cache):
    one token at position ``pos`` against the cache."""

    def serve_step(params: LM, cache: list, tokens: torch.Tensor, pos: int):
        logits, cache = forward(params, tokens, mode="decode", cache=cache, decode_pos=pos)
        return logits[:, -1], cache

    return serve_step
