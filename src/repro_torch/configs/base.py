"""Architecture config schema shared by the whole framework.

Every assigned architecture is expressed as an :class:`ArchConfig`; the model
zoo (``repro.models.lm``) interprets it.  ``reduced()`` produces the smoke-test
variant (2 layers, d_model <= 512, <= 4 experts) mandated by the brief.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str                       # citation from the assignment table
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # defaults to d_model // n_heads

    # Block structure -------------------------------------------------------
    block_kind: str = "attn"          # attn | mamba2 | rwkv6
    # sliding-window pattern: (n_local, n_global) repeating, e.g. gemma3 (5,1)
    swa_pattern: Optional[Tuple[int, int]] = None
    window: int = 1024
    # hybrid (zamba2): shared attention block applied every `attn_every` ssm
    # blocks; 0 disables.
    attn_every: int = 0

    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_chunk: int = 512              # seq-chunk for einsum dispatch

    # SSM ---------------------------------------------------------------------
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128
    rwkv_head_dim: int = 64

    # Encoder-decoder (whisper) ----------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500           # stub mel/conv frame count

    # VLM (stub vision frontend) ----------------------------------------------
    vision_tokens: int = 0

    # Misc ---------------------------------------------------------------------
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    act: str = "silu"
    attn_chunk: int = 1024            # kv-chunk for flash-style attention
    remat: bool = True
    long_context_ok: bool = False     # eligible for long_500k
    notes: str = ""

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded for clean sharding of the embedding/lm-head."""
        return _round_up(self.vocab, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS in §Roofline)."""
        D, V = self.d_model, self.vocab_padded
        hd = self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        att = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (self.n_heads * hd) * D

        def mlp(ff: int) -> int:
            return 3 * D * ff  # gated mlp

        per_layer = 0
        if self.block_kind == "attn":
            per_layer = att
            if self.is_moe:
                per_layer += self.n_experts * mlp(self.expert_d_ff) / 1  # all experts
                per_layer += self.n_shared_experts * mlp(self.expert_d_ff)
                per_layer += D * self.n_experts  # router
            else:
                per_layer += mlp(self.d_ff)
            n += self.n_layers * per_layer
        elif self.block_kind == "mamba2":
            d_in = self.ssm_expand * D
            per_ssm = D * 2 * d_in + d_in * D + 2 * D * self.ssm_state + d_in // self.ssm_head_dim
            per_ssm += mlp(self.d_ff)
            n += self.n_layers * per_ssm
            if self.attn_every:
                n += att + mlp(self.d_ff)  # one shared attention block
        elif self.block_kind == "rwkv6":
            per_layer = 5 * D * D + 2 * D * self.d_ff + D * self.d_ff
            n += self.n_layers * per_layer
        if self.encoder_layers:
            n += self.encoder_layers * (att + mlp(self.d_ff)) + self.n_layers * att  # cross attn
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top_k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        D = self.d_model
        dense_experts = self.n_experts - 0
        full = self.param_count()
        all_expert = self.n_layers * self.n_experts * 3 * D * self.expert_d_ff
        active_expert = self.n_layers * self.top_k * 3 * D * self.expert_d_ff
        return int(full - all_expert + active_expert)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(self.n_heads, d // hd))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep GQA ratio valid
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16),
            vision_tokens=min(self.vision_tokens, 8),
            swa_pattern=(2, 1) if self.swa_pattern else None,
            window=min(self.window, 8),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            ssd_chunk=8,
            moe_chunk=16,
            attn_chunk=16,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32),
            rwkv_head_dim=min(self.rwkv_head_dim, 32),
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
