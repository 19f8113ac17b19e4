"""Analytic model FLOPs of a step, and model-FLOP utilisation on one H100.

Ports the single-card part of ``repro.launch.roofline``: :func:`model_flops`
is the reference's arithmetic over the port's ``ArchConfig`` and
``INPUT_SHAPES`` (6 N tokens to train, 2 N tokens to prefill, 2 N a
sequence to decode, N = ``cfg.active_param_count()``, plus the causal
attention terms of attention models), mirrored as it is: for rwkv6 its
``param_count`` counts the channel mix as 3 D d_ff where the block holds
2 D d_ff + D^2, so rwkv6's figures read high; for zamba2 it adds a gated
MLP (3 D d_ff) to every Mamba2 layer, which holds none: 19.20 B against
the 6.75 B parameters the model holds, so zamba2's figures read about 2.8x
high.  The denominators are one
H100's dense bfloat16 tensor-core peak and memory rate (NVIDIA's data
sheet, SXM part at 700 W), not the reference's TPU v5e constants.  The rest
of the reference's module reads a compiled XLA module's costs and a mesh's
collectives, which have no counterpart on one card (``launch/__init__.py``).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, InputShape

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bfloat16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs of one step at ``shape`` (global, all chips)."""
    n_active = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        # quadratic attention term (forward and backward: 3x 4 S^2 H hd a layer)
        if cfg.block_kind == "attn":
            att = 4.0 * S * S * cfg.n_heads * hd * B * cfg.n_layers
            flops += 3.0 * att / 2.0  # causal halves the useful pairs
        return flops
    if shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        if cfg.block_kind == "attn":
            flops += 4.0 * S * S * cfg.n_heads * hd * B * cfg.n_layers / 2.0
        return flops
    # decode: one token per sequence
    flops = 2.0 * n_active * B
    if cfg.block_kind == "attn":
        flops += 4.0 * S * cfg.n_heads * hd * B * cfg.n_layers
    return flops


def model_flop_utilisation(cfg: ArchConfig, shape: InputShape, seconds: float) -> float:
    """:func:`model_flops` of one step done in ``seconds`` on one H100, as a
    share of its bfloat16 peak."""
    return model_flops(cfg, shape) / seconds / PEAK_FLOPS_BF16
