"""Zamba2-7B — Mamba2 backbone + shared attention block.

[arXiv:2411.15242] — 81L, d_model 3584, 32H (kv=32, MHA) for the *shared*
attention block, d_ff 14336, vocab 32000, ssm_state 64.  A single set of
attention+MLP parameters is re-applied every 6th position (the paper's
shared-block design).  Mamba2 state is O(1) => eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="Mamba2 + shared attn blocks [arXiv:2411.15242]",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    block_kind="mamba2",
    attn_every=6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    long_context_ok=True,
)
