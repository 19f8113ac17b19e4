"""Gemma-3-4B — 5:1 local:global sliding-window attention, 128k context.

[hf:google/gemma-3-1b-pt family] — 34L, d_model 2560, 8H (GQA kv=4),
d_ff 10240, vocab 262144, window 1024, every 6th layer global.
Sliding-window => eligible for long_500k (locals keep a ring buffer; only
the 1-in-6 global layers hold the full KV).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    source="5:1 local:global, 128k [hf:google/gemma-3-1b-pt]",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    swa_pattern=(5, 1),
    window=1024,
    rope_theta=1e6,
    act="gelu",
    long_context_ok=True,
)
