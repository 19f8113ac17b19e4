"""Llama-3.2-3B — small llama3 dense model.

[hf:meta-llama/Llama-3.2-1B family] — 28L, d_model 3072, 24H (GQA kv=8),
d_ff 8192, vocab 128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    source="small llama3 [hf:meta-llama/Llama-3.2-1B]",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4)",
)
