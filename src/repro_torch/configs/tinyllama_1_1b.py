"""TinyLlama-1.1B — llama2-architecture small model.

[arXiv:2401.02385] — 22L, d_model 2048, 32H (GQA kv=4), d_ff 5632,
vocab 32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="llama2-arch small [arXiv:2401.02385]",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4)",
)
