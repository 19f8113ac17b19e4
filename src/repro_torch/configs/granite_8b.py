"""Granite-8B-Code — llama-architecture dense code model.

[arXiv:2405.04324] — 36L, d_model 4096, 32H (GQA kv=8), d_ff 14336,
vocab 49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    source="llama-arch, code [arXiv:2405.04324]",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=1e5,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4)",
)
