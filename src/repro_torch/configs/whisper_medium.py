"""Whisper-medium transformer backbone (mel+conv frontend is a stub).

[arXiv:2212.04356] — enc-dec, 24L decoder + 24L encoder, d_model 1024,
16 heads (MHA: kv=16), d_ff 4096, vocab 51865.  ``input_specs`` provides 1500
precomputed frame embeddings (the conv frontend output shape).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="enc-dec, conv frontend (stub) [arXiv:2212.04356]",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    encoder_layers=24,
    encoder_seq=1500,
    act="gelu",
    long_context_ok=False,
    notes="enc-dec full attention; long_500k skipped (see DESIGN.md §4)",
)
