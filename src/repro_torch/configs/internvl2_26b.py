"""InternVL2-26B language backbone (InternViT vision encoder is a stub).

[arXiv:2404.16821] — InternViT-6B + InternLM2-20B; the assigned backbone:
48L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 92553.
Vision frontend carve-out: ``input_specs`` provides 256 precomputed patch
embeddings per sample, fused into the leading sequence positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="InternViT + InternLM2 [arXiv:2404.16821]",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    vision_tokens=256,
    rope_theta=1e6,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4)",
)
