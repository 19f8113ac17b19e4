"""Llama-4-Scout-17B-16E — MoE top-1 with shared expert, early-fusion vision.

[hf:meta-llama/Llama-4-Scout-17B-16E] — 48L, d_model 5120, 40H (GQA kv=8),
expert d_ff 8192, vocab 202048, 16 experts top-1 + 1 shared expert.
Vision stub: 256 early-fused patch embeddings via input_specs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    expert_d_ff=8192,
    vision_tokens=256,
    moe_chunk=2048,   # beyond-paper tuning: 4x fewer expert-weight regathers
                      # inside the MoE chunk scan (EXPERIMENTS.md §Perf)
    rope_theta=5e5,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4). 16 experts "
    "shard on the model axis (pure expert parallelism).",
)
