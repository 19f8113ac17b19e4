"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] — 24L, d_model 2048, 16H (GQA kv=16 — MHA),
expert d_ff 1408, vocab 151936, MoE 60e top-4, 4 shared experts.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,             # per-expert ffn width
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    long_context_ok=False,
    notes="full attention; long_500k skipped (see DESIGN.md §4). 60 experts "
    "are not divisible by the 16-way model axis: experts shard d_ff (TP-in-"
    "expert); llama4 uses pure expert-parallel instead.",
)
