"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] — 24L, d_model 2048, d_ff 7168, vocab 65536, head_size 64.
O(1) recurrent state => eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="Finch — data-dependent decay [arXiv:2404.05892]",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    block_kind="rwkv6",
    rwkv_head_dim=64,
    long_context_ok=True,
)
