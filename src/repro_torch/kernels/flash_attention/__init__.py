from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
)
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

__all__ = [
    "FlashAttention",
    "attention_bwd_ref",
    "attention_ref",
    "flash_attention",
    "flash_attention_bwd_cuda",
    "flash_attention_bwd_plain",
    "flash_attention_cuda",
    "flash_attention_plain",
]
