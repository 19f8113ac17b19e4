from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "attention_ref",
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_plain",
]
