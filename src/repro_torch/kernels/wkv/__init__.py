from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import wkv_ref
from repro_torch.kernels.wkv.wkv import wkv_cuda, wkv_plain

__all__ = ["wkv", "wkv_cuda", "wkv_plain", "wkv_ref"]
