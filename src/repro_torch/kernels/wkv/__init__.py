from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import wkv_chunked_ref, wkv_ref
from repro_torch.kernels.wkv.wkv import WkvPlan, wkv_cuda, wkv_plain, wkv_plan

__all__ = ["WkvPlan", "wkv", "wkv_chunked_ref", "wkv_cuda", "wkv_plain", "wkv_plan", "wkv_ref"]
