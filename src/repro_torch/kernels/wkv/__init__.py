from repro_torch.kernels.wkv.ops import WKV, wkv
from repro_torch.kernels.wkv.ref import (
    wkv_bwd_chunked_ref,
    wkv_bwd_ref,
    wkv_chunked_ref,
    wkv_recurrent_ref,
    wkv_ref,
)
from repro_torch.kernels.wkv.wkv import (
    WkvPlan,
    wkv_bwd_cuda,
    wkv_bwd_plain,
    wkv_bwd_plan,
    wkv_cuda,
    wkv_plain,
    wkv_plan,
)

__all__ = ["WKV", "WkvPlan", "wkv", "wkv_bwd_chunked_ref", "wkv_bwd_cuda", "wkv_bwd_plain",
           "wkv_bwd_plan", "wkv_bwd_ref", "wkv_chunked_ref", "wkv_cuda", "wkv_plain",
           "wkv_plan", "wkv_recurrent_ref", "wkv_ref"]
