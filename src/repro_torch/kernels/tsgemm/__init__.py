from repro_torch.kernels.tsgemm.ops import tsgemm
from repro_torch.kernels.tsgemm.ref import tsgemm_ref
from repro_torch.kernels.tsgemm.tsgemm import tsgemm_cuda, tsgemm_plain

__all__ = ["tsgemm", "tsgemm_cuda", "tsgemm_plain", "tsgemm_ref"]
