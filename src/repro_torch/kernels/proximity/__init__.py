from repro_torch.kernels.proximity.ops import proximity
from repro_torch.kernels.proximity.proximity import (
    MAX_RANK,
    proximity_cross,
    proximity_cuda,
    proximity_plain,
)
from repro_torch.kernels.proximity.ref import proximity_ref

__all__ = [
    "MAX_RANK",
    "proximity",
    "proximity_cross",
    "proximity_cuda",
    "proximity_plain",
    "proximity_ref",
]
