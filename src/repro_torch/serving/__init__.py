"""Membership-as-a-service read path (port of ``repro.serving``): the
representative cache and the batched assignment dispatch."""
from repro_torch.serving.dispatch import pow2_bucket, serve_assign
from repro_torch.serving.representatives import (
    REPRESENTATIVE_KINDS,
    ClusterRepresentative,
    RepresentativeCache,
)

__all__ = [
    "pow2_bucket",
    "serve_assign",
    "REPRESENTATIVE_KINDS",
    "ClusterRepresentative",
    "RepresentativeCache",
]
