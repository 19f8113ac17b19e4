"""Membership-as-a-service (port of ``repro.serving``): the representative
cache, the batched assignment dispatch and the snapshot-isolated
:class:`AssignmentServer`."""
from repro_torch.serving.dispatch import pow2_bucket, serve_assign
from repro_torch.serving.representatives import (
    REPRESENTATIVE_KINDS,
    ClusterRepresentative,
    RepresentativeCache,
)
from repro_torch.serving.server import (
    AssignmentResult,
    AssignmentServer,
    DrainReport,
    ServingSnapshot,
    admit_oracle,
)

__all__ = [
    "pow2_bucket",
    "serve_assign",
    "REPRESENTATIVE_KINDS",
    "ClusterRepresentative",
    "RepresentativeCache",
    "AssignmentResult",
    "AssignmentServer",
    "DrainReport",
    "ServingSnapshot",
    "admit_oracle",
]
