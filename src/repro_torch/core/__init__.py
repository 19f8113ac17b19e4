"""PACFL core (port of ``repro.core``): signatures, principal angles,
clustering, newcomers."""
from repro_torch.core.angles import (
    PROXIMITY_BACKENDS,
    cross_proximity,
    principal_angles,
    proximity_matrix,
    smallest_principal_angle_deg,
    trace_angle_deg,
)
from repro_torch.core.engine import (
    ClusterEngine,
    CondensedDistances,
    EngineConfig,
    MembershipSnapshot,
)
from repro_torch.core.hc import beta_sweep, hierarchical_clustering, n_clusters_for_beta
from repro_torch.core.measures import (
    EQ2_SOLVERS,
    eq3_from_diag,
    measure_from_gram,
    measure_pair,
)
from repro_torch.core.pacfl import (
    PACFLClustering,
    PACFLConfig,
    cluster_clients,
    compute_signatures,
    engine_config,
    one_shot_clustering,
)
from repro_torch.core.pme import (
    assign_newcomers,
    extend_proximity_matrix,
    remap_onto_old_ids,
)
from repro_torch.core.signatures import (
    FamilyContext,
    SignatureFamily,
    family_names,
    get_family,
    payloads_from_stacked,
    register_family,
)
from repro_torch.core.svd import (
    batched_client_signatures,
    bucket_samples,
    client_signature,
    randomized_truncated_svd,
    truncated_svd,
)

__all__ = [
    "PROXIMITY_BACKENDS",
    "EQ2_SOLVERS",
    "ClusterEngine",
    "CondensedDistances",
    "EngineConfig",
    "MembershipSnapshot",
    "engine_config",
    "measure_from_gram",
    "measure_pair",
    "eq3_from_diag",
    "principal_angles",
    "proximity_matrix",
    "cross_proximity",
    "smallest_principal_angle_deg",
    "trace_angle_deg",
    "hierarchical_clustering",
    "n_clusters_for_beta",
    "beta_sweep",
    "PACFLClustering",
    "PACFLConfig",
    "cluster_clients",
    "compute_signatures",
    "one_shot_clustering",
    "assign_newcomers",
    "extend_proximity_matrix",
    "remap_onto_old_ids",
    "FamilyContext",
    "SignatureFamily",
    "family_names",
    "get_family",
    "payloads_from_stacked",
    "register_family",
    "batched_client_signatures",
    "bucket_samples",
    "client_signature",
    "randomized_truncated_svd",
    "truncated_svd",
]
