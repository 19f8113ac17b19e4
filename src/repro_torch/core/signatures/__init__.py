"""Pluggable signature families (this slice of the port: ``svd`` only)."""
from repro_torch.core.signatures.base import (
    ClientPayload,
    FamilyContext,
    SignatureFamily,
    client_matrix,
    family_names,
    get_family,
    payloads_from_stacked,
    register_family,
)
from repro_torch.core.signatures.svd import SIG_BATCH_MAX, SVDFamily

__all__ = [
    "ClientPayload",
    "FamilyContext",
    "SIG_BATCH_MAX",
    "SVDFamily",
    "SignatureFamily",
    "client_matrix",
    "family_names",
    "get_family",
    "payloads_from_stacked",
    "register_family",
]
