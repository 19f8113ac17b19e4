"""Pluggable signature families: one engine, many similarity measures.

Port of ``repro.core.signatures``.  Importing this package registers the
built-in families (``svd``, ``weight_delta``, ``inference``); resolve one
with :func:`get_family` and see :mod:`repro_torch.core.signatures.base` for
the contract they satisfy.
"""
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
from repro_torch.core.signatures.inference import InferenceFamily
from repro_torch.core.signatures.svd import SIG_BATCH_MAX, SVDFamily
from repro_torch.core.signatures.weight_delta import WeightDeltaFamily

__all__ = [
    "ClientPayload",
    "FamilyContext",
    "InferenceFamily",
    "SIG_BATCH_MAX",
    "SVDFamily",
    "SignatureFamily",
    "WeightDeltaFamily",
    "client_matrix",
    "family_names",
    "get_family",
    "payloads_from_stacked",
    "register_family",
]
