"""Streaming cluster-membership engine (incremental dendrogram + condensed store).

Port of ``repro.core.engine``: NumPy code copied verbatim, with the
signature stack held as a torch tensor on the engine's device.
"""
from repro_torch.core.engine import sanitize
from repro_torch.core.engine.dendrogram import (
    ReplayStats,
    filter_script_for_depart,
    replay,
)
from repro_torch.core.engine.drift import ClusterDrift, DriftReport, DriftTracker
from repro_torch.core.engine.engine import (
    AdmitResult,
    ClusterEngine,
    DepartResult,
    EngineConfig,
    MembershipSnapshot,
    MoveResult,
)
from repro_torch.core.engine.memory import BandedRowCache, MemoryPolicy, StoreMemory
from repro_torch.core.engine.store import CondensedDistances
from repro_torch.core.engine.store_backends import RamSegments, Segment, SpilledSegments

__all__ = [
    "AdmitResult",
    "BandedRowCache",
    "ClusterDrift",
    "ClusterEngine",
    "CondensedDistances",
    "DepartResult",
    "DriftReport",
    "DriftTracker",
    "EngineConfig",
    "MembershipSnapshot",
    "MemoryPolicy",
    "MoveResult",
    "RamSegments",
    "ReplayStats",
    "Segment",
    "SpilledSegments",
    "StoreMemory",
    "filter_script_for_depart",
    "replay",
    "sanitize",
]
