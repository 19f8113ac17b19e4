"""Runtime invariant sanitizer — the dynamic half of ``repro-lint``.

The static rules (``tools/repro_lint``) catch contract violations that are
visible in the source; this module catches the ones that only exist at
runtime, by patching the distance-store read path while tests run:

``S1  no-(K, K)-outside-dense-tier``
    :meth:`CondensedDistances.dense` / :meth:`~CondensedDistances.dense_ro`
    must not run while the resolved memory tier is ``banded`` /
    ``condensed_only`` — the whole point of those tiers is that no code
    path materializes a (K, K) array.  The engine's public back-compat
    ``ClusterEngine.dense()`` escape hatch wraps itself in
    :func:`allow_dense`.
``S2  bounded gather transients``
    Outside the dense tier a single :meth:`StoreMemory.gather` may hand
    out at most ``max(ROW_BLOCK, K // 8)`` rows: consumers aggregate
    through ``blocked_column_fold`` (ROW_BLOCK-row blocks), and a gather
    past the K/8 densify threshold is a dense materialization wearing a
    different hat.
``S3  promote=False purity``
    A ``promote=False`` (streaming-scan) gather must leave the banded
    LRU untouched — no inserts, no reordering.  PR 5's n_clusters tail
    relied on exactly this to keep the hot window warm.
``S4  bounded cold-segment residency``
    On the ``spilled`` tier the whole contract is that the condensed
    vector is *not* resident: (a) materializing the full flat vector from
    a :class:`~repro_torch.core.engine.store_backends.SpilledSegments` backend
    (``CondensedDistances.values`` does this) is forbidden outside
    :func:`allow_dense`, and (b) after every segment gather the backend's
    tracked cold-page residency must sit within its budget plus at most
    one in-flight segment — a broken/bypassed LRU eviction would silently
    re-inflate peak RSS to condensed_only levels.

Violations raise :class:`SanitizerViolation` carrying the offending call
stack, so the failing test points at the code path that broke the
contract, not at the assertion.

Usage: ``REPRO_SANITIZE=1 pytest ...`` (the conftest fixture arms the
engine/memory test modules), or explicitly::

    from repro_torch.core.engine import sanitize
    with sanitize.sanitized():
        ...

``install()`` / ``uninstall()`` are reentrant; :data:`stats` accumulates
telemetry (peak gather bytes, dense builds) across the installed window.
Overhead is a couple of Python-level checks per gather — see
``docs/BENCHMARKS.md``.
"""
from __future__ import annotations

import os
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.engine.memory import StoreMemory
from repro_torch.core.engine.store import CondensedDistances
from repro_torch.core.engine.store_backends import SpilledSegments
from repro_torch.core.hc import ROW_BLOCK


class SanitizerViolation(AssertionError):
    """A runtime parity/memory contract was broken while sanitized."""


@dataclass
class SanitizerStats:
    """Telemetry for the current installed window (reset on install)."""

    gathers: int = 0
    peak_gather_bytes: int = 0
    dense_builds: int = 0     # dense()/dense_ro() materializations observed
    allowed_dense: int = 0    # of those, inside an allow_dense() block
    spilled_materializations: int = 0  # full-vector builds off a spilled backend
    peak_cold_resident_bytes: int = 0  # max tracked cold residency observed
    violations: int = 0


stats = SanitizerStats()

_installed = 0       # reentrant install count
_allow_depth = 0     # allow_dense() nesting depth
_orig: dict = {}     # patched-over originals, keyed by name


def enabled_by_env() -> bool:
    """True when ``REPRO_SANITIZE`` is set to something truthy."""
    return os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")


def _violation(msg: str) -> None:
    stats.violations += 1
    stack = "".join(traceback.format_stack(limit=14)[:-2])
    raise SanitizerViolation(f"{msg}\noffending call stack:\n{stack}")


def gather_bound(n: int) -> int:
    """Max rows one non-dense-tier gather may hand out (see S2)."""
    return max(ROW_BLOCK, n // 8)


def _checked_dense(self, dtype=np.float32):
    stats.dense_builds += 1
    if _allow_depth:
        stats.allowed_dense += 1
    elif self.memory.tier(self.n) != "dense":
        _violation(
            f"S1: (K, K) dense materialization via CondensedDistances.dense "
            f"outside the dense tier (K={self.n}, "
            f"tier={self.memory.tier(self.n)!r}); wrap intentional "
            f"escapes in sanitize.allow_dense()"
        )
    return _orig["dense"](self, dtype)


def _checked_dense_ro(self):
    stats.dense_builds += 1
    if _allow_depth:
        stats.allowed_dense += 1
    elif self.memory.tier(self.n) != "dense":
        _violation(
            f"S1: (K, K) dense materialization via "
            f"CondensedDistances.dense_ro outside the dense tier "
            f"(K={self.n}, tier={self.memory.tier(self.n)!r})"
        )
    return _orig["dense_ro"](self)


def _checked_gather(self, store, idx, promote: bool = True):
    idx_arr = np.atleast_1d(np.asarray(idx, dtype=np.int64))
    tier = self.tier(store.n)
    if tier != "dense" and idx_arr.size > gather_bound(store.n):
        _violation(
            f"S2: single gather of {idx_arr.size} rows exceeds the "
            f"non-dense-tier transient bound {gather_bound(store.n)} "
            f"(K={store.n}, tier={tier!r}); aggregate through "
            f"blocked_column_fold instead"
        )
    band = self.band if tier == "banded" else None
    lru_before = (
        list(band._lru.items()) if band is not None and not promote else None
    )
    out = _orig["gather"](self, store, idx, promote=promote)
    stats.gathers += 1
    stats.peak_gather_bytes = max(stats.peak_gather_bytes, int(out.nbytes))
    if lru_before is not None and list(band._lru.items()) != lru_before:
        _violation(
            "S3: promote=False gather mutated the banded LRU (insert or "
            "reorder) — streaming scans must read through without evicting "
            "the hot window"
        )
    return out


def _checked_materialize(self):
    stats.spilled_materializations += 1
    if not _allow_depth:
        _violation(
            f"S4: full condensed-vector materialization from a spilled "
            f"backend ({self.size} entries, {self.nbytes} bytes) — the "
            f"spilled tier exists so this never happens; wrap intentional "
            f"escapes (e.g. CondensedDistances.values) in "
            f"sanitize.allow_dense()"
        )
    return _orig["materialize"](self)


def _checked_gather_flat(self, flat):
    out = _orig["gather_flat"](self, flat)
    resident = int(self.cold_resident_bytes)
    stats.peak_cold_resident_bytes = max(
        stats.peak_cold_resident_bytes, resident
    )
    bound = int(self.cold_budget) + int(self.max_segment_nbytes)
    if resident > bound:
        _violation(
            f"S4: cold-segment residency {resident} bytes exceeds the "
            f"budget-plus-one-segment bound {bound} (cold_budget="
            f"{self.cold_budget}, largest segment {self.max_segment_nbytes}"
            f") — LRU eviction is broken or bypassed"
        )
    return out


def install() -> None:
    """Arm the sanitizer (reentrant — pair every call with uninstall)."""
    global _installed, stats
    _installed += 1
    if _installed > 1:
        return
    stats = SanitizerStats()
    _orig["dense"] = CondensedDistances.dense
    _orig["dense_ro"] = CondensedDistances.dense_ro
    _orig["gather"] = StoreMemory.gather
    _orig["materialize"] = SpilledSegments.materialize
    _orig["gather_flat"] = SpilledSegments.gather_flat
    CondensedDistances.dense = _checked_dense
    CondensedDistances.dense_ro = _checked_dense_ro
    StoreMemory.gather = _checked_gather
    SpilledSegments.materialize = _checked_materialize
    SpilledSegments.gather_flat = _checked_gather_flat


def uninstall() -> None:
    """Disarm one install() level; restores originals at depth zero."""
    global _installed
    if _installed == 0:
        return
    _installed -= 1
    if _installed:
        return
    CondensedDistances.dense = _orig.pop("dense")
    CondensedDistances.dense_ro = _orig.pop("dense_ro")
    StoreMemory.gather = _orig.pop("gather")
    SpilledSegments.materialize = _orig.pop("materialize")
    SpilledSegments.gather_flat = _orig.pop("gather_flat")


def installed() -> bool:
    """True while at least one install() level is active."""
    return _installed > 0


@contextmanager
def sanitized():
    """Run a block with the sanitizer armed."""
    install()
    try:
        yield stats
    finally:
        uninstall()


@contextmanager
def allow_dense():
    """Permit (K, K) materialization inside the block (S1 escape hatch).

    For deliberate, caller-visible dense views — e.g. the engine's
    back-compat ``ClusterEngine.dense()`` API — where the caller opted in
    to the memory cost.  Cheap no-op when the sanitizer is not installed.
    """
    global _allow_depth
    _allow_depth += 1
    try:
        yield
    finally:
        _allow_depth -= 1
