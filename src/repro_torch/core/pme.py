"""Proximity Matrix Extension (Algorithm 2) and newcomer handling (Algorithm 3).

Port of ``repro.core.pme``; signature stacks are torch tensors, the
proximity blocks come back to the host as float32 NumPy arrays.

PME extends an existing (M x M) proximity matrix with B newcomer signatures
without recomputing seen-client pairs — newcomers join in O((M+B) * B) angle
evaluations, and with an unchanged ``beta`` the old clients keep their cluster
ids (tested as an invariant).  :func:`assign_newcomers` delegates the
clustering update to the streaming engine (:mod:`repro_torch.core.engine`) instead
of re-running hierarchical clustering over the extended matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike

from repro_torch.core.angles import cross_proximity, proximity_matrix


def proximity_blocks(
    U_old: torch.Tensor,
    U_new: torch.Tensor,
    *,
    measure: str = "eq3",
    backend: str = "auto",
    block_size: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The two admission blocks: (M, B) seen-vs-new cross + (B, B) square.

    Shared by :func:`extend_proximity_matrix` and the streaming engine's
    ``admit`` so the two paths cannot drift (the benchmark asserts their
    label parity).  The square comes hygiene'd (symmetric, zero diagonal)
    from :func:`proximity_matrix`; a lone newcomer gets the trivial zero
    block directly.
    """
    B = int(U_new.shape[0])
    C = cross_proximity(
        U_old, U_new, measure=measure, backend=backend, block_size=block_size
    ).cpu().numpy()
    if B > 1:
        square = proximity_matrix(
            U_new, measure=measure, backend=backend, block_size=block_size
        ).cpu().numpy()
    else:
        square = np.zeros((1, 1), dtype=np.float32)
    return C, square


def extend_proximity_matrix(
    A_old: np.ndarray,
    U_old: torch.Tensor,
    U_new: torch.Tensor,
    *,
    measure: str = "eq3",
    backend: str = "auto",
    block_size: Optional[int] = None,
) -> tuple[np.ndarray, torch.Tensor]:
    """Algorithm 2: returns (A_extended, U_extended).

    Only the new blocks are computed: the (M, B) seen-vs-new cross block
    through :func:`repro_torch.core.angles.cross_proximity` plus the (B, B)
    new-vs-new square through :func:`proximity_matrix` — O((M+B) * B) angle
    evaluations, never a fresh (M+B)^2 recomputation.  (An earlier revision
    ran one (M+B, B) cross product against ``U_ext``, which evaluated every
    newcomer-vs-newcomer pair twice — both (i, j) and (j, i) — before
    symmetrizing; the square backend computes each pair once and applies
    the same hygiene pass as the one-shot phase.)

    Parameters
    ----------
    A_old: (M, M) existing proximity matrix (degrees).
    U_old: (M, n, p) stacked seen-client signatures.
    U_new: (B, n, p) stacked newcomer signatures.
    """
    A_old = np.asarray(A_old)
    M = A_old.shape[0]
    B = int(U_new.shape[0])
    U_ext = torch.cat([U_old, U_new], dim=0)
    C, nn = proximity_blocks(
        U_old, U_new, measure=measure, backend=backend, block_size=block_size
    )
    A_ext = np.zeros((M + B, M + B), dtype=A_old.dtype)
    A_ext[:M, :M] = A_old
    A_ext[:M, M:] = C
    A_ext[M:, :M] = C.T
    A_ext[M:, M:] = nn
    return A_ext, U_ext


@dataclass
class NewcomerAssignment:
    labels: np.ndarray          # (M+B,) labels after extension
    newcomer_labels: np.ndarray  # (B,) labels of the newcomers
    new_cluster: np.ndarray      # (B,) bool — True if newcomer formed a new cluster


def remap_onto_old_ids(
    labels: np.ndarray, old_labels: np.ndarray, M: int
) -> np.ndarray:
    """Map extended-cluster ids onto the old cluster ids, collision-safe.

    Each extended cluster claims the old id that dominates its seen-client
    members.  Two distinct extended clusters can share a dominant old id
    (HC on the extended matrix may split an old cluster once newcomers
    reshape the merge order); naively both would collapse onto that id,
    silently merging clusters the HC kept apart.  Claims are therefore
    resolved by overlap size — the extended cluster with the larger
    seen-client overlap keeps the old id (ties break to the smaller
    extended id, i.e. first client occurrence) — and every losing or
    newcomer-only cluster receives a fresh id above the old range, so the
    number of distinct clusters is preserved exactly.
    """
    old_labels = np.asarray(old_labels)
    # (extended id, dominant old id or None, overlap count) per cluster
    claims: list[tuple[int, Optional[int], int]] = []
    for c in np.unique(labels):
        olds = old_labels[labels[:M] == c] if M else np.array([])
        if olds.size:
            vals, counts = np.unique(olds, return_counts=True)
            top = int(np.argmax(counts))
            claims.append((int(c), int(vals[top]), int(counts[top])))
        else:
            claims.append((int(c), None, 0))
    mapping: dict[int, int] = {}
    claimed: set[int] = set()
    next_new = int(np.max(old_labels)) + 1 if M else 0
    for c, old, count in sorted(claims, key=lambda t: (-t[2], t[0])):
        if old is not None and old not in claimed:
            mapping[c] = old
            claimed.add(old)
        else:
            mapping[c] = next_new
            next_new += 1
    return np.array([mapping[int(c)] for c in labels], dtype=np.int64)


def assign_newcomers(
    A_old: np.ndarray,
    U_old: torch.Tensor,
    U_new: torch.Tensor,
    beta: float,
    *,
    measure: str = "eq3",
    linkage: str = "average",
    n_clusters: Optional[int] = None,
    old_labels: Optional[np.ndarray] = None,
    backend: str = "auto",
    block_size: Optional[int] = None,
    device: DeviceLike = None,
) -> tuple[np.ndarray, torch.Tensor, NewcomerAssignment]:
    """Algorithm 3: extend A and fold the newcomers into the dendrogram.

    Delegates to :meth:`repro_torch.core.engine.ClusterEngine.admit`: the engine
    adopts ``A_old`` (adding its merge script in one O(M^2) bootstrap pass,
    the same cost the old re-cluster-the-world step paid on *every* call),
    then admits the batch incrementally.  The labels are those a full
    re-clustering of the extended matrix would produce (oracle-parity
    property of the engine).  ``n_clusters``, when set, overrides ``beta``
    exactly as in the one-shot phase (fixed cluster count).  If
    ``old_labels`` is given, newcomer labels are remapped onto the old
    cluster ids via :func:`remap_onto_old_ids` so existing cluster
    identities are preserved for the caller.

    Callers with a long-lived clustering should hold a
    :class:`~repro_torch.core.engine.ClusterEngine` (or ``PACFLClustering``)
    instead and call ``admit``/``extend`` directly — that skips the
    bootstrap pass and makes successive admissions near-O(B * K).

    Precision note: the engine stores distances in condensed float32, so
    with a float64 ``A_old`` the clustering criterion is evaluated on
    float32-rounded values (PACFL proximity matrices are float32 already).
    The returned ``A_ext`` carries the caller's seen block verbatim.
    """
    from repro_torch.core.engine import ClusterEngine, EngineConfig

    M = np.asarray(A_old).shape[0]
    engine = ClusterEngine.from_proximity(
        A_old, U_old,
        EngineConfig(
            beta=beta, n_clusters=n_clusters, measure=measure,
            linkage=linkage, backend=backend, block_size=block_size,
        ),
        device=device,
    )
    engine.admit(U_new)
    labels = engine.canonical_labels
    if old_labels is not None:
        labels = remap_onto_old_ids(labels, old_labels, M)

    A_old = np.asarray(A_old)
    A_ext = engine.dense().astype(A_old.dtype)  # repro-lint: ignore[R3]  # port of src/repro/core/pme.py, allowlisted there
    # the engine's condensed store is float32; hand the caller's seen block
    # back verbatim so A_ext[:M, :M] == A_old bitwise for float64 inputs
    # (clustering itself runs on the float32-rounded store — documented).
    A_ext[:M, :M] = A_old
    U_ext = engine.U
    newcomer_labels = labels[M:]
    seen = set(labels[:M].tolist())
    new_cluster = np.array([lbl not in seen for lbl in newcomer_labels])
    return A_ext, U_ext, NewcomerAssignment(labels, newcomer_labels, new_cluster)
