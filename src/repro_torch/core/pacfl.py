"""PACFL orchestrator (Algorithm 1, server side).

Port of ``repro.core.pacfl``.  Entry points take ``device=None``, which
means ``"cuda"``; signatures and the proximity kernel run there, the
clustering state machine runs on the host.

Separates the paper's two concerns:

* **Clustering state machine** — signatures in, cluster ids out.  Since the
  streaming-engine refactor this lives in :mod:`repro_torch.core.engine`;
  :class:`PACFLClustering` here is a thin immutable view over a
  :class:`~repro_torch.core.engine.ClusterEngine` (one-shot at federation start,
  ``extend`` for newcomers per Algorithms 2-3, ``depart`` for churn).
* **Per-cluster federated optimization** — ``repro.fl.trainer`` runs the round
  loop with the ``pacfl`` strategy, which consumes :class:`PACFLClustering`.

The client-side signature extractor is pluggable
(:mod:`repro_torch.core.signatures`): ``PACFLConfig.family`` picks the
:class:`~repro_torch.core.signatures.SignatureFamily` — the paper's raw-data
``svd`` (default), FedClust-style ``weight_delta``, or FLIS-style
``inference`` — and everything from :func:`cluster_clients` down is
family-agnostic.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device

from repro_torch.core.engine import ClusterEngine, EngineConfig, MembershipSnapshot
from repro_torch.core.signatures import FamilyContext, get_family
from repro_torch.core.signatures.svd import SIG_BATCH_MAX  # noqa: F401  (back-compat re-export)


@dataclass
class PACFLConfig:
    """Hyperparameters for one PACFL run (paper Algorithm 1 + the engine).

    Every knob here is deterministic: for a fixed config and fixed client
    data, clustering labels are bitwise-reproducible across runs, backends
    and memory tiers (the repo's parity contract; see docs/ENGINE.md).
    """

    p: int = 3                     # number of principal vectors per client (paper: 3-5)
    beta: float = 10.0             # HC distance threshold (degrees)
    measure: str = "eq3"           # "eq2" | "eq3"
    linkage: str = "average"
    svd_method: str = "exact"      # "exact" | "randomized" | "randomized_tsgemm"
    n_clusters: Optional[int] = None  # fixed cluster count overrides beta when set
    # Signature family (repro_torch.core.signatures): "svd" | "weight_delta" |
    # "inference".  Extra per-family hyperparameters (warmup steps, sketch
    # dim, probe size, ...) ride in family_params.
    family: str = "svd"
    family_params: dict = field(default_factory=dict)
    # Resolve beta from the observed off-diagonal proximity quantile at
    # cluster time instead of the absolute value above.  Model-based
    # families live on different distance scales than raw-data angles, so a
    # quantile threshold transfers across families where a degree value
    # does not.  Ignored when n_clusters is set.
    beta_quantile: Optional[float] = None
    # Proximity backend dispatch (see repro_torch.core.angles.proximity_matrix):
    # "auto" | "torch" | "torch_blocked" | "kernel" | "sharded".  "auto" takes
    # the CUDA kernel on CUDA tensors; "sharded" the kernel in row strips
    # across every local card.
    proximity_backend: str = "auto"
    # Client tile edge for the blocked path; None picks its default
    # (64 eq3 / 96 eq2).  The kernel's tile is fixed in its source.
    proximity_block: Optional[int] = None
    # Distance-store memory policy (repro_torch.core.engine.memory.MemoryPolicy):
    # "auto" | "dense" | "banded" | "condensed_only" | "spilled".  All modes
    # produce bitwise-identical cluster labels; they trade server cache
    # memory against steady-state admission latency ("auto" picks per
    # current K from memory_budget_bytes, default 256 MiB — including
    # "spilled" once the condensed store itself outgrows the budget).
    memory: str = "auto"
    memory_budget_bytes: Optional[int] = None
    memory_band_rows: int = 512
    # Spilled-tier knobs: segment-file directory (None = system temp dir)
    # and columns per flushed cold segment.
    memory_spill_dir: Optional[str] = None
    memory_spill_segment_rows: int = 1024


def engine_config(config: PACFLConfig) -> EngineConfig:
    """The engine-facing slice of a :class:`PACFLConfig`."""
    return EngineConfig(
        beta=config.beta,
        n_clusters=config.n_clusters,
        measure=config.measure,
        linkage=config.linkage,
        backend=config.proximity_backend,
        block_size=config.proximity_block,
        memory=config.memory,
        memory_budget_bytes=config.memory_budget_bytes,
        band_rows=config.memory_band_rows,
        spill_dir=config.memory_spill_dir,
        spill_segment_rows=config.memory_spill_segment_rows,
    )


@dataclass
class PACFLClustering:
    """Server-side clustering state — a thin view over the streaming engine.

    ``U`` / ``A`` / ``labels`` are derived views: the engine owns the
    signatures, a condensed float32 distance store (``A`` is materialized on
    demand) and the incrementally-maintained dendrogram.  ``extend`` and
    ``depart`` fork the engine, so this object stays immutable-by-convention
    exactly like the pre-engine dataclass.  (A holder that *wants* streaming
    mutation — e.g. the PACFL FL strategy absorbing churn every few rounds —
    calls ``self.engine.admit/depart`` directly instead of forking; the
    views then track the live engine.)
    """

    config: PACFLConfig
    engine: ClusterEngine
    signature_bytes: int = 0        # uplink cost of the one-shot phase

    @property
    def U(self) -> torch.Tensor:
        """(K, n, p) stacked signatures."""
        return self.engine.U

    @property
    def A(self) -> np.ndarray:
        """(K, K) proximity matrix in degrees (dense view of the store)."""
        return self.engine.dense()  # repro-lint: ignore[R3]  # port of src/repro/core/pacfl.py, allowlisted there

    @property
    def labels(self) -> np.ndarray:
        """(K,) stable cluster ids (seen clients keep theirs across churn)."""
        return self.engine.labels

    @property
    def n_clusters(self) -> int:
        return int(self.labels.max()) + 1 if self.labels.size else 0

    def cluster_members(self, z: int) -> np.ndarray:
        return np.where(self.labels == z)[0]

    def membership(self) -> MembershipSnapshot:
        """Versioned (ids, labels) snapshot for the FL layer."""
        return self.engine.membership()

    def extend(self, U_new: torch.Tensor) -> "PACFLClustering":
        """Algorithms 2+3: admit newcomers, preserving seen-client ids.

        Honors the same clustering criterion as the one-shot phase: a set
        ``config.n_clusters`` overrides ``config.beta`` here exactly as it
        does in :func:`cluster_clients`.  Streaming: only the (M, B) cross
        and (B, B) square proximity blocks are computed, and the cached
        dendrogram is updated incrementally instead of re-clustered.
        """
        eng = self.engine.copy()
        eng.admit(U_new)
        extra_bytes = get_family(self.config.family).upload_bytes(U_new)
        return PACFLClustering(
            config=self.config,
            engine=eng,
            signature_bytes=self.signature_bytes + extra_bytes,
        )

    def depart(self, clients: np.ndarray) -> "PACFLClustering":
        """Churn: remove clients by stable id (``engine.ids`` — equal to row
        position until the first departure) — the symmetric delete to
        :meth:`extend`, a scenario the batch-synchronous API could not
        express."""
        eng = self.engine.copy()
        eng.depart(np.asarray(clients))
        return PACFLClustering(
            config=self.config,
            engine=eng,
            signature_bytes=self.signature_bytes,
        )


def compute_signatures(
    client_data: list,
    config: PACFLConfig,
    *,
    seed: Optional[int] = None,
    context: Optional[FamilyContext] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Client-side one-shot phase: stacked per-client bases over clients.

    Dispatches to the :class:`~repro_torch.core.signatures.SignatureFamily` named
    by ``config.family``.  For the default ``svd`` family ``client_data[k]``
    is the data matrix ``D_k`` (N features x M_k samples) — the bucketed
    batched path in :mod:`repro_torch.core.signatures.svd`, bitwise-identical to
    the pre-registry inline implementation.  Model-based families
    (``weight_delta``, ``inference``) take payloads with
    ``.x_train``/``.y_train`` and read the shared model off ``context``.
    """
    return get_family(config.family).signatures(
        client_data, config, seed=seed, context=context, device=device
    )


def cluster_clients(
    U_stack: torch.Tensor, config: PACFLConfig, *, device: DeviceLike = None
) -> PACFLClustering:
    """Server-side one-shot phase: proximity matrix + HC -> clustering.

    Bootstraps a :class:`~repro_torch.core.engine.ClusterEngine` (which caches the
    dendrogram merge script for later streaming ``extend``/``depart``).
    When ``config.beta_quantile`` is set (and ``n_clusters`` is not), the HC
    threshold is resolved from the off-diagonal proximity distribution
    before bootstrapping — the family-portable way to pick beta.
    """
    ecfg = engine_config(config)
    if config.beta_quantile is not None and config.n_clusters is None:
        from repro_torch.core.angles import proximity_matrix

        U_stack = as_f32(U_stack, resolve_device(device))
        A = proximity_matrix(
            U_stack,
            measure=config.measure,
            backend=config.proximity_backend,
            block_size=config.proximity_block,
        ).cpu().numpy()
        K = A.shape[0]
        off = A[~np.eye(K, dtype=bool)]
        if off.size:
            ecfg = dataclasses.replace(
                ecfg, beta=float(np.quantile(off, config.beta_quantile))
            )
        engine = ClusterEngine.from_proximity(A, U_stack, ecfg, device=device)
    else:
        engine = ClusterEngine.from_signatures(U_stack, ecfg, device=device)
    sig_bytes = get_family(config.family).upload_bytes(U_stack)
    return PACFLClustering(
        config=config, engine=engine, signature_bytes=sig_bytes
    )


def one_shot_clustering(
    client_data: list,
    config: PACFLConfig,
    *,
    seed: Optional[int] = None,
    context: Optional[FamilyContext] = None,
    device: DeviceLike = None,
) -> PACFLClustering:
    """End-to-end one-shot phase (lines 7-12 of Algorithm 1).

    ``seed`` seeds the randomized SVD methods' per-client sketches;
    ``device`` (default ``"cuda"``) is where signatures, proximity and the
    engine's signature stack live.
    """
    U = compute_signatures(
        client_data, config, seed=seed, context=context, device=device
    )
    return cluster_clients(U, config, device=device)
