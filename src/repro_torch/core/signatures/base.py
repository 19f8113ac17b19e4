"""Signature-family contract + registry: one engine, many similarity measures.

Port of ``repro.core.signatures.base``.  Everything above the one-shot
signature phase only ever sees a (K, n, p) stack of per-client orthonormal
bases and the distances between them; a :class:`SignatureFamily` is the
pluggable client-side extractor that produces that stack.  This slice of
the port carries the paper's ``svd`` family only.

The contract every family satisfies:

* :meth:`SignatureFamily.signatures` maps K client payloads to a (K, n, p)
  float32 stack with orthonormal columns, deterministic in ``(payloads,
  config, seed, context)`` and independent of cluster membership.
* :meth:`SignatureFamily.upload_bytes` / :meth:`downlink_bytes` own the
  family's communication accounting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.core.svd import signature_upload_bytes


@dataclass
class FamilyContext:
    """Server-side resources a model-based family may need.

    ``seed0`` seeds the shared init of the model-based families (the
    reference's ``key0``); ``probe`` overrides the ``inference`` family's
    probe set.
    """

    apply_fn: Optional[Callable] = None
    init_fn: Optional[Callable] = None
    seed0: Optional[int] = None
    probe: Optional[np.ndarray] = None

    def base_seed(self) -> int:
        return self.seed0 if self.seed0 is not None else 0


@dataclass
class ClientPayload:
    """Minimal family payload: one client's local training split."""

    x_train: np.ndarray   # (M, d) samples as rows
    y_train: np.ndarray   # (M,)


def payloads_from_stacked(data: Any) -> list[ClientPayload]:
    """Per-client payloads from a stacked-clients container (``x``, ``y``,
    ``n``, ``n_clients``): each client's true samples ``x[k, :n[k]]``."""
    return [
        ClientPayload(
            x_train=data.x[k, : data.n[k]], y_train=data.y[k, : data.n[k]]
        )
        for k in range(data.n_clients)
    ]


def client_matrix(payload: Any) -> torch.Tensor:
    """Normalize a payload to the paper's (d features, M samples) matrix."""
    if hasattr(payload, "x_train"):
        return torch.as_tensor(payload.x_train).T
    D = torch.as_tensor(payload)
    if D.ndim != 2:
        raise ValueError(
            f"payload must be a (d, M) matrix or have .x_train, got "
            f"shape {tuple(D.shape)}"
        )
    return D


class SignatureFamily:
    """Base class: per-client orthonormal (n, p) bases + byte accounting."""

    name = "base"
    needs_model = False

    def signatures(
        self,
        payloads: list,
        config,
        *,
        seed: Optional[int] = None,
        context: Optional[FamilyContext] = None,
        device: DeviceLike = None,
    ) -> torch.Tensor:
        """(K, n, p) float32 stack of orthonormal client bases."""
        raise NotImplementedError

    def signature_one(
        self,
        payload,
        config,
        *,
        seed: Optional[int] = None,
        context: Optional[FamilyContext] = None,
        device: DeviceLike = None,
    ) -> torch.Tensor:
        """Single-client signature."""
        return self.signatures(
            [payload], config, seed=seed, context=context, device=device
        )[0]

    def prepare_context(
        self,
        payloads: list,
        config,
        context: Optional[FamilyContext] = None,
    ) -> FamilyContext:
        """Resolve server-side resources before the one-shot phase."""
        del payloads, config
        return context if context is not None else FamilyContext()

    def upload_bytes(self, U: torch.Tensor) -> int:
        """Uplink bytes for a (K, n, p) or (n, p) signature stack."""
        return signature_upload_bytes(U)

    def downlink_bytes(
        self, config, context: Optional[FamilyContext], n_clients: int
    ) -> int:
        """Fixed server->clients bytes before signatures; zero for
        data-local families."""
        return 0


_REGISTRY: dict[str, SignatureFamily] = {}


def register_family(family: SignatureFamily) -> SignatureFamily:
    """Register a family instance under ``family.name`` (latest wins)."""
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> SignatureFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown signature family {name!r}; have {family_names()}"
        ) from None


def family_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
