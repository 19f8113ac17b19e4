"""The ``inference`` family: FLIS-style inference similarity on a probe set.

Port of ``repro.core.signatures.inference``.  Clients are clustered by how
similarly their locally trained models *predict* on a small server-held
probe set:

1. the server fixes a shared probe set X_probe (m, d): by default 48 rows
   of every synthetic dataset family (``repro_torch.data.synthetic``, equal
   to the reference's), or the context's ``probe``, and broadcasts it once
   (:meth:`InferenceFamily.downlink_bytes`);
2. every client warms up the common init theta_0 on its own data for one
   segment of local-SGD steps (same plumbing as ``weight_delta``);
3. its softmax prediction matrix P_k = softmax(f(theta_k, X_probe)), (m, C),
4. gives the (m, p) signature, the top-p left singular basis of P_k.

Requires ``n_classes >= p`` (P_k has C columns).  ``family_params`` knobs
(defaults): ``probe_per_dataset`` (48), ``probe_seed`` (0), ``steps`` (16),
``batch_size`` (16), ``lr`` (0.05), ``momentum`` (0.5).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from repro_torch._device import DeviceLike, float32_math, resolve_device
from repro_torch.core.signatures.base import (
    FamilyContext,
    SignatureFamily,
    register_family,
)
from repro_torch.core.signatures.warmup import chunk_indices, resolve_model, warmup_segments
from repro_torch.core.svd import truncated_svd

IF_CHUNK = 64


def _params(config) -> dict:
    fp = dict(getattr(config, "family_params", None) or {})
    return {
        "probe_per_dataset": int(fp.get("probe_per_dataset", 48)),
        "probe_seed": int(fp.get("probe_seed", 0)),
        "steps": int(fp.get("steps", 16)),
        "batch_size": int(fp.get("batch_size", 16)),
        "lr": float(fp.get("lr", 0.05)),
        "momentum": float(fp.get("momentum", 0.5)),
    }


@functools.lru_cache(maxsize=8)
def _default_probe(dim: int, per_dataset: int, seed: int) -> np.ndarray:
    """Deterministic (m, d) probe spanning every synthetic dataset family."""
    from repro_torch.data.synthetic import DATASET_NAMES, make_dataset

    parts = [
        make_dataset(name, n_train=per_dataset, n_test=8, dim=dim, seed=seed).x_train
        for name in DATASET_NAMES
    ]
    return np.concatenate(parts, axis=0).astype(np.float32)


def prediction_bases(
    model: torch.nn.Module, params: dict[str, torch.Tensor], probe: torch.Tensor, p: int
) -> torch.Tensor:
    """Each client's softmax prediction matrix on the probe -> its top-p
    left basis, (B, m, min(p, C))."""

    def one(theta):
        return torch.softmax(functional_call(model, theta, (probe,)), dim=-1)

    with torch.no_grad():
        return truncated_svd(vmap(one)(params), p)


class InferenceFamily(SignatureFamily):
    """Top-p basis of each client's probe-set prediction matrix."""

    name = "inference"
    needs_model = True

    def probe_for(
        self, payloads: list, config, context: Optional[FamilyContext]
    ) -> np.ndarray:
        if context is not None and context.probe is not None:
            return np.asarray(context.probe, dtype=np.float32)
        hp = _params(config)
        d = int(np.asarray(payloads[0].x_train).shape[1])
        return _default_probe(d, hp["probe_per_dataset"], hp["probe_seed"])

    def prepare_context(
        self,
        payloads: list,
        config,
        context: Optional[FamilyContext] = None,
    ) -> FamilyContext:
        """Stash the resolved probe so later single-client signature calls
        (churn enqueues) and downlink accounting agree on one probe set."""
        ctx = context if context is not None else FamilyContext()
        if ctx.probe is None:
            ctx.probe = self.probe_for(payloads, config, ctx)
        return ctx

    def signatures(
        self,
        payloads: list,
        config,
        *,
        seed: Optional[int] = None,
        context: Optional[FamilyContext] = None,
        device: DeviceLike = None,
    ) -> torch.Tensor:
        if not payloads:
            raise ValueError("inference needs at least one client")
        dev = resolve_device(device)
        seed = 0 if seed is None else int(seed)
        hp = _params(config)
        p = int(config.p)
        with float32_math():
            model, theta0 = resolve_model(context, payloads, dev)
            probe = torch.as_tensor(self.probe_for(payloads, config, context), device=dev)
            out = []
            for lo in range(0, len(payloads), IF_CHUNK):
                chunk = payloads[lo : lo + IF_CHUNK]
                n = torch.as_tensor([len(q.y_train) for q in chunk], device=dev)
                idx = chunk_indices(
                    context, len(payloads), lo, n, segments=1, steps=hp["steps"],
                    batch_size=hp["batch_size"], seed=seed)
                params = None
                for _, params in warmup_segments(
                    chunk, model=model, theta0=theta0, indices=idx,
                    steps=hp["steps"], batch_size=hp["batch_size"], lr=hp["lr"],
                    momentum=hp["momentum"], device=dev,
                ):
                    pass
                U = prediction_bases(model, params, probe, p)
                if int(U.shape[-1]) < p:
                    raise ValueError(
                        f"inference family needs n_classes >= p: the prediction "
                        f"matrix has only {U.shape[-1]} columns for p={p}"
                    )
                out.append(U)
            return torch.cat(out)

    def downlink_bytes(
        self, config, context: Optional[FamilyContext], n_clients: int
    ) -> int:
        """Probe broadcast: every client downloads X_probe once (0 while no
        probe is resolved on the context: the cost is unknown)."""
        if context is not None and context.probe is not None:
            probe = np.asarray(context.probe, dtype=np.float32)
            return int(probe.size * probe.itemsize * n_clients)
        return 0


register_family(InferenceFamily())
