"""The ``weight_delta`` family: FedClust-style model-weight geometry.

Port of ``repro.core.signatures.weight_delta``.  Clients are clustered on
the geometry of their model-weight updates rather than their raw data:

1. every client starts from a **common init** theta_0 (``init_fn(seed0)``),
2. runs ``segments`` short local-SGD warmup segments on its own data
   (vmapped across clients: :mod:`repro_torch.core.signatures.warmup`),
3. records the flattened delta ``theta_s - theta_0`` after each segment, in
   the reference's coordinate order (:func:`~.warmup.flatten_params`),
4. sketches the parameter axis down with one shared Gaussian projection
   (``sketch_dim``; all clients must land in the same sketched space),
5. takes the top-p left singular basis (exact SVD): a (n, p) orthonormal
   signature like the ``svd`` family's, so everything downstream is
   untouched.

The projection is ``N(0, 1) / sqrt(sketch_dim)`` of shape ``(n_params,
sketch_dim)``, drawn once per call on the device from a generator seeded
from ``(seed0, 0x5EED)``, unless the context gives it (the reference draws
it from ``fold_in(key0, 0x5EED)``).  The warmup runs under
:func:`repro_torch._device.float32_math`, so signatures do not depend on
the caller's TF32 or cuDNN settings.

``family_params`` knobs (with defaults): ``segments`` (4, floored at
``p``), ``steps`` (8 SGD steps per segment), ``batch_size`` (16), ``lr``
(0.05), ``momentum`` (0.5), ``sketch_dim`` (256; 0 disables sketching).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch._device import DeviceLike, float32_math, resolve_device
from repro_torch.core.signatures.base import (
    FamilyContext,
    SignatureFamily,
    register_family,
)
from repro_torch.core.signatures.warmup import (
    chunk_indices,
    flatten_params,
    resolve_model,
    warmup_segments,
)
from repro_torch.core.svd import truncated_svd

# Chunk edge for the vmapped warmup: bounds peak memory at CHUNK stacked
# model replicas (mirrors the svd family's SIG_BATCH_MAX).
WD_CHUNK = 64
# Entropy the projection's generator adds to seed0 (the reference's fold-in).
PROJECTION_SALT = 0x5EED


def _params(config) -> dict:
    fp = dict(getattr(config, "family_params", None) or {})
    p = int(config.p)
    return {
        "segments": max(int(fp.get("segments", 4)), p),
        "steps": int(fp.get("steps", 8)),
        "batch_size": int(fp.get("batch_size", 16)),
        "lr": float(fp.get("lr", 0.05)),
        "momentum": float(fp.get("momentum", 0.5)),
        "sketch_dim": int(fp.get("sketch_dim", 256)),
    }


def sketch_projection(
    n_params: int, sketch_dim: int, seed0: int, device: torch.device
) -> torch.Tensor:
    """The shared ``(n_params, sketch_dim)`` Gaussian sketch, scaled by
    ``1 / sqrt(sketch_dim)``, drawn on ``device`` from ``(seed0, 0x5EED)``."""
    from repro_torch.fl.client import derive_seed

    gen = torch.Generator(device=device).manual_seed(derive_seed(seed0, PROJECTION_SALT))
    return torch.randn((n_params, sketch_dim), generator=gen, device=device) / math.sqrt(
        sketch_dim)


class WeightDeltaFamily(SignatureFamily):
    """Top-p orthonormal directions of local-update deltas from theta_0."""

    name = "weight_delta"
    needs_model = True

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
            raise ValueError("weight_delta needs at least one client")
        dev = resolve_device(device)
        seed = 0 if seed is None else int(seed)
        hp = _params(config)
        with float32_math():
            model, theta0 = resolve_model(context, payloads, dev)
            flat0 = flatten_params({k: v[None] for k, v in theta0.items()})  # (1, n_params)
            n_params = int(flat0.shape[1])
            sketch = hp["sketch_dim"]
            proj = None
            if 0 < sketch < n_params:
                given = None if context is None else context.projection
                if given is None:
                    seed0 = (context or FamilyContext()).base_seed()
                    proj = sketch_projection(n_params, sketch, seed0, dev)
                elif tuple(given.shape) != (n_params, sketch):
                    raise ValueError(
                        f"context.projection {tuple(given.shape)} is not "
                        f"({n_params}, {sketch})")
                else:
                    proj = torch.as_tensor(given, dtype=torch.float32, device=dev)
            out = []
            for lo in range(0, len(payloads), WD_CHUNK):
                chunk = payloads[lo : lo + WD_CHUNK]
                n = torch.as_tensor([len(p.y_train) for p in chunk], device=dev)
                idx = chunk_indices(
                    context, len(payloads), lo, n, segments=hp["segments"],
                    steps=hp["steps"], batch_size=hp["batch_size"], seed=seed)
                cols = []
                for _, params in warmup_segments(
                    chunk, model=model, theta0=theta0, indices=idx,
                    steps=hp["steps"], batch_size=hp["batch_size"], lr=hp["lr"],
                    momentum=hp["momentum"], device=dev,
                ):
                    delta = flatten_params(params) - flat0   # (B, n_params)
                    if proj is not None:
                        delta = delta @ proj                 # (B, sketch)
                    cols.append(delta)
                D = torch.stack(cols, dim=-1)                # (B, n, S)
                out.append(truncated_svd(D, config.p).detach())
            return torch.cat(out)


register_family(WeightDeltaFamily())
