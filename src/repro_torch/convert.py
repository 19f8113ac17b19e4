"""Carry the reference's state across into the port.

The clustering system has no model weights: its state is the signature
stack, the proximity matrix and the config.  The LM zoo has weights: the
reference's ``lm.init_params`` pytree.  These helpers take the reference's
values as NumPy arrays and plain dicts (``dataclasses.asdict`` of a
``repro.core.pacfl.PACFLConfig``), so the port never imports the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.pacfl import PACFLConfig, engine_config
from repro_torch.models import lm

# Reference proximity backends -> the port's.  The device-sharded backend
# has no counterpart on one card.
BACKEND_FROM_REFERENCE = {
    "auto": "auto",
    "jnp": "torch",
    "jnp_blocked": "torch_blocked",
    "pallas": "kernel",
}


def config_from_reference(ref: dict) -> PACFLConfig:
    """A :class:`PACFLConfig` from ``dataclasses.asdict`` of the reference's.

    The proximity backend is renamed (``jnp`` -> ``torch``, ``jnp_blocked``
    -> ``torch_blocked``, ``pallas`` -> ``kernel``); ``jnp_sharded`` and
    unknown fields raise.
    """
    fields = {f.name for f in dataclasses.fields(PACFLConfig)}
    unknown = set(ref) - fields
    if unknown:
        raise ValueError(f"fields the port's PACFLConfig lacks: {sorted(unknown)}")
    kw = dict(ref)
    backend = kw.get("proximity_backend", "auto")
    if backend not in BACKEND_FROM_REFERENCE:
        raise ValueError(
            f"reference proximity backend {backend!r} has no counterpart in "
            f"the port (have {sorted(BACKEND_FROM_REFERENCE)})"
        )
    kw["proximity_backend"] = BACKEND_FROM_REFERENCE[backend]
    kw["family_params"] = dict(kw.get("family_params", {}))
    return PACFLConfig(**kw)


def signatures_from_numpy(U: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """(K, n, p) signature stack as a float32 tensor on ``device``."""
    U = np.asarray(U)
    if U.ndim != 3:
        raise ValueError(f"expected a (K, n, p) stack, got shape {U.shape}")
    return as_f32(U, resolve_device(device))


def engine_from_numpy(
    A: np.ndarray, U: np.ndarray, config: PACFLConfig, device: DeviceLike = None
) -> ClusterEngine:
    """A :class:`ClusterEngine` adopting proximity matrix ``A`` (degrees)
    and signatures ``U``, as ``repro``'s ``ClusterEngine.from_proximity``
    builds one from the same arrays."""
    dev = resolve_device(device)
    return ClusterEngine.from_proximity(
        np.asarray(A, dtype=np.float32),
        signatures_from_numpy(U, dev),
        engine_config(config),
        device=dev,
    )


def lm_params_from_numpy(
    cfg: ArchConfig, ref: dict, *, dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> lm.LM:
    """The port's :class:`repro_torch.models.lm.LM` holding the reference's
    ``lm.init_params(cfg, key)`` pytree (leaves as NumPy arrays).

    Each stage's ``(repeats, ...)`` stacked leaves are unstacked into the
    stage's super-blocks.  Every port parameter is set exactly once, with
    the reference's shape; weights of two or more dimensions land in
    ``dtype``, as :func:`repro_torch.models.lm.init_params` stores them.
    """
    dev = resolve_device(device)
    model = lm.init_params(cfg, dtype=dtype, device="meta").to_empty(device=dev)
    unset = {id(p) for p in model.parameters()}

    def put(module, tree: dict, index=None) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                put(getattr(module, key), val, index)
                continue
            target = getattr(module, key)
            arr = np.asarray(val if index is None else val[index])
            if tuple(target.shape) != arr.shape:
                raise ValueError(f"{key}: port {tuple(target.shape)} vs reference {arr.shape}")
            target.data.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
            unset.discard(id(target))

    top = {k: v for k, v in ref.items() if k != "stages"}
    put(model, top)
    if len(ref["stages"]) != len(model.stages):
        raise ValueError(f"{len(ref['stages'])} reference stages vs {len(model.stages)}")
    for stage_ref, stage in zip(ref["stages"], model.stages):
        for r, superblock in enumerate(stage):
            put(superblock, stage_ref, r)
    if unset:
        raise ValueError(f"{len(unset)} port parameters have no reference leaf")
    return model
