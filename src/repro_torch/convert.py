"""Carry the reference's state across into the port.

The clustering system has no model weights: its state is the signature
stack, the proximity matrix and the config.  The LM zoo has weights: the
reference's ``lm.init_params`` pytree; so do the FL models: the
reference's ``models.cnn.MODEL_ZOO`` param trees.  These helpers take the reference's
values as NumPy arrays and plain dicts (``dataclasses.asdict`` of a
``repro.core.pacfl.PACFLConfig``), so the port never imports the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.pacfl import PACFLConfig, engine_config
from repro_torch.models import lm

# Architectures of ``repro_torch.models.cnn.MODEL_ZOO`` and the top-level
# leaves of their reference param trees.
CNN_TOP_LEVEL = {
    "mlp": {"layers"},
    "lenet5": {"c1", "c2", "f1", "f2", "f3", "_meta"},
    "resnet9": {"b1", "b2", "b3a", "b3b", "b4", "b5", "b6a", "b6b", "fc"},
}

# Reference proximity backends -> the port's.
BACKEND_FROM_REFERENCE = {
    "auto": "auto",
    "jnp": "torch",
    "jnp_blocked": "torch_blocked",
    "jnp_sharded": "sharded",
    "pallas": "kernel",
}


def config_from_reference(ref: dict) -> PACFLConfig:
    """A :class:`PACFLConfig` from ``dataclasses.asdict`` of the reference's.

    The proximity backend is renamed (``jnp`` -> ``torch``, ``jnp_blocked``
    -> ``torch_blocked``, ``jnp_sharded`` -> ``sharded``, ``pallas`` ->
    ``kernel``); an unknown backend and unknown fields raise.
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


def lm_leaves(model: lm.LM, ref: Any
              ) -> Iterator[tuple[str, torch.nn.Parameter, Any, Optional[int]]]:
    """``(port parameter name, port parameter, reference leaf, r)`` for
    every leaf of a tree laid out as the reference's ``lm.init_params``
    pytree (its values, or any tree of that layout, such as its
    ``PartitionSpec``s): the tree walk that unstacks each stage's
    ``(repeats, ...)`` leaves (the decoder's ``stages`` and the encoder's)
    into super-block ``r``'s parameter (``stages.{si}.{r}...``); ``r`` is
    None for a leaf outside the stages.  Raises on a reference key with no
    port counterpart."""
    def walk(module, tree: dict, prefix: str, index):
        for key, val in tree.items():
            if key == "stages":
                if len(val) != len(module.stages):
                    raise ValueError(f"{len(val)} reference stages vs {len(module.stages)}")
                for si, (stage_ref, stage) in enumerate(zip(val, module.stages)):
                    for r, superblock in enumerate(stage):
                        yield from walk(superblock, stage_ref, f"{prefix}stages.{si}.{r}.", r)
                continue
            target = getattr(module, key, None)
            if target is None:
                raise ValueError(f"{key}: no port parameter or module of that name")
            if isinstance(val, dict):
                yield from walk(target, val, f"{prefix}{key}.", index)
            else:
                yield f"{prefix}{key}", target, val, index

    yield from walk(model, ref, "", None)


def _fill_from_numpy(model: lm.LM, ref: dict, local=None) -> lm.LM:
    """Set every parameter of ``model`` (allocated, any shape plan) from the
    reference tree, through ``local(name, array)`` when given (a rank's
    slice), each exactly once with a matching shape."""
    unset = {id(p) for p in model.parameters()}
    for name, target, leaf, index in lm_leaves(model, ref):
        arr = np.asarray(leaf if index is None else leaf[index])
        if local is not None:
            arr = local(name, torch.from_numpy(np.array(arr, dtype=np.float32))).numpy()
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{name.rsplit('.', 1)[-1]}: port {tuple(target.shape)} vs "
                             f"reference {arr.shape}")
        target.data.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        unset.discard(id(target))
    if unset:
        raise ValueError(f"{len(unset)} port parameters have no reference leaf")
    return model


def lm_params_from_numpy(
    cfg: ArchConfig, ref: dict, *, dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> lm.LM:
    """The port's :class:`repro_torch.models.lm.LM` holding the reference's
    ``lm.init_params(cfg, key)`` pytree (leaves as NumPy arrays).

    Each stage's ``(repeats, ...)`` stacked leaves (the decoder's
    ``stages`` and the encoder's, ``encoder.stages``) are unstacked into
    the stage's super-blocks (:func:`lm_leaves`); ``shared_attn`` and the
    encoder's ``final_norm`` are single leaves, and MoE blocks keep their
    expert axis (``w_in`` (E, D, F), ...).  Every port parameter is set
    exactly once, with the reference's shape; weights of two or more
    dimensions land in ``dtype``, as
    :func:`repro_torch.models.lm.init_params` stores them.
    """
    dev = resolve_device(device)
    model = lm.init_params(cfg, dtype=dtype, device="meta").to_empty(device=dev)
    return _fill_from_numpy(model, ref)


def lm_shard_from_numpy(
    cfg: ArchConfig, ref: dict, plan: dict, mesh, *, dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> lm.LM:
    """:func:`lm_params_from_numpy` on one rank of ``mesh``: the rank's
    slice of every leaf under ``plan`` (:mod:`repro_torch.sharding`), with
    the mesh's model axis attached, as
    :func:`repro_torch.sharding.init_params_sharded` lays it out."""
    from repro_torch import sharding

    lay = sharding.layout(cfg, plan, mesh)
    model = lay.skeleton(dtype).to_empty(device=resolve_device(device))
    return lay.attach(_fill_from_numpy(model, ref,
                                       lambda name, t: lay.local(name, t).contiguous()))


def opt_state_shard_from_numpy(
    cfg: ArchConfig, ref_state: Mapping, plan: dict, mesh, *, device: DeviceLike = None,
) -> dict:
    """The reference's optimizer state (AdamW's ``{"step", "m", "v"}``,
    SGD's ``{"step", "mu"}``; leaves as NumPy arrays) on one rank of
    ``mesh``, as :mod:`repro_torch.optim` keeps it: each moment tree, laid
    out like the parameters, becomes ``{name: the rank's float32 piece}``
    by :func:`repro_torch.sharding.opt_state_specs` (the moments mirror
    ``plan``), and the step (replicated) an int32 scalar."""
    dev = resolve_device(device)
    out = {}
    for key, val in ref_state.items():
        if isinstance(val, Mapping):
            model = lm_shard_from_numpy(cfg, val, plan, mesh, device=dev)
            out[key] = {n: p.detach() for n, p in model.named_parameters()}
        else:
            out[key] = torch.as_tensor(np.asarray(val), device=dev)
    return out


def lm_params_to_numpy(model: lm.LM, values: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> dict:
    """The reference's ``lm.init_params`` pytree layout of ``model``'s
    parameters, leaves as float32 NumPy arrays: the inverse of
    :func:`lm_params_from_numpy`.

    Each stage's super-blocks (the decoder's ``stages`` and the encoder's
    ``encoder.stages``) are restacked into ``(repeats, ...)`` leaves, a list
    entry per stage; ``shared_attn`` and single tensors stay as they are.
    With ``values`` (``{name: tensor}`` keyed by ``model.named_parameters``
    names, e.g. the train step's gradients) those tensors take the
    parameters' places, so port gradients compare with the reference's
    leaf by leaf.
    """
    names = {id(p): n for n, p in model.named_parameters()}
    cfg = model.cfg

    def leaf(p) -> np.ndarray:
        if p.device.type == "meta":   # a stage with no super-block: (0, ...) leaves
            return np.zeros((0, *p.shape), dtype=np.float32)
        t = p if values is None else values[names[id(p)]]
        return t.detach().float().cpu().numpy()

    def stage_tree(stage, spec) -> dict:
        if len(stage):
            return stack([tree(sb) for sb in stage])
        proto = lm._init_stages(None, cfg, [dataclasses.replace(spec, repeats=1)], "meta",
                                torch.float32)[0][0]
        return tree(torch.nn.ModuleDict(proto))

    def tree(module) -> dict:
        out = {n: leaf(p) for n, p in module.named_parameters(recurse=False)}
        for n, child in module.named_children():
            if n == "stages":
                specs = lm.stages_for(cfg) if module is model else lm.encoder_stages(cfg)
                out[n] = [stage_tree(stage, spec) for stage, spec in zip(child, specs)]
            else:
                out[n] = tree(child)
        return out

    def stack(trees: list) -> dict:
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees]) for k in trees[0]}

    return tree(model)


def _flatten_tree(tree, prefix: str = ""):
    """``(dotted name, leaf)`` pairs of a nested dict / list param tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        name = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            yield from _flatten_tree(val, name + ".")
        else:
            yield name, val


def cnn_params_from_numpy(
    arch: str,
    tree: dict,
    *,
    model: torch.nn.Module,
    stacked: bool = False,
    device: DeviceLike = None,
) -> dict[str, torch.Tensor]:
    """The port's ``{name: tensor}`` params for ``model`` from a reference
    ``MODEL_ZOO`` param tree of ``arch`` (leaves as NumPy arrays).

    Names join the tree's keys with dots (``f1.w``, ``b3a.gs``,
    ``layers.0.b``) and come out in ``model``'s parameter order; names and
    shapes must equal the module's.  Convolution weights (4-D; 5-D with
    ``stacked``) transpose from the reference's HWIO to OIHW; every other
    leaf keeps its layout.  ``stacked`` takes a ``(K, ...)`` stack of K
    trees (per-client or per-cluster state) and keeps the leading axis.
    LeNet-5's ``_meta`` leaf (``in_hw``, ``in_ch``) carries no parameter
    and may be absent: when present it must match ``model``'s input; the
    port's byte counts add its 12 bytes through ``LeNet5.meta_bytes``.
    Every other reference leaf lands in exactly one port tensor.
    """
    if arch not in CNN_TOP_LEVEL:
        raise ValueError(f"unknown model {arch!r}; have {sorted(CNN_TOP_LEVEL)}")
    if set(tree) - {"_meta"} != CNN_TOP_LEVEL[arch] - {"_meta"} or not (
        set(tree) <= CNN_TOP_LEVEL[arch]
    ):
        raise ValueError(
            f"{arch}: reference leaves {sorted(tree)} vs {sorted(CNN_TOP_LEVEL[arch])}"
        )
    if "_meta" in tree:
        hw = tuple(int(v) for v in np.asarray(tree["_meta"]["in_hw"]).reshape(-1, 2)[0])
        ch = int(np.asarray(tree["_meta"]["in_ch"]).reshape(-1)[0])
        if (hw, ch) != (tuple(model.in_hw), model.in_ch):
            raise ValueError(f"_meta {(hw, ch)} vs the module's {(model.in_hw, model.in_ch)}")
    dev = resolve_device(device)
    lead = 1 if stacked else 0
    out: dict[str, torch.Tensor] = {}
    for name, leaf in _flatten_tree({k: v for k, v in tree.items() if k != "_meta"}):
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.ndim == 4 + lead:   # HWIO -> OIHW
            arr = arr.transpose(*range(lead), 3 + lead, 2 + lead, lead, 1 + lead)
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(dev)
    want = dict(model.named_parameters())
    if set(want) != set(out):
        raise ValueError(f"{arch}: names {sorted(out)} vs the module's {sorted(want)}")
    for name, p in want.items():
        if tuple(out[name].shape[lead:]) != tuple(p.shape):
            raise ValueError(
                f"{name}: reference {tuple(out[name].shape[lead:])} vs port {tuple(p.shape)}"
            )
    return {name: out[name] for name in want}


def projection_from_numpy(
    proj: np.ndarray, model: torch.nn.Module, device: DeviceLike = None
) -> torch.Tensor:
    """The reference ``weight_delta`` sketch ``(n_params, sketch_dim)`` as
    ``FamilyContext.projection`` takes it for ``model``.

    The port flattens parameters in the reference's leaf order and layout
    (``core.signatures.warmup.flatten_params``), so rows map one to one.
    A reference LeNet-5 tree also carries its ``_meta`` leaf (``in_ch``, then
    the two ``in_hw``: 3 values, first in its sorted leaf order); where the
    projection has those 3 rows more than the module's parameters, they are
    dropped (``_meta`` never trains, so its delta is zero).
    """
    proj = np.asarray(proj, dtype=np.float32)
    n_params = sum(p.numel() for p in model.parameters())
    meta_rows = model.meta_bytes // 4 if hasattr(model, "meta_bytes") else 0
    if proj.ndim == 2 and meta_rows and proj.shape[0] == n_params + meta_rows:
        proj = proj[meta_rows:]
    if proj.ndim != 2 or proj.shape[0] != n_params:
        raise ValueError(
            f"projection {proj.shape} has no row for each of the module's {n_params} parameters")
    return as_f32(proj, resolve_device(device))
