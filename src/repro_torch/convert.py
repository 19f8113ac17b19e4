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
import functools
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
    ``PartitionSpec``s), walked along :func:`lm_layout`: each stage's
    ``(repeats, ...)`` leaves (the decoder's ``stages`` and the encoder's)
    give super-block ``r``'s parameter (``stages.{si}.{r}...``); ``r`` is
    None for a leaf outside the stages.  Raises on a reference key with no
    port counterpart; a port parameter the tree lacks is not yielded."""
    named = dict(model.named_parameters())

    def walk(layout, tree):
        if isinstance(layout, RefLeaf):
            for r, name in enumerate(layout.names):
                yield name, named[name], tree, r if layout.stacked else None
            return
        if isinstance(layout, list):
            if len(tree) != len(layout):
                raise ValueError(f"{len(tree)} reference stages vs {len(layout)}")
            for sub, val in zip(layout, tree):
                yield from walk(sub, val)
            return
        for key in tree:
            if key not in layout:
                raise ValueError(f"{key}: no port parameter or module of that name")
        for key, sub in layout.items():
            if key in tree:
                yield from walk(sub, tree[key])

    yield from walk(lm_layout(model.cfg), ref)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor on ``arr``'s memory where it is writable (a mapped
    checkpoint member's), else on a copy; the |V2 records of a bfloat16
    leaf as bfloat16."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _fill_from_numpy(model: lm.LM, ref: dict, local=None) -> lm.LM:
    """Set every parameter of ``model`` (allocated, any shape plan) from the
    reference tree, through ``local(name, tensor)`` when given (a rank's
    slice, taken before anything else is read or converted), each exactly
    once with a matching shape.  Leaves are float32 (other float dtypes
    pass through float32) or bfloat16's |V2 records."""
    unset = {id(p) for p in model.parameters()}
    for name, target, leaf, index in lm_leaves(model, ref):
        t = _tensor(np.asarray(leaf if index is None else leaf[index]))
        if local is not None:
            t = local(name, t)
        if tuple(target.shape) != tuple(t.shape):
            raise ValueError(f"{name.rsplit('.', 1)[-1]}: port {tuple(target.shape)} vs "
                             f"reference {tuple(t.shape)}")
        target.data.copy_(t if t.dtype == torch.bfloat16 else t.float())
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
    compute_dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
) -> lm.LM:
    """:func:`lm_params_from_numpy` on one rank of ``mesh``: the rank's
    slice of every leaf under ``plan`` (:mod:`repro_torch.sharding`), with
    the mesh's model axis attached, as
    :func:`repro_torch.sharding.init_params_sharded` lays it out; the
    model computes in ``compute_dtype`` (default: its weights' dtype).
    Only the slices are read, so a leaf may be a mapped array."""
    from repro_torch import sharding

    lay = sharding.layout(cfg, plan, mesh)
    model = lay.skeleton(dtype, compute_dtype).to_empty(device=resolve_device(device))
    return lay.attach(_fill_from_numpy(model, ref, lay.local))


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
            out[key] = torch.as_tensor(np.array(val), device=dev)   # a copy: val may be mapped
    return out


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """One leaf of the reference's ``lm.init_params`` tree in the port's
    terms: the port parameters it holds (one, or each super-block's of a
    stage in order, stacked along a new axis 0; none for a stage with no
    super-block) and the unsharded shape of each."""
    names: tuple[str, ...]
    stacked: bool
    shape: tuple[int, ...]

    @property
    def ref_shape(self) -> tuple[int, ...]:
        """The reference leaf's shape."""
        return (len(self.names), *self.shape) if self.stacked else self.shape


@functools.lru_cache(maxsize=None)
def lm_layout(cfg: ArchConfig) -> dict:
    """The reference's ``lm.init_params`` tree of ``cfg`` with a
    :class:`RefLeaf` at each leaf (built on ``meta`` once a
    configuration; treat it as read-only).  Each stage (the decoder's
    ``stages`` and the encoder's, ``encoder.stages``) is a list entry
    whose leaves stack its super-blocks' parameters; ``shared_attn`` and
    single tensors are one parameter each."""
    model = lm.init_params(cfg, device="meta")
    names = {id(p): n for n, p in model.named_parameters()}

    def stage_tree(stage, spec) -> dict:
        if len(stage):
            return stack([tree(sb) for sb in stage])
        proto = lm._init_stages(None, cfg, [dataclasses.replace(spec, repeats=1)], "meta",
                                torch.float32)[0][0]
        return empty(tree(torch.nn.ModuleDict(proto)))

    def tree(module) -> dict:
        out = {n: RefLeaf((names.get(id(p), n),), False, tuple(p.shape))
               for n, p in module.named_parameters(recurse=False)}
        for n, child in module.named_children():
            if n == "stages":
                specs = lm.stages_for(cfg) if module is model else lm.encoder_stages(cfg)
                out[n] = [stage_tree(stage, spec) for stage, spec in zip(child, specs)]
            else:
                out[n] = tree(child)
        return out

    def stack(trees: list) -> dict:
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else RefLeaf(tuple(t[k].names[0] for t in trees), True, trees[0][k].shape)
                for k in trees[0]}

    def empty(node: dict) -> dict:
        return {k: empty(v) if isinstance(v, dict) else RefLeaf((), True, v.shape)
                for k, v in node.items()}

    return tree(model)


def map_layout(fn, node):
    """``node`` (a tree of :func:`lm_layout`) with each :class:`RefLeaf`
    replaced by ``fn(leaf)``."""
    if isinstance(node, dict):
        return {k: map_layout(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [map_layout(fn, v) for v in node]
    return fn(node)


def lm_params_to_numpy(model: lm.LM, values: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> dict:
    """The reference's ``lm.init_params`` pytree layout of ``model``'s
    parameters, leaves as float32 NumPy arrays: the inverse of
    :func:`lm_params_from_numpy`.

    Each stage's super-blocks (the decoder's ``stages`` and the encoder's
    ``encoder.stages``) are restacked into ``(repeats, ...)`` leaves, a list
    entry per stage (:func:`lm_layout`); ``shared_attn`` and single tensors
    stay as they are.  With ``values`` (``{name: tensor}`` keyed by
    ``model.named_parameters`` names, e.g. the train step's gradients)
    those tensors take the parameters' places, so port gradients compare
    with the reference's leaf by leaf.  Every tensor must have the
    unsharded model's shape: a rank's pieces raise (a sharded model's
    checkpoint is :func:`repro_torch.ckpt.save_sharded`'s).
    """
    named = dict(model.named_parameters())

    def array(name: str, shape: tuple) -> np.ndarray:
        t = named[name] if values is None else values[name]
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, the unsharded model's is {shape}: a rank's "
                "piece; write a sharded model's state with repro_torch.ckpt.save_sharded")
        return t.detach().float().cpu().numpy()

    def leaf(ref: RefLeaf) -> np.ndarray:
        if not ref.names:   # a stage with no super-block: (0, ...) leaves
            return np.zeros(ref.ref_shape, dtype=np.float32)
        if ref.stacked:
            return np.stack([array(n, ref.shape) for n in ref.names])
        return array(ref.names[0], ref.shape)

    return map_layout(leaf, lm_layout(model.cfg))


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
