"""Sharding rules, and the sharded parameters they describe.

Port of ``repro.sharding``.  The reference's rules map each leaf of its
parameter, optimizer-state, batch and cache pytrees to a GSPMD
``PartitionSpec``; here each port parameter (a ``named_parameters()`` key)
maps to a tuple with one entry per dimension: an axis name of the mesh
(:mod:`repro_torch.launch.mesh`), a tuple of them (major first), or None.
The rules and their order are the reference's:

* ``fsdp_tp`` (default): weight matrices' feature-in dim over ``data``
  (FSDP) and feature-out dim over ``model`` (tensor parallelism);
  out-projections transpose the pattern;
* expert weights: the expert dim over ``model`` when the experts divide by
  16 (llama4: 16 experts), else each expert's ffn dim (qwen2: 60);
* ``tp_only``: no FSDP, weights replicated over ``data``; ``ddp``: every
  weight replicated.

The port unstacks each stage into super-blocks (``stages.{si}.{r}``), so
the reference's leading stacked ``None`` is not part of a port spec.

Execution, serving and training alike: :func:`init_params_sharded` and
:func:`shard_params` give one rank the contiguous slice of every sharded
dimension that ``torch.tensor_split`` gives it (a Mamba2 leaf's columns
over ``model`` by component instead, :func:`mamba_parts`, and an attention
leaf's by head, :func:`attn_heads`: where the KV heads are fewer than the
model axis's ranks, a group of ranks shares each KV head and splits its
query heads), and attach the mesh's axes (:class:`ShardLayout`): the model
axis, over which
:mod:`repro_torch.models` sums the row-parallel partials; with ``fsdp_tp``
on a data axis above 1, the weights held as the rank's piece over
``data`` (FSDP), gathered just before use and their gradients
reduce-scattered; and the axes the batch's rows split over, over which
:func:`repro_torch.models.lm.value_and_grad` averages the loss and the
gradients; and the group of ranks that shares the rank's KV head (the
replica group), over which the KV weights' gradients are summed.
:func:`repro_torch.models.lm.make_train_step` then steps each
rank's pieces with the elementwise optimizer, its state the rank's pieces
(:func:`opt_state_specs`).  The collectives are written out, driven by the
plan (no ``DistributedDataParallel`` or FSDP wrapper, which read no mixed
``("data", "model")`` plan).  Every family executes sharded, with the
``model`` entries in the ``tp_only`` layout; :func:`check_plan` refuses
anything else, with the reason.  The batch splits over ``data``
(:func:`local_batch`).  The KV caches (ring caches too) and the recurrent
states of a sharded model hold each rank's heads (a shared KV head's cache
on each rank of its group), which head-parallel attention, Mamba2 and
RWKV6 need;
:func:`cache_specs` is the reference's cache plan (sequence over ``model``
from 8192 slots, replicated below), ported as a plan and not what the
execution lays out.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Union

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, ssm
from repro_torch.models.layers import Fsdp, MeshAxis

SCHEMES = ("fsdp_tp", "tp_only", "ddp")
Spec = tuple   # one entry a dimension: None, an axis name, or a tuple of names
Plan = dict    # parameter name -> Spec


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _entry(axes: tuple[str, ...]):
    """A spec entry over ``axes``: the name alone for one axis (as
    ``PartitionSpec`` normalises it)."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _spec_for_leaf(name: str, ndim: int, cfg: ArchConfig, scheme: str) -> Spec:
    """Classify one parameter by its last name component and its rank."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; have {SCHEMES}")
    fsdp = "data" if scheme == "fsdp_tp" else None
    tp = "model" if scheme in ("fsdp_tp", "tp_only") else None

    if scheme == "ddp":
        return (None,) * ndim
    # embedding (V, D): vocab over model
    if name == "embed":
        return (tp, fsdp)
    # lm head (D, V): vocab-parallel
    if name == "lm_head":
        return (fsdp, tp)
    # attention projections
    if name in ("q", "k", "v"):
        return (fsdp, tp)
    if name == "o":
        return (tp, fsdp)
    # mlp
    if name in ("w_in", "w_gate"):
        if ndim == 3:  # expert weights (E, D, F)
            if cfg.n_experts and cfg.n_experts % 16 == 0:
                return (tp, fsdp, None)
            return (None, fsdp, tp)
        return (fsdp, tp)
    if name == "w_out":
        if ndim == 3:  # (E, F, D)
            if cfg.n_experts and cfg.n_experts % 16 == 0:
                return (tp, None, fsdp)
            return (None, tp, fsdp)
        return (tp, fsdp)
    if name == "router":
        return (fsdp, None)
    # mamba
    if name == "in_proj":
        return (fsdp, tp)
    if name == "out_proj":
        return (tp, fsdp)
    if name == "conv_w":
        return (None, tp)
    # rwkv
    if name in ("Wr", "Wk", "Wv", "Wg", "Wck", "Wcr"):
        return (fsdp, tp)
    if name in ("Wo", "Wcv"):
        return (tp, fsdp)
    if name == "w_A":
        return (fsdp, None)
    if name == "w_B":
        return (None, fsdp)
    if name == "u":
        return (None, None)
    # everything else (norms, biases, scalars, small vectors): replicate
    return (None,) * ndim


def param_specs(params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: ArchConfig, *,
                scheme: str = "fsdp_tp") -> Plan:
    """The plan of every parameter of ``params`` (a model, or its
    ``named_parameters()`` as a mapping; a ``device="meta"`` model costs
    nothing)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    return {name: _spec_for_leaf(name.rsplit(".", 1)[-1], p.ndim, cfg, scheme)
            for name, p in named.items()}


@functools.lru_cache(maxsize=None)
def meta_params(cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """``cfg``'s parameters by name on ``meta`` (shapes, nothing
    allocated), built once a configuration (a MoE model's experts are
    drawn one at a time, seconds at full depth even on ``meta``)."""
    return dict(lm.init_params(cfg, device="meta").named_parameters())


def plan_for(cfg: ArchConfig, scheme: str = "fsdp_tp") -> Plan:
    """:func:`param_specs` of ``cfg``'s model (built on ``meta``)."""
    return param_specs(meta_params(cfg), cfg, scheme=scheme)


def opt_state_specs(opt_state: Mapping[str, Any], plan: Plan) -> dict:
    """An optimizer state's plan (:mod:`repro_torch.optim`): the moments
    ``m``, ``v`` (AdamW) and ``mu`` (SGD momentum) mirror the parameters'
    specs; the step and anything else is replicated."""
    def replicated(t):
        return (None,) * t.ndim

    out = {}
    for key, val in opt_state.items():
        if key in ("m", "v", "mu") and isinstance(val, Mapping):
            out[key] = {n: plan[n] if n in plan else replicated(t) for n, t in val.items()}
        elif isinstance(val, Mapping):
            out[key] = {n: replicated(t) for n, t in val.items()}
        else:
            out[key] = replicated(val)
    return out


def batch_specs(cfg: ArchConfig, batch: Mapping[str, torch.Tensor], *, multi_pod: bool,
                global_batch: int) -> dict:
    """The batch dim over (pod?, data); replicated when the batch is 1."""
    first = _entry(dp_axes(multi_pod)) if global_batch > 1 else None
    return {k: () if t.ndim == 0 else (first,) + (None,) * (t.ndim - 1)
            for k, t in batch.items()}


def cache_specs(cfg: ArchConfig, cache: Any, *, multi_pod: bool, global_batch: int) -> Any:
    """The reference's cache plan over the port's cache tree
    (:func:`repro_torch.models.lm.init_cache`; NamedTuples keep their
    type).  KV caches (B, S, Hkv, hd): batch over dp when the batch is
    above 1, sequence over ``model`` from 8192 slots (over ``data`` and
    ``model`` at batch 1: context parallelism); smaller caches, such as the
    sliding-window rings, replicate but for the batch.  SSM states: batch
    over dp."""
    bspec = _entry(dp_axes(multi_pod)) if global_batch > 1 else None

    def leaf(keys: tuple, t: torch.Tensor) -> Spec:
        nd = t.ndim
        if ("kv" in keys or "cross" in keys) and nd == 4:
            seq = t.shape[1]
            if seq < 8192:
                return (bspec, None, None, None)
            if global_batch == 1:
                seq_axes = tuple(a for a in ("data", "model") if seq % 512 == 0)
                return (None, _entry(seq_axes) if seq_axes else None, None, None)
            return (bspec, "model" if seq % 256 == 0 else None, None, None)
        if nd >= 1:
            return (bspec,) + (None,) * (nd - 1)
        return ()

    def walk(node, keys: tuple):   # keys: the dict keys on the way down
        if isinstance(node, torch.Tensor):
            return leaf(keys, node)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, keys) for v in node))
        if isinstance(node, Mapping):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return type(node)(walk(v, keys) for v in node)

    return walk(cache, ())


# ---------------------------------------------------------------------------
# Execution: one rank's slices
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _piece(entry, coords: Mapping[str, tuple[int, int]]) -> tuple[int, int]:
    """(this rank's piece, pieces) of a dim sharded over ``entry``; an axis
    the mesh lacks counts as size 1."""
    i, n = 0, 1
    for a in _axes(entry):
        ai, an = coords.get(a, (0, 1))
        i, n = i * an + ai, n * an
    return i, n


def mamba_parts(cfg: ArchConfig, name: str) -> Optional[tuple[tuple[int, bool], ...]]:
    """How a Mamba2 leaf's dimension over ``model`` is cut: its components
    in order, each (width, split): ``in_proj``'s z | x | B C | dt (widths
    d_in, d_in, 2N, H), ``conv_w``'s x | B C; None for every other leaf.

    The plan is the reference's, ``(fsdp, tp)`` over ``in_proj``'s columns
    and ``(None, tp)`` over ``conv_w``'s, but the port cannot execute its
    contiguous cut (:func:`local_slice`): the columns concatenate the
    components, so a contiguous 1 / m of them does not give a rank whole
    heads.  A rank holds its heads' slice of each split component and all
    of B and C (one group, which every head reads), so its piece is wider
    than 1 / m: the replicated columns enter its forward through
    ``MeshAxis.copy`` (:mod:`repro_torch.models.ssm`), and the dry run
    counts them (:func:`local_shape`)."""
    leaf = name.rsplit(".", 1)[-1]
    if cfg.block_kind != "mamba2" or leaf not in ("in_proj", "conv_w"):
        return None
    d_in, _, H, N = ssm.mamba_dims(cfg)
    if leaf == "in_proj":
        return ((d_in, True), (d_in, True), (2 * N, False), (H, True))
    return ((d_in, True), (2 * N, False))


def _has_attention(cfg: ArchConfig) -> bool:
    return cfg.block_kind == "attn" or bool(cfg.attn_every)


def attn_heads(cfg: ArchConfig, m: int, i: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """((first query head, count), (first KV head, count)) that model index
    ``i`` of a model axis of ``m`` holds of ``cfg``'s attention; query head
    h reads KV head h // G (G = Hq / Hkv).  The rule Megatron uses:

    * ``Hkv % m == 0``: Hkv / m KV heads a rank, with their G query heads
      each (a contiguous 1 / m of both);
    * ``m % Hkv == 0``: R = m / Hkv consecutive ranks (a *replica group*)
      share KV head i // R, each holding it whole, and split its G query
      heads (contiguous) as ``torch.tensor_split`` splits them, the larger
      pieces first; a rank may hold no query head;
    * else ``ValueError``: the plan cannot give every rank whole heads.
    """
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    if Hkv % m == 0:
        n = Hkv // m
        return (i * n * G, n * G), (i * n, n)
    if m % Hkv == 0:
        R = m // Hkv
        j, r = divmod(i, R)
        base, extra = divmod(G, R)
        return (j * G + r * base + min(r, extra), base + (r < extra)), (j, 1)
    raise ValueError(f"{cfg.name}: {Hkv} KV heads (of {Hq} query heads) and a model axis of "
                     f"{m}: neither divides the other, so no rank holds whole heads")


def kv_replicas(cfg: ArchConfig, m: int) -> int:
    """R: the ranks of a model axis of ``m`` that share each KV head
    (:func:`attn_heads`; 1 where the KV heads divide over the axis or the
    model has no attention)."""
    if not _has_attention(cfg) or cfg.n_kv_heads % m == 0 or m % cfg.n_kv_heads:
        return 1
    return m // cfg.n_kv_heads


class HeadCut(NamedTuple):
    """How an attention leaf's dimension over ``model`` is cut: by head
    (:func:`attn_heads`), ``hd`` columns (``q``, ``k``, ``v``) or rows
    (``o``) a head; ``kv`` for ``k`` and ``v``, whose KV heads a replica
    group holds whole on each of its ranks."""
    cfg: ArchConfig
    kv: bool

    def run(self, m: int, i: int) -> tuple[int, int]:
        """(start, length) of model index ``i``'s run of the dimension."""
        q, kv = attn_heads(self.cfg, m, i)
        start, count = kv if self.kv else q
        hd = self.cfg.resolved_head_dim
        return start * hd, count * hd


def model_parts(cfg: ArchConfig, name: str):
    """How a leaf's dimension over ``model`` is cut where a contiguous 1 / m
    would not give a rank whole heads: :func:`mamba_parts` for a Mamba2
    leaf, a :class:`HeadCut` for an attention projection (``q``, ``k``,
    ``v``, ``o``: whisper's cross attention and zamba2's shared block too);
    None for every other leaf.  :func:`local_slice`, :func:`place_slice`,
    :func:`local_shape` and :func:`piece_writers` take it as ``parts``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("q", "k", "v", "o"):
        return HeadCut(cfg, leaf in ("k", "v"))
    return mamba_parts(cfg, name)


def _ranges(d: int, entry, coords: Mapping[str, tuple[int, int]], parts
            ) -> list[tuple[int, int]]:
    """(start, length) of each run of a dimension of ``d`` that the rank
    holds: one contiguous 1 / n run, with a :class:`HeadCut` (the dimension
    over ``model``) its heads' run, or with :func:`mamba_parts` its run of
    each split part and the whole of the others."""
    i, n = _piece(entry, coords)
    if n == 1:
        return [(0, d)]
    if parts is None or entry != "model":
        return [(i * (d // n), d // n)]
    if isinstance(parts, HeadCut):
        return [parts.run(n, i)]
    out, at = [], 0
    for width, split in parts:
        out.append((at + i * (width // n), width // n) if split else (at, width))
        at += width
    return out


def local_shape(shape: tuple, spec: Spec, sizes: Mapping[str, int], parts=None,
                model_index: int = 0) -> tuple:
    """The shape of one rank's piece of a ``shape`` leaf on a mesh of
    ``sizes`` ({axis: ranks}); a dim its axes do not divide rounds up, as
    GSPMD pads it; with ``parts`` (:func:`model_parts`) the dimension over
    ``model`` holds the heads of the rank at ``model_index`` (0: a rank
    with the most query heads), or its piece of each split part of a
    Mamba2 leaf and the others whole."""
    def width(d, e):
        n = math.prod(sizes.get(a, 1) for a in _axes(e))
        if parts is None or e != "model" or n == 1:
            return -(-d // n)
        if isinstance(parts, HeadCut):
            try:
                return parts.run(n, model_index)[1]
            except ValueError:   # a plan check_plan refuses: rounded up, as GSPMD pads
                return -(-d // n)
        return sum(-(-w // n) if split else w for w, split in parts)

    return tuple(width(d, e) for d, e in zip(shape, spec))


def local_slice(t: torch.Tensor, spec: Spec, coords: Mapping[str, tuple[int, int]],
                parts=None) -> torch.Tensor:
    """This rank's piece of ``t``: the contiguous piece ``tensor_split``
    gives along each sharded dim (a view), its heads' run with a
    :class:`HeadCut` (a view), or with :func:`mamba_parts` the runs of the
    dimension over ``model`` put together (a copy)."""
    for dim, entry in enumerate(spec):
        runs = _ranges(t.shape[dim], entry, coords, parts)
        if len(runs) == 1:
            t = t.narrow(dim, *runs[0])
        else:
            t = torch.cat([t.narrow(dim, *run) for run in runs], dim)
    return t


def place_slice(full: torch.Tensor, piece: torch.Tensor, spec: Spec,
                coords: Mapping[str, tuple[int, int]], parts=None) -> torch.Tensor:
    """Write a rank's ``piece`` (:func:`local_slice`) into ``full``, where
    it came from; returns ``full``."""
    views = [(full, piece)]
    for dim, entry in enumerate(spec):
        runs = _ranges(full.shape[dim], entry, coords, parts)
        nxt = []
        for f, p in views:
            at = 0
            for start, length in runs:
                nxt.append((f.narrow(dim, start, length), p.narrow(dim, at, length)))
                at += length
        views = nxt
    for f, p in views:
        f.copy_(p)
    return full


def piece_writers(spec: Spec, coords: list, parts=None) -> list[int]:
    """The ranks whose pieces of a leaf laid out by ``spec`` put the whole
    leaf together once (``coords[r]``: rank r's ``{axis: (index, size)}``):
    those at index 0 of every axis ``spec`` does not split over, so a leaf
    replicated over ``pod`` or ``data`` is taken from index 0 of those
    axes, and a KV head a replica group shares (``parts`` a
    :class:`HeadCut`) from the group's first rank.  Each piece is one such
    rank's; a Mamba2 leaf's replicated columns (:func:`mamba_parts`) come
    from each of its model ranks, each a copy of the same values."""
    used = {a for e in spec for a in _axes(e)}

    def first(c):
        if not all(i == 0 for a, (i, _) in c.items() if a not in used):
            return False
        if isinstance(parts, HeadCut) and parts.kv and "model" in used:
            i, m = c.get("model", (0, 1))
            return i % kv_replicas(parts.cfg, m) == 0
        return True

    return [r for r, c in enumerate(coords) if first(c)]


def head_counts(cfg: ArchConfig) -> list[tuple[str, int]]:
    """(what, count) of each kind of head ``cfg``'s blocks split over the
    model axis: attention's query and KV heads (every family with
    attention), Mamba2's and RWKV6's heads."""
    out = []
    if _has_attention(cfg):
        out += [("query heads", cfg.n_heads), ("KV heads", cfg.n_kv_heads)]
    if cfg.block_kind == "mamba2":
        out.append(("Mamba heads", ssm.mamba_dims(cfg)[2]))
    if cfg.block_kind == "rwkv6":
        out.append(("WKV heads", ssm.rwkv_dims(cfg)[0]))
    return out


def check_heads(cfg: ArchConfig, m: int) -> None:
    """Refuse, with the reason, heads a model axis of ``m`` cannot give
    every rank whole: attention's where :func:`attn_heads` cannot, Mamba2's
    and RWKV6's where they do not divide over the axis."""
    if _has_attention(cfg):
        attn_heads(cfg, m, 0)
    for what, n in head_counts(cfg):
        if what not in ("query heads", "KV heads") and n % m:
            raise ValueError(f"{cfg.name}: {n} {what} do not divide over a model axis of {m}")


def check_plan(cfg: ArchConfig, plan: Plan, sizes: Mapping[str, int]) -> bool:
    """Refuse, with the reason, a plan the port cannot execute on a mesh of
    ``sizes`` ({axis: ranks}); return whether it shards over ``model``.

    Refused: names or ranks that are not ``cfg``'s parameters'; ``model``
    entries other than ``tp_only``'s layout; a weight dimension over
    several axes, or over ``pod``, or two over ``data``; heads the model
    axis cannot give every rank whole (:func:`check_heads`); and any
    sharded dimension the
    axes' size does not divide (experts or their F, ``vocab_padded``, an
    FSDP dimension, each split part of a Mamba2 leaf's, ...)."""
    named = meta_params(cfg)
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    if set(plan) != set(shapes):
        raise ValueError(f"plan names vs {cfg.name}'s parameters differ: "
                         f"{sorted(set(plan) ^ set(shapes))[:4]} ...")

    def count(entry):
        return math.prod(sizes.get(a, 1) for a in _axes(entry))

    for name, spec in plan.items():
        if len(spec) != len(shapes[name]):
            raise ValueError(f"{name}: spec {spec} for a {len(shapes[name])}-dim parameter")
        split = [e for e in spec if count(e) > 1]
        if any(len(_axes(e)) > 1 or "pod" in _axes(e) for e in split):
            raise ValueError(f"{name}: {spec} splits a dimension over several axes or over "
                             "pod; a weight's dimension goes over model or data alone")
        if sum("data" in _axes(e) for e in split) > 1:
            raise ValueError(f"{name}: {spec} splits two dimensions over data")
    m = sizes.get("model", 1)
    over_model = m > 1 and any(count(e) > 1 for s in plan.values() for e in s if e == "model")
    if over_model:
        want = param_specs(named, cfg, scheme="tp_only")
        for name, spec in plan.items():
            got = tuple(e if e == "model" else None for e in spec)
            if got != want[name]:
                raise ValueError(f"{name}: {spec} is not the tp_only layout {want[name]} "
                                 "over model that the sharded apply functions run")
        check_heads(cfg, m)
    for name, spec in plan.items():
        parts = model_parts(cfg, name)
        for dim, (d, entry) in enumerate(zip(shapes[name], spec)):
            n = count(entry)
            if isinstance(parts, HeadCut) and entry == "model":
                continue   # cut by head (attn_heads)
            widths = ([w for w, split in parts if split] if parts and entry == "model"
                      else [d])
            if any(w % n for w in widths):
                raise ValueError(f"{name}: dim {dim} ({d}) of {shapes[name]} does not divide "
                                 f"over {entry} ({n} ranks)")
    return over_model


class ShardLayout:
    """One rank's part of a checked plan: its coordinates on the mesh, the
    model axis its slices are spread over (None when no weight is), the
    axes the batch's rows split over, the data axis its FSDP pieces are
    gathered over (None without FSDP), and the replica group that shares
    its KV head (None where no KV head is shared, :func:`kv_replicas`)."""

    def __init__(self, cfg: ArchConfig, plan: Plan, coords: Mapping[str, tuple[int, int]],
                 model_axis: Optional[MeshAxis], row_axes: tuple = (),
                 data_axis: Optional[MeshAxis] = None, kv_axis: Optional[MeshAxis] = None):
        self.cfg, self.plan, self.coords, self.model_axis = cfg, plan, coords, model_axis
        self.row_axes, self.data_axis, self.kv_axis = tuple(row_axes), data_axis, kv_axis
        # parameter name -> the dimension held as the rank's piece over data
        self.fsdp_dims = {} if data_axis is None else {
            name: spec.index("data") for name, spec in plan.items() if "data" in spec}

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole parameter ``name`` (a view, or a
        copy for a Mamba2 leaf cut by :func:`mamba_parts`)."""
        return local_slice(t, self.plan[name], self.coords, model_parts(self.cfg, name))

    def keep(self, name: str, t: torch.Tensor, expert: Optional[int] = None
             ) -> Optional[torch.Tensor]:
        """:data:`repro_torch.models.layers.Keep`: the rank's slice of a
        weight just drawn, a copy so the draw can be freed; an expert's
        (``expert`` its index) only if the rank holds it."""
        spec = self.plan[name]
        if expert is not None:
            i, n = _piece(spec[0], self.coords)
            per = self.cfg.n_experts // n
            if not i * per <= expert < (i + 1) * per:
                return None
            spec = spec[1:]
        if all(_piece(e, self.coords)[1] == 1 for e in spec):
            return t
        return local_slice(t, spec, self.coords, model_parts(self.cfg, name)).clone()

    def attach(self, model: lm.LM) -> lm.LM:
        """``model`` (the rank's pieces) with the layout's axes set."""
        model.model_axis, model.row_axes = self.model_axis, self.row_axes
        model.kv_axis = self.kv_axis
        model.fsdp = (None if not self.fsdp_dims
                      else Fsdp(self.data_axis, self.fsdp_dims, model))
        return model

    def skeleton(self, dtype: torch.dtype, compute_dtype: Optional[torch.dtype] = None) -> lm.LM:
        """The rank's model on ``meta``: the local shapes, nothing drawn
        (:meth:`attach` it once its tensors are made)."""
        return lm.init_params(self.cfg, dtype=dtype, device="meta", compute_dtype=compute_dtype,
                              keep=self.keep)


# (id of a mesh, R) -> (the mesh, this rank's replica group): each group is
# made once a mesh, however many layouts read it
_REPLICA_GROUPS: dict = {}


def _replica_group(mesh, R: int):
    """This rank's replica group on ``mesh``: the R consecutive ranks of its
    model axis that share its KV head.  Every rank makes every group of the
    mesh (``dist.new_group``), in the same order; a mesh with no process
    group (the dry run's ``CountingMesh``) has none."""
    grid = getattr(mesh, "mesh", None)
    if grid is None:
        return None
    key = (id(mesh), R)
    if key not in _REPLICA_GROUPS:
        import torch.distributed as dist

        me, mine = dist.get_rank(), None
        for row in grid.reshape(-1, grid.shape[-1]).tolist():   # each model axis
            for j in range(0, len(row), R):
                group = dist.new_group(row[j:j + R])
                if me in row[j:j + R]:
                    mine = group
        _REPLICA_GROUPS[key] = (mesh, mine)
    return _REPLICA_GROUPS[key][1]


def layout(cfg: ArchConfig, plan: Plan, mesh) -> ShardLayout:
    """This rank's :class:`ShardLayout` of ``plan`` on ``mesh`` (a
    ``DeviceMesh`` of :func:`repro_torch.launch.mesh.make_mesh`), after
    :func:`check_plan`."""
    from repro_torch.launch.mesh import axis_coords

    coords = axis_coords(mesh)
    over_model = check_plan(cfg, plan, {a: n for a, (_, n) in coords.items()})

    def axis(name):
        i, n = coords.get(name, (0, 1))
        return MeshAxis(mesh.get_group(name), n, i, name) if n > 1 else None

    pod, data = axis("pod"), axis("data")
    fsdp = data is not None and any("data" in s for s in plan.values())
    kv = None
    if over_model:
        i, m = coords["model"]
        R = kv_replicas(cfg, m)
        if R > 1:
            kv = MeshAxis(_replica_group(mesh, R), R, i % R, "kv_replicas")
    return ShardLayout(cfg, plan, coords, axis("model") if over_model else None,
                       tuple(a for a in (pod, data) if a is not None), data if fsdp else None,
                       kv)


def init_params_sharded(cfg: ArchConfig, plan: Plan, mesh, *, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16, device=None,
                        compute_dtype: Optional[torch.dtype] = None) -> lm.LM:
    """:func:`repro_torch.models.lm.init_params` on one rank: every weight
    drawn as the unsharded init draws it, from the same generator in the
    same order, and only the rank's slice kept (an expert at a time, so no
    rank holds more than one drawn weight beyond its shard); the model is
    the unsharded model's slice, bit for bit."""
    lay = layout(cfg, plan, mesh)
    return lay.attach(lm.init_params(cfg, seed=seed, dtype=dtype, device=device,
                                     compute_dtype=compute_dtype, keep=lay.keep))


@torch.no_grad()
def shard_params(model: lm.LM, plan: Plan, mesh) -> lm.LM:
    """A new model holding this rank's slice of each of ``model``'s
    parameters (copies, on ``model``'s device and in its dtypes)."""
    lay = layout(model.cfg, plan, mesh)
    out = lay.skeleton(model.embed.dtype, model.compute_dtype).to_empty(
        device=model.embed.device)
    src = dict(model.named_parameters())
    for name, p in out.named_parameters():
        p.copy_(lay.local(name, src[name]))
    return lay.attach(out)


def local_batch(cfg: ArchConfig, batch: Mapping[str, torch.Tensor], mesh, *,
                multi_pod: Optional[bool] = None, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch (every leaf's first dim the
    batch), by :func:`batch_specs` (over ``pod`` too where the mesh has
    it): its data group's contiguous rows.  With ``microbatches`` k the
    batch is k microbatches of consecutive rows, as the reference's
    ``make_train_step`` cuts it, and the rank takes its piece of each, in
    order: microbatch i of its rows is its piece of the reference's
    microbatch i (the MoE blocks' Switch loss is a microbatch's)."""
    from repro_torch.launch.mesh import axis_coords

    coords = axis_coords(mesh)
    if multi_pod is None:
        multi_pod = "pod" in coords
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    specs = batch_specs(cfg, batch, multi_pod=multi_pod, global_batch=B)
    for k, spec in specs.items():
        if spec and (B // microbatches) % _piece(spec[0], coords)[1]:
            raise ValueError(f"{k}: batch {B} in {microbatches} microbatches does not split "
                             f"over {spec[0]}")

    def rows(k, t):
        t = t.reshape(microbatches, B // microbatches, *t.shape[1:])
        t = local_slice(t, (None, *specs[k]), coords)
        return t.reshape(-1, *t.shape[2:])

    return {k: rows(k, t) for k, t in batch.items()}
