"""One rank's step on a mesh, run on ``meta`` tensors and counted.

Counterpart of ``repro.launch.hlo_analysis``, which parses the compiled
per-device HLO of a step for its trip-count-aware FLOPs, HBM bytes and
collectives.  The port compiles no XLA module, so :func:`count_step` runs
the step itself: one rank's model, optimizer state, batch and caches are
built on ``meta`` (shapes and dtypes, no data, no card) by the same
:mod:`repro_torch.sharding` calls the launchers make on the card
(``init_params_sharded`` and ``local_batch`` over :class:`CountingMesh`, a
mesh that holds the rank's coordinates and no process group), and the
launchers' step runs on them:

* ``train``: ``lm.make_train_step`` with AdamW (``launch/train.py``'s
  optimizer), gradients and the update included; each super-block's
  checkpoint runs its forward again in the backward, and that is counted
  again, as ``hlo_analysis`` counts the reference's remat;
* ``prefill``: ``lm.make_prefill_step`` under ``torch.inference_mode``;
* ``decode``: one ``lm.make_serve_step`` step at the last position of a
  full cache.

What is counted (:class:`StepCounter`):

* FLOPs, under ``torch.utils.flop_counter.FlopCounterMode`` (its products:
  ``mm``, ``bmm``, ``addmm``, einsums through them), by op and by where
  they run: the innermost function of the port on the Python stack,
  ``(recomputed)`` when a checkpoint runs it in the backward, the autograd
  node's name for the backward's own ops.  Elementwise ops add one flop an
  output element and reductions one an input element, as ``hlo_analysis``
  counts them.  Each hand-written kernel's wrapper takes its ``meta``
  branch (:mod:`repro_torch.kernels._meta`) and reports a launch with the
  FLOPs and bytes of its cost formula; no plain twin runs;
* bytes: every op's operands read and outputs written once, views and
  allocations free.  Like ``hlo_analysis``'s ``bytes`` it is an upper
  bound for a fused program; the port runs eagerly, an op a kernel, so
  for it the count is what each kernel moves, caches aside;
* collectives: every call of the three ``MeshAxis`` methods that reach
  ``torch.distributed`` (:class:`CountingAxis`), in order: kind, axis,
  group size, dtype and bytes (the larger of input and output, as
  ``hlo_analysis`` counts them); the autograd Functions around them run
  unchanged, so the backward's are counted too, and so is the sum of a
  shared KV head's k and v gradients over its replica group (axis
  ``kv_replicas``, ``sharding.kv_replicas`` ranks);
* the peak of live bytes: every storage alive at once, from the
  parameters, optimizer state, batch and caches made before the step to
  every activation, gradient and scratch made in it (a storage's bytes
  from its creation to its last reference's end): the counterpart of XLA's
  ``argument + output + temp`` bytes.  The card's allocator rounds each
  block up and keeps a cuBLAS workspace; neither is counted.

:func:`count_collectives` puts :class:`CountingAxis` in place of a sharded
model's axes on real ranks too: the same record as the ``meta`` rank's, of
collectives that really run.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import time
import weakref
from pathlib import Path
from typing import Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.kernels import _meta
from repro_torch.models import lm
from repro_torch.models.layers import MeshAxis

# the code an op is attributed to: the port's models and optimizer
_ROOT = Path(__file__).resolve().parents[1]
_WHERE = tuple(str(_ROOT / d) for d in ("models", "optim"))
TOP = 12   # entries of top_ops and top_bytes, as the reference's record keeps
_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_unsafe_view", "detach", "lift_fresh", "alias"}


class CountingAxis(MeshAxis):
    """A :class:`MeshAxis` whose collectives are recorded in ``log``, one
    dict a call: ``kind`` (``all-reduce``, ``all-gather`` or
    ``reduce-scatter``), ``axis``, ``group`` (its ranks), ``dtype`` and
    ``bytes``.  On ``meta`` tensors a collective returns a tensor of its
    output's shape and runs nothing; on others it runs over ``group`` as
    :class:`MeshAxis` does."""

    def __init__(self, group, size: int, rank: int, name: Optional[str], log: list):
        super().__init__(group, size, rank, name)
        self.log = log

    def _note(self, kind: str, t: torch.Tensor, nbytes: int) -> None:
        self.log.append({"kind": kind, "axis": self.name, "group": self.size,
                         "dtype": str(t.dtype).replace("torch.", ""), "bytes": nbytes})

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        self._note("all-reduce", t, t.numel() * t.element_size())
        return t if t.is_meta else super().all_reduce_(t)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._note("all-gather", t, t.numel() * t.element_size() * self.size)
        if not t.is_meta:
            return super().all_gather(t, dim)
        t = t.movedim(dim, 0).contiguous()
        return t.new_empty((t.shape[0] * self.size, *t.shape[1:])).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        self._note("reduce-scatter", t, t.numel() * t.element_size())
        if not t.is_meta:
            return super().reduce_scatter(t, dim)
        t = t.movedim(dim, 0).contiguous()
        return t.new_empty((t.shape[0] // self.size, *t.shape[1:])).movedim(0, dim).contiguous()


def count_collectives(model: lm.LM, log: list) -> lm.LM:
    """``model`` (a rank's pieces, :func:`repro_torch.sharding.layout`'s
    axes attached) with each of its mesh axes a :class:`CountingAxis` over
    the same group, recording into ``log``; the FSDP axis stays the data
    axis the rows split over (the one object)."""
    made: dict = {}

    def counting(axis):
        if axis is None:
            return None
        if id(axis) not in made:
            made[id(axis)] = CountingAxis(axis.group, axis.size, axis.rank, axis.name, log)
        return made[id(axis)]

    model.model_axis = counting(model.model_axis)
    model.kv_axis = counting(model.kv_axis)
    model.row_axes = tuple(counting(a) for a in model.row_axes)
    if model.fsdp is not None:
        model.fsdp.axis = counting(model.fsdp.axis)
    return model


class CountingMesh:
    """The part of a ``DeviceMesh`` that :mod:`repro_torch.sharding` reads,
    for one rank and no process group: the axis names (``pod``, ``data``,
    ``model`` as the mesh has them), their sizes and the rank's index on
    each (``launch.mesh.axis_coords``)."""

    def __init__(self, sizes: Mapping[str, int], coords: Optional[Mapping[str, int]] = None):
        self.mesh_dim_names = tuple(a for a in ("pod", "data", "model") if a in sizes)
        self._sizes = dict(sizes)
        self._at = {a: int((coords or {}).get(a, 0)) for a in self.mesh_dim_names}
        for a, i in self._at.items():
            if not 0 <= i < self._sizes[a]:
                raise ValueError(f"rank index {i} on axis {a} of {self._sizes[a]}")

    def size(self, dim: int) -> int:
        return self._sizes[self.mesh_dim_names[dim]]

    def get_local_rank(self, name: str) -> int:
        return self._at[name]

    def get_group(self, name: str):
        return None


def _tensors(tree):
    """The tensors of an op's arguments or outputs (tensors, and lists or
    tuples of them, as ATen passes them)."""
    for a in tree:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (b for b in a if isinstance(b, torch.Tensor))


def _form(a):
    """What of an op's argument its meta outputs depend on: a ``meta``
    tensor's shape, strides and dtype, every other argument's type and
    value; ``TypeError`` for anything else."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise TypeError("not a meta tensor")
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_form(b) for b in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype, torch.device,
                                   torch.memory_format, torch.layout)):
        return (type(a), a)
    raise TypeError(f"no form for {type(a)}")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class StepCounter(TorchDispatchMode):
    """Every op below autograd, counted (module docstring): FLOPs, bytes,
    where they run, and the live bytes of every storage and their peak.
    The products' FLOPs are read with the formulas of the
    ``FlopCounterMode`` the step runs under (:func:`counting`), which
    counts them too, and the kernels' launches come from their meta
    branches (:meth:`launch`)."""

    def __init__(self, registry: Mapping):
        super().__init__()
        self.registry = registry   # op -> its FLOPs from the shapes (FlopCounterMode's)
        self.flops_at: collections.Counter = collections.Counter()   # (op, where) -> flops
        self.bytes_at: collections.Counter = collections.Counter()   # (op, where) -> bytes
        self.matmul_flops = 0.0
        self.elementwise_flops = 0.0
        self.kernel_flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}   # name -> {"launches", "flops", "bytes"}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._held: dict = {}     # id of a live storage -> its bytes
        self._ops: dict = {}      # op -> (name, FLOPs kind, moves bytes, composite, fresh)
        self._made: dict = {}     # (op, its arguments' form) -> its outputs' forms
        self._codes: dict = {}    # code object -> (label, is a backward)

    # -- live bytes

    def hold(self, tree) -> None:
        """Count the storages of every tensor in ``tree`` as live until
        their last reference ends."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._held:
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key)

    # -- attribution

    def where(self) -> str:
        """Where the op runs: the innermost function of the port's models
        or optimizer on the Python stack (a kernel's wrapper counts as its
        caller), with ``(recomputed)`` where a checkpoint runs it again in
        the backward; for the backward's own ops, the autograd node's
        name."""
        node = torch._C._current_autograd_node()
        f = sys._getframe(1)
        while f is not None:
            code = f.f_code
            known = self._codes.get(code)
            if known is None:
                known = None, False
                if code.co_filename.startswith(_WHERE):
                    mod = Path(code.co_filename).relative_to(_ROOT).with_suffix("").parts
                    known = (".".join(p for p in mod if p != "__init__") + "."
                             + code.co_qualname, code.co_name == "backward")
                self._codes[code] = known
            label, backward = known
            if label is not None:
                if node is None or backward:
                    return label
                if code.co_name == "_value_and_grad":   # autograd's own backward
                    break
                return label + " (recomputed)"
            f = f.f_back
        return "?" if node is None else f"backward {node.name()}"

    def launch(self, name: str, flops: float, nbytes: float) -> None:
        """A kernel's meta launch (:func:`repro_torch.kernels._meta.record`)."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.kernel_flops += flops
        self.bytes += nbytes
        at = self.where()
        self.flops_at[(f"kernel {name}", at)] += flops
        self.bytes_at[(f"kernel {name}", at)] += nbytes

    # -- every op

    def _op(self, func) -> tuple:
        info = self._ops.get(func)
        if info is None:
            packet = func._overloadpacket
            kind = ("matmul" if packet in self.registry
                    else "pointwise" if torch.Tag.pointwise in func.tags
                    else "reduction" if torch.Tag.reduction in func.tags else None)
            composite = kind != "matmul" and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
            schema = func._schema
            # new tensors, neither views nor written in place: outputs whose
            # shapes, strides and dtypes its arguments' fix
            fresh = (kind != "matmul" and not func.is_view and not schema.is_mutable
                     and bool(schema.returns)
                     and all(r.alias_info is None and str(r.type) == "Tensor"
                             for r in schema.returns))
            info = (packet.__name__, kind, not func.is_view and packet.__name__ not in _FREE_OPS,
                    composite, fresh and len(schema.returns))
            self._ops[func] = info
        return info

    def _run(self, func, fresh: int, args, kwargs):
        """``func`` on ``meta`` tensors.  An op that makes new tensors runs
        once for each form of its arguments (shapes, strides, dtypes and
        the other arguments); later calls of that form make outputs of the
        shapes, strides and dtypes it gave (no data: the same tensors),
        which skips the meta functions' Python."""
        key = None
        if fresh:
            try:
                key = (func, _form(args), _form(tuple(kwargs.items())))
            except TypeError:   # an argument with no form (a CPU tensor, an object)
                key = None
            if not any(isinstance(t, torch.Tensor) for t in _tensors(args)):
                key = None      # a factory: its device is an argument
            made = self._made.get(key) if key is not None else None
            if made is not None:
                outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                        for shape, stride, dtype in made]
                return outs[0] if fresh == 1 else tuple(outs)
        out = func(*args, **kwargs)
        if key is not None:
            self._made[key] = [(t.shape, t.stride(), t.dtype)
                               for t in (out if fresh > 1 else (out,))]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, kind, moves, composite, fresh = self._op(func)
        if composite:
            # a composite op that reaches the mode whole (inference mode
            # skips autograd's decomposition): counted as its parts, as
            # FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, fresh, args, kwargs)
        self.ops += 1
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        flops = 0.0
        if kind == "matmul":
            flops = float(self.registry[func._overloadpacket](*args, **kwargs, out_val=out))
            self.matmul_flops += flops
        elif kind == "pointwise":
            flops = float(sum(t.numel() for t in outs))
            self.elementwise_flops += flops
        elif kind == "reduction":
            flops = float(sum(t.numel() for t in _tensors(args)))
            self.elementwise_flops += flops
        nbytes = 0
        if moves:
            nbytes = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs.values())) + _nbytes(outs)
            self.bytes += nbytes
        if flops or nbytes:
            at = self.where()
            if flops:
                self.flops_at[(name, at)] += flops
            if nbytes:
                self.bytes_at[(name, at)] += nbytes
        for t in outs:
            self._hold(t)
        return out

    def top(self, what: str, n: int = TOP) -> list:
        """The ``n`` largest (``op @ where``, count) of ``flops`` or ``bytes``."""
        counts = self.flops_at if what == "flops" else self.bytes_at
        return [(f"{op} @ {at}", v) for (op, at), v in counts.most_common(n)]


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``bmm``'s FLOPs, its ``out_dtype`` overload too (``layers.mm_f32``),
    whose third argument FlopCounterMode's own formula does not take."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


@contextlib.contextmanager
def counting(*held):
    """Count what runs inside the block: yields ``(counter, flop_counter)``,
    a :class:`StepCounter` whose live bytes start from the storages of
    ``held`` (trees of tensors), nested in a ``FlopCounterMode``, with the
    kernels' meta launches reported to the counter."""
    flop_counter = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    counter = StepCounter(flop_counter.flop_registry)
    for tree in held:
        counter.hold(tree)
    with flop_counter, counter, _meta.recording(counter.launch):
        yield counter, flop_counter


def _batch(cfg: ArchConfig, shape: InputShape, dtype: torch.dtype) -> dict:
    """The step's global batch on ``meta``: int64 tokens (one a sequence at
    decode), the vision embeddings or encoder frames the model takes in the
    compute dtype (not at decode)."""
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int64, device="meta")}
    out = {"tokens": torch.empty((B, shape.seq_len), dtype=torch.int64, device="meta")}
    if cfg.vision_tokens:
        out["vision_embeds"] = torch.empty((B, cfg.vision_tokens, cfg.d_model), dtype=dtype,
                                           device="meta")
    if cfg.is_enc_dec:
        out["encoder_frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                            device="meta")
    return out


def count_step(cfg: ArchConfig, shape: InputShape, sizes: Mapping[str, int],
               scheme: str = "fsdp_tp", coords: Optional[Mapping[str, int]] = None, *,
               compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """One rank's step of ``shape`` on a mesh of ``sizes`` ({axis: ranks})
    under ``scheme``, run on ``meta`` and counted (module docstring).

    The rank at ``coords`` ({axis: index}, default 0 on every axis) is
    counted; ``sharding.check_plan`` refuses a plan whose axes do not divide
    every sharded dimension, so every rank of an accepted plan holds the
    same shapes but for its attention heads: where a replica group shares
    each KV head (``sharding.attn_heads``), its ranks split the query
    heads, the larger pieces first, so model index 0 holds the most.
    Training keeps float32 masters and computes in
    ``compute_dtype``, serving stores and computes in it (bfloat16: the
    card's policy).  Raises ``ValueError`` or ``NotImplementedError`` where
    ``check_plan`` refuses the plan."""
    t0 = time.perf_counter()
    mesh = CountingMesh(sizes, coords)
    plan = sharding.plan_for(cfg, scheme)
    train = shape.kind == "train"
    params = sharding.init_params_sharded(
        cfg, plan, mesh, dtype=torch.float32 if train else compute_dtype, device="meta",
        compute_dtype=compute_dtype)
    log: list = []
    count_collectives(params, log)
    S = shape.seq_len
    batch = sharding.local_batch(cfg, _batch(cfg, shape, compute_dtype), mesh)
    rows = batch["tokens"].shape[0]
    if train:
        from repro_torch.optim import adamw, cosine_schedule

        opt = adamw(cosine_schedule(3e-4, warmup=10, total=20))
        state = opt.init(dict(params.named_parameters()))
        step = lm.make_train_step(opt)
        with counting(list(params.parameters()), state, batch) as (counter, flop_counter):
            step(params, state, batch)
    elif shape.kind == "prefill":
        step = lm.make_prefill_step(max_len=S)
        with torch.inference_mode(), counting(list(params.parameters()), batch) as (
                counter, flop_counter):
            step(params, batch)
    else:
        cache = lm.init_cache(params, rows, S)
        step = lm.make_serve_step()
        with torch.inference_mode(), counting(list(params.parameters()), cache, batch) as (
                counter, flop_counter):
            step(params, cache, batch["tokens"], S - 1)
    total = flop_counter.get_total_flops()
    if total != counter.matmul_flops:
        raise RuntimeError(f"FlopCounterMode counted {total} flops, the step counter "
                           f"{counter.matmul_flops}")
    collectives: dict = {}
    for c in log:
        key = f"{c['kind']} over {c['axis']}"
        entry = collectives.setdefault(key, {"kind": c["kind"], "axis": c["axis"],
                                             "group": c["group"], "bytes": 0, "count": 0})
        entry["bytes"] += c["bytes"]
        entry["count"] += 1
    return {
        "rank": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names},
        "rows": rows,
        "flops": total + counter.elementwise_flops + counter.kernel_flops,
        "matmul_flops": total, "elementwise_flops": counter.elementwise_flops,
        "kernel_flops": counter.kernel_flops,
        "bytes": counter.bytes,
        "kernels": counter.kernels,
        "collectives": collectives,
        "collective_log": log,
        "peak_bytes": counter.peak,
        "ops": counter.ops,
        "top_ops": counter.top("flops"),
        "top_bytes": counter.top("bytes"),
        "count_s": time.perf_counter() - t0,
    }


def launches(counted: dict) -> dict:
    """{kernel: launches} of a :func:`count_step` record."""
    return {k: v["launches"] for k, v in counted["kernels"].items()}

