"""Checkpointing: tree save / restore with structure and metadata.

Port of ``repro.ckpt``, with its on-disk format: ``arrays.npz`` (one array
per leaf, keyed by the leaf's path in the reference's ``jax.tree_util``
notation, ``['stages'][0]['sub0']['attn']['q']``) and ``meta.json`` with
``step``, ``config`` and ``keys`` (the leaf keys in order).  A tree is
nested dicts, lists and tuples of tensors or arrays; dict keys are taken in
sorted order, as JAX flattens them, so the two packages read each other's
checkpoints.  The reference also writes its tree structure (``treedef``) as
a string; the port writes the same field from its own walk, for reading
only, and never parses it.

A bfloat16 leaf is written as the reference's ``np.savez`` writes a JAX
bfloat16 array: 2-byte ``|V2`` records holding its bits.  ``restore`` gives
those records back, as the reference's does, except where ``like``'s leaf
is a bfloat16 tensor: that leaf comes back as a ``torch.bfloat16`` tensor
with the same bits.

A sharded training state (:mod:`repro_torch.sharding`: one process a
rank, each holding its pieces) is written and read in the same format by
:func:`save_sharded` and :func:`restore_sharded`: the file is the one the
reference's ``save(path, {"params": P, "opt_state": S})`` writes for the
whole ``P`` and ``S``, written by one rank a parameter at a time and read
by each rank a slice at a time (the archive's members mapped), so no
process holds the whole state, and a state saved on one mesh and plan
restores on any other.
"""
from __future__ import annotations

import dataclasses
import json
import math
import struct
import zipfile
from pathlib import Path
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch


def _leaves(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's order: dict keys sorted, sequences in
    index order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:    # NumPy has no bfloat16: its bits as |V2
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _leaf_like(arr: np.ndarray, like):
    """``arr`` as ``like``'s leaf wants it: |V2 records as bfloat16 where
    ``like`` is a bfloat16 tensor, else as stored."""
    if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return arr


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def save(path, tree, *, step: int = 0, config: Optional[dict] = None) -> None:
    """Write ``tree`` (tensors are copied to the host) and its metadata."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = {key: _numpy(leaf) for key, leaf in _leaves(tree)}
    np.savez(path / "arrays.npz", **flat)
    (path / "meta.json").write_text(json.dumps({
        "step": step,
        "config": config or {},
        "treedef": _structure(tree),
        "keys": list(flat),
    }))


def _rebuild(node):
    """Dicts whose keys are exactly "0", "1", ... "n-1" become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _rebuild(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def restore(path, like: Any = None):
    """Returns ``(tree, meta)`` with NumPy leaves.

    With ``like``, the arrays fill its structure (its leaves are read only
    for their paths, and for whether a leaf is a bfloat16 tensor, which
    comes back as one).  Without it, the tree is rebuilt from the key
    paths; where the reference's ``restore`` leaves a list (the LM's
    ``stages``) as a dict keyed ``"0"``, ``"1"``, ... this one gives the
    list back, so :func:`repro_torch.convert.lm_params_from_numpy` takes it
    as it is.
    """
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    data = np.load(path / "arrays.npz")
    if like is not None:
        def fill(node, prefix=""):
            if isinstance(node, dict):
                return {k: fill(node[k], f"{prefix}[{k!r}]") for k in node}
            if isinstance(node, (list, tuple)):
                return type(node)(fill(v, f"{prefix}[{i}]") for i, v in enumerate(node))
            return _leaf_like(data[prefix], node)
        return fill(like), meta
    out: dict = {}
    for key in meta["keys"]:
        parts = [p.strip("'\"") for p in key.replace("]", "").split("[") if p]
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = data[key]
    return _rebuild(out), meta


# ---------------------------------------------------------------------------
# A sharded training state
# ---------------------------------------------------------------------------


WRITER = 0   # the rank that writes a sharded checkpoint


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The dtype of ``dtype``'s records in the archive (bfloat16: |V2)."""
    if dtype == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=dtype).numpy().dtype


class _NpzWriter:
    """``np.savez``'s archive (zip64, stored uncompressed, a ``KEY.npy``
    member a leaf) written a member at a time and a member's bytes a piece
    at a time, so only the piece in hand is held."""

    def __init__(self, path: Path):
        self._zip = zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                                    allowZip64=True)
        self._member = None

    def begin(self, key: str, shape: tuple, dtype: np.dtype) -> None:
        self._member = self._zip.open(key + ".npy", "w", force_zip64=True)
        np.lib.format.write_array_header_1_0(self._member, {
            "descr": np.lib.format.dtype_to_descr(dtype), "fortran_order": False,
            "shape": tuple(shape)})

    def write(self, t: torch.Tensor) -> None:
        """Append ``t``'s bytes (a host tensor, C order) to the member."""
        self._member.write(t.reshape(-1).view(torch.uint8).numpy())

    def end(self) -> None:
        self._member.close()
        self._member = None

    def close(self) -> None:
        try:
            if self._member is not None:
                self._member.close()
        finally:
            self._zip.close()


class _MappedNpz:
    """The members of an ``np.savez`` archive (stored, not compressed),
    each mapped from the file where its ``.npy`` data starts: slicing one
    reads only the pages the slice touches."""

    _LOCAL = struct.Struct("<4s5H3I2H")   # a zip member's local file header

    def __init__(self, path: Path):
        self.path = path
        with zipfile.ZipFile(path) as z:
            self.members = {i.filename[:-len(".npy")]: i for i in z.infolist()
                            if i.filename.endswith(".npy")}

    def __contains__(self, key: str) -> bool:
        return key in self.members

    def header(self, key: str) -> tuple[tuple, np.dtype, bool, int]:
        """(shape, dtype, Fortran order, offset of the data in the file)."""
        info = self.members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self.path}: {key} is compressed; only a stored member maps")
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            head = self._LOCAL.unpack(f.read(self._LOCAL.size))
            if head[0] != b"PK\x03\x04":
                raise ValueError(f"{self.path}: no local header for {key}")
            f.seek(info.header_offset + self._LOCAL.size + head[-2] + head[-1])
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"{self.path}: {key} is a .npy of version {version}")
            return shape, dtype, fortran, f.tell()

    def array(self, key: str) -> np.ndarray:
        """The member as an array mapped copy-on-write (nothing read yet)."""
        shape, dtype, fortran, offset = self.header(key)
        if math.prod(shape) == 0:
            return np.empty(shape, dtype)
        return np.memmap(  # repro-lint: ignore[R3]  # a checkpoint member, read a rank's slice at a time
            self.path, dtype=dtype, mode="c", offset=offset, shape=shape,
            order="F" if fortran else "C")


@dataclasses.dataclass(eq=False)
class _Entry:
    """A leaf of the checkpoint's tree: ``ref`` (a
    :class:`repro_torch.convert.RefLeaf`) of ``source`` (``{name: the
    rank's piece}``), or, without ``ref``, ``source`` itself (a replicated
    scalar such as the optimizer's step)."""
    source: Any
    ref: Any = None


def _state_tree(cfg, named: Mapping, opt_state: Mapping) -> dict:
    from repro_torch.convert import lm_layout, map_layout

    layout = lm_layout(cfg)

    def entries(source):
        return map_layout(lambda ref: _Entry(source, ref), layout)

    return {"opt_state": {k: entries(v) if isinstance(v, Mapping) else _Entry(v)
                          for k, v in opt_state.items()},
            "params": entries(named)}


def _gather(t: torch.Tensor, shape: tuple, spec, parts, coords: list, writers: list,
            host: bool, widest: tuple) -> Optional[torch.Tensor]:
    """The whole of a leaf (``shape``) from each rank's piece ``t``, on
    :data:`WRITER`'s host (None elsewhere): one ``gather`` that every rank
    joins, through the host (``host``: gloo) or the card (NCCL, then one
    copy to the host on the writer), the writer putting the pieces of
    ``writers`` in place (:func:`repro_torch.sharding.place_slice`).  A
    piece narrower than ``widest`` (a rank with fewer query heads than
    another) travels zero-padded to it; ``place_slice`` reads its own
    part.  A leaf whose only writer is :data:`WRITER` takes no
    collective."""
    import torch.distributed as dist

    from repro_torch import sharding

    piece = t.detach()
    if host:
        piece = piece.cpu()
    piece = piece.contiguous()
    mine = dist.get_rank() == WRITER
    if writers == [WRITER]:
        return piece.cpu() if mine else None
    if tuple(piece.shape) != tuple(widest):
        padded = piece.new_zeros(widest)
        padded[tuple(slice(0, n) for n in piece.shape)] = piece
        piece = padded
    bufs = [torch.empty_like(piece) for _ in coords] if mine else None
    dist.gather(piece, bufs, dst=WRITER)
    if not mine:
        return None
    full = torch.empty(shape, dtype=piece.dtype, device=piece.device)
    for r in writers:
        sharding.place_slice(full, bufs[r], spec, coords[r], parts)
    del bufs
    return full.cpu()


def save_sharded(path, model, opt_state: Mapping, plan: dict, mesh, *, step: int,
                 config: Optional[dict] = None) -> None:
    """Write a sharded training state as the reference's ``save(path,
    {"params": P, "opt_state": S}, step=step, config=config)`` writes the
    whole ``P`` (``lm.init_params``'s tree) and ``S`` (its optimizer's
    state: AdamW's ``m`` and ``v`` mirror ``P``, ``step`` an int32 scalar).

    Every rank of ``mesh`` calls it together with its pieces: ``model``
    (laid out by ``plan``, :mod:`repro_torch.sharding`) and ``opt_state``
    (:mod:`repro_torch.optim`'s, keyed like the parameters; a moment may be
    a broadcast view).  Rank :data:`WRITER` writes ``arrays.npz`` and
    ``meta.json`` under ``path`` (which the ranks that restore must see),
    a leaf at a time in the key order of the reference's file, a stacked
    leaf ``(repeats, ...)`` a super-block at a time; each port parameter is
    gathered from the ranks that hold its pieces
    (:func:`repro_torch.sharding.piece_writers`) and written before the
    next one is gathered, so the writer holds about one parameter, never
    the tree.  A stage with no super-block is written ``(0, ...)``; a bfloat16
    parameter as |V2 records.  Returns once the file is complete on every
    rank."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.launch.mesh import rank_coords

    cfg = model.cfg
    coords = rank_coords(mesh)
    if len(coords) != dist.get_world_size():
        raise ValueError(f"a mesh of {len(coords)} ranks in a process group of "
                         f"{dist.get_world_size()}: a checkpoint's ranks are the whole group")
    sizes = {a: n for a, (_, n) in coords[0].items()}
    model_index = coords[dist.get_rank()].get("model", (0, 1))[0]
    sharding.check_plan(cfg, plan, sizes)
    host = dist.get_backend() == "gloo"
    named = dict(model.named_parameters())
    tree = _state_tree(cfg, named, opt_state)
    path = Path(path)
    writer = None
    if dist.get_rank() == WRITER:
        path.mkdir(parents=True, exist_ok=True)
        writer = _NpzWriter(path / "arrays.npz")
    keys = []
    try:
        for key, entry in _leaves(tree):
            keys.append(key)
            ref = entry.ref
            if ref is None:   # a replicated scalar: the writer's own
                if writer is not None:
                    value = torch.as_tensor(entry.source).detach().cpu()
                    writer.begin(key, tuple(value.shape), _np_dtype(value.dtype))
                    writer.write(value.contiguous())
                    writer.end()
                continue
            dtype = (entry.source[ref.names[0]].dtype if ref.names else torch.float32)
            if writer is not None:
                writer.begin(key, ref.ref_shape, _np_dtype(dtype))
            for name in ref.names:
                t, spec = entry.source[name], plan[name]
                parts = sharding.model_parts(cfg, name)
                want = sharding.local_shape(ref.shape, spec, sizes, parts, model_index)
                if tuple(t.shape) != want:
                    raise ValueError(f"{key} ({name}): a piece of {tuple(t.shape)}, the plan "
                                     f"gives {want} of {ref.shape}")
                full = _gather(t, ref.shape, spec, parts, coords,
                               sharding.piece_writers(spec, coords, parts), host,
                               sharding.local_shape(ref.shape, spec, sizes, parts))
                if writer is not None:
                    writer.write(full)
            if writer is not None:
                writer.end()
    finally:
        if writer is not None:
            writer.close()
    if writer is not None:
        (path / "meta.json").write_text(json.dumps({
            "step": step,
            "config": config or {},
            "treedef": _structure(tree),
            "keys": keys,
        }))
    dist.barrier()


class _Member:
    """A stored member of a :class:`_MappedNpz` as a leaf of the
    reference's tree: mapped afresh at each read (``np.asarray`` of it, or
    one index of its first axis) and unmapped once what that read gave is
    dropped, so a rank's resident set holds the mapped pages of the
    parameter in hand, not of every member read so far."""

    def __init__(self, arrays: _MappedNpz, key: str):
        self.arrays, self.key = arrays, key

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.arrays.array(self.key)
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, index) -> np.ndarray:
        return self.arrays.array(self.key)[index]


def _mapped(arrays: _MappedNpz, prefix: str, node, key: str = ""):
    """The layout ``node`` (:func:`repro_torch.convert.lm_layout`) with
    each leaf the archive's member ``prefix + key`` (a :class:`_Member`),
    its shape checked against the leaf's."""
    if isinstance(node, dict):
        return {k: _mapped(arrays, prefix, v, f"{key}[{k!r}]") for k, v in node.items()}
    if isinstance(node, list):
        return [_mapped(arrays, prefix, v, f"{key}[{i}]") for i, v in enumerate(node)]
    if prefix + key not in arrays:
        raise ValueError(f"{arrays.path}: no {prefix}{key}")
    shape = arrays.header(prefix + key)[0]
    if shape != node.ref_shape:
        raise ValueError(f"{arrays.path}: {prefix}{key} is {shape}, the model's "
                         f"{node.ref_shape}")
    return _Member(arrays, prefix + key)


def restore_sharded(path, cfg, plan: dict, mesh, *, device=None,
                    compute_dtype: Optional[torch.dtype] = None):
    """``(model, opt_state, meta)`` of this rank of ``mesh`` from a
    checkpoint of ``{"params", "opt_state"}`` in the reference's format
    (:func:`save_sharded`'s, or the reference's own ``save``): what
    ``convert.lm_shard_from_numpy`` and ``convert.opt_state_shard_from_numpy``
    give from the whole arrays, the layout attached
    (``ShardLayout.attach``).

    The mesh and plan need not be the saving ones.  The archive's members
    are handed to those two as the reference's tree, each mapped while it
    is read (:class:`_Member`), so each rank reads only its slice of each
    parameter (a super-block's, then the rank's piece), never a whole
    leaf.  Weights of two or more dimensions are bfloat16 where the file
    holds |V2 records, else float32, and vectors float32, as
    ``lm.init_params`` stores them; the model computes in
    ``compute_dtype`` (default: its weights' dtype); the moments are
    float32, the step as stored.  ``device=None`` is the card; every rank
    calls it, though it takes no collective."""
    from repro_torch._device import resolve_device
    from repro_torch.convert import lm_layout, lm_shard_from_numpy, opt_state_shard_from_numpy

    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    arrays = _MappedNpz(path / "arrays.npz")
    dev = resolve_device(device)
    layout = lm_layout(cfg)
    dtype = (torch.bfloat16 if arrays.header("['params']['embed']")[1] == np.dtype("V2")
             else torch.float32)
    model = lm_shard_from_numpy(cfg, _mapped(arrays, "['params']", layout), plan, mesh,
                                dtype=dtype, compute_dtype=compute_dtype, device=dev)
    state: dict = {}
    for key in meta["keys"]:
        if key.startswith("['opt_state']"):
            field = key.split("'")[3]      # "['opt_state']['m']['embed']" -> "m"
            prefix = f"['opt_state'][{field!r}]"
            if field not in state:
                state[field] = (_Member(arrays, key) if key == prefix else
                                _mapped(arrays, prefix, layout))
    return model, opt_state_shard_from_numpy(cfg, state, plan, mesh, device=dev), meta
