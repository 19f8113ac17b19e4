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
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator, Optional

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
