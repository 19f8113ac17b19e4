"""Shared local-SGD warmup plumbing for the model-based families.

Port of ``repro.core.signatures.warmup``.  ``weight_delta`` and
``inference`` both need the same thing: every client runs a short local-SGD
warmup **from a common init** theta_0 on its own data, vmapped across
clients exactly like the FL round loop (``repro_torch.fl.client.make_local_sgd``
over zero-padded stacked tensors).  This module owns the stacking, the
default model, the memoized vmapped update, the warmup's random draws and
the segment runner, so the two families cannot drift.

Randomness.  The reference draws client ``k``'s segment-``s`` minibatches
from ``fold_in(fold_in(key, client_offset + k), s)``.  Here the indices are
an argument, ``(K, segments, steps, batch)``; by default
:func:`warmup_indices` draws client ``k``'s segment ``s`` on the device from
a generator seeded from ``(seed, client_offset + k, s)``, so a client's
draws depend only on the seed, its index and the segment, never on the
chunk it is computed in.  theta_0 is ``init_fn(seed0)`` unless the context
gives it.

``repro_torch.fl.client`` is imported inside function bodies:
``repro_torch.fl`` imports ``repro_torch.core.pacfl`` (and through it this
package) at module import time, so a module-level import would cycle.
"""
from __future__ import annotations

import functools
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.signatures.base import FamilyContext
from repro_torch.core.svd import bucket_samples
from repro_torch.models.cnn import MLP


def stack_payloads(
    payloads: list, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-padded (K, n_bucket, d) / (K, n_bucket) / (K,) train tensors.

    Widths are bucketed (next power of two) as in the reference; zero
    padding is safe because every minibatch index is strictly below the
    client's true count ``n[k]``.
    """
    K = len(payloads)
    if K == 0:
        raise ValueError("need at least one client payload")
    xs = [np.asarray(p.x_train, dtype=np.float32) for p in payloads]
    ys = [np.asarray(p.y_train, dtype=np.int64) for p in payloads]
    d = xs[0].shape[1]
    n = np.array([x.shape[0] for x in xs], dtype=np.int64)
    n_max = bucket_samples(int(n.max()))
    x = np.zeros((K, n_max, d), np.float32)
    y = np.zeros((K, n_max), np.int64)
    for k in range(K):
        x[k, : n[k]] = xs[k]
        y[k, : n[k]] = ys[k]
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.from_numpy(n).to(device))


@functools.lru_cache(maxsize=8)
def default_model(d_in: int, n_classes: int) -> MLP:
    """Small MLP (hidden 64) for core-level callers without a model; one
    module per shape, so the memoized update is reused across calls."""
    return MLP(d_in, n_classes, hidden=(64,))


def resolve_model(
    context: Optional[FamilyContext], payloads: list, device: torch.device
) -> tuple[torch.nn.Module, dict[str, torch.Tensor]]:
    """``(model, theta_0)`` from the context, with the MLP fallback
    (classes = max label + 1, at least 2).  theta_0 is the context's
    ``theta0`` if given, else ``init_fn(seed0)`` (default
    ``model.init_params(seed0, device)``), as float32 tensors on ``device``."""
    ctx = context or FamilyContext()
    model = ctx.model
    if model is None:
        d = int(np.asarray(payloads[0].x_train).shape[1])
        n_classes = int(
            max(int(np.asarray(p.y_train).max(initial=0)) for p in payloads)
        ) + 1
        model = default_model(d, max(n_classes, 2))
    theta0 = ctx.theta0
    if theta0 is None:
        seed0 = ctx.base_seed()
        theta0 = (ctx.init_fn(seed0) if ctx.init_fn is not None
                  else model.init_params(seed0, device))
    theta0 = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in theta0.items()}
    return model, theta0


@functools.lru_cache(maxsize=32)
def _vmapped_update(model, steps, batch_size, lr, momentum):
    """``make_local_sgd`` (vmapped over clients) memoized per (model,
    hyperparameters), so repeated family calls and the churn queue's
    one-client enqueues reuse one update."""
    from repro_torch.fl.client import make_local_sgd

    return make_local_sgd(
        model, steps=steps, batch_size=batch_size, lr=lr, momentum=momentum
    )


def warmup_indices(
    n: torch.Tensor,
    *,
    segments: int,
    steps: int,
    batch_size: int,
    seed: int,
    client_offset: int = 0,
) -> torch.Tensor:
    """``(K, segments, steps, batch_size)`` minibatch indices on ``n``'s
    device; client ``k``'s segment ``s`` is uniform over ``[0, max(n[k],
    1))``, drawn from a generator seeded from ``(seed, client_offset + k,
    s)``."""
    from repro_torch.fl.client import derive_seed, draw_indices

    rows = []
    for k in range(int(n.shape[0])):
        segs = []
        for s in range(segments):
            gen = torch.Generator(device=n.device).manual_seed(
                derive_seed(seed, client_offset + k, s))
            segs.append(draw_indices(n[k : k + 1], (steps, batch_size), gen)[0])
        rows.append(torch.stack(segs))
    return torch.stack(rows)


def chunk_indices(
    context: Optional[FamilyContext], n_payloads: int, lo: int, n: torch.Tensor, *,
    segments: int, steps: int, batch_size: int, seed: int,
) -> torch.Tensor:
    """The warmup indices of payloads ``[lo, lo + len(n))`` of a call over
    ``n_payloads``: rows of the context's ``indices`` when given (checked
    against the call's shape), else :func:`warmup_indices`."""
    given = None if context is None else context.indices
    if given is None:
        return warmup_indices(n, segments=segments, steps=steps,
                              batch_size=batch_size, seed=seed, client_offset=lo)
    want = (n_payloads, segments, steps, batch_size)
    if tuple(given.shape) != want:
        raise ValueError(f"context.indices {tuple(given.shape)} is not {want}")
    idx = torch.as_tensor(given, dtype=torch.long)[lo : lo + int(n.shape[0])]
    return idx.to(n.device)


def warmup_segments(
    payloads: list,
    *,
    model: torch.nn.Module,
    theta0: dict[str, torch.Tensor],
    indices: torch.Tensor,
    steps: int,
    batch_size: int,
    lr: float,
    momentum: float = 0.5,
    device: torch.device,
) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
    """Run ``indices.shape[1]`` sequential local-SGD segments from theta_0.

    Yields ``(segment_index, params)`` after each segment, ``params`` the
    (K, ...) stacked per-client parameter dict.  Every client starts from
    the same theta_0 and segment ``s`` takes its minibatches from
    ``indices[:, s]``; the momentum restarts at zero each segment, as in
    the reference.
    """
    x, y, _ = stack_payloads(payloads, device)
    K = len(payloads)
    params = {k: v.expand((K,) + tuple(v.shape)) for k, v in theta0.items()}
    vupdate = _vmapped_update(model, steps, batch_size, lr, momentum)
    for s in range(int(indices.shape[1])):
        params = vupdate(params, x, y, indices[:, s], params, None)
        yield s, params


def reference_order(names) -> list[str]:
    """Parameter names in the order ``jax.tree.leaves`` visits the
    reference's param tree: dict keys sorted, list entries by index
    (``f1.b`` before ``f1.w``, ``layers.2`` before ``layers.10``)."""
    def key(name: str):
        return tuple((0, int(p)) if p.isdigit() else (1, p) for p in name.split("."))

    return sorted(names, key=key)


def flatten_params(params: dict[str, torch.Tensor]) -> torch.Tensor:
    """(K, n_params) row-stacked flattening of a (K, ...) parameter dict,
    coordinate for coordinate the reference's ``flatten_params``: leaves in
    the reference's order (:func:`reference_order`) and convolution weights
    in its HWIO layout (the port's stacked ``(K, O, I, H, W)`` -> ``(K, H,
    W, I, O)``), so a shared sketch meets the same coordinate in the same
    row in both packages."""
    K = next(iter(params.values())).shape[0]
    parts = []
    for name in reference_order(params):
        v = params[name]
        if v.ndim == 5:
            v = v.permute(0, 3, 4, 2, 1)
        parts.append(v.reshape(K, -1))
    return torch.cat(parts, dim=1)
