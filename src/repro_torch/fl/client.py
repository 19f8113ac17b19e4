"""Client-side local training, vmapped across clients.

Port of ``repro.fl.client``.  All clients' data is pre-stacked into
fixed-shape arrays (padding by cycling samples), so one vmapped update
trains every sampled client of a round.  Parameters are ``{name: tensor}``
dicts (stacked ``(m, ...)`` across clients) run through
``torch.func.functional_call``; gradients come from ``torch.func.grad``,
``vmap``ped over the clients.

Minibatch indices are an **argument** of the update: an ``(m, steps, B)``
integer tensor (``(m, steps, 2, B)`` for Per-FedAvg), drawn by
:func:`draw_indices` from an explicit generator on the device, each row
bounded by its client's true sample count ``n_k``.  The reference draws
them with ``jax.random.randint`` inside its update; feeding the port the
reference's draws reproduces the reference's update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from repro_torch.fl.partition import ClientData

Params = dict[str, torch.Tensor]


@dataclass
class StackedClients:
    """Fixed-shape client tensors."""

    x: np.ndarray          # (K, n_max, d)
    y: np.ndarray          # (K, n_max)
    n: np.ndarray          # (K,) true sample counts (aggregation weights)
    x_test: np.ndarray     # (K, t_max, d)
    y_test: np.ndarray     # (K, t_max)
    t: np.ndarray          # (K,) true test counts
    names: list[str]

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]


def stack_clients(clients: list[ClientData]) -> StackedClients:
    K = len(clients)
    n_max = max(c.x_train.shape[0] for c in clients)
    t_max = max(c.x_test.shape[0] for c in clients)
    d = clients[0].x_train.shape[1]
    x = np.zeros((K, n_max, d), np.float32)
    y = np.zeros((K, n_max), np.int64)
    xt = np.zeros((K, t_max, d), np.float32)
    yt = np.zeros((K, t_max), np.int64)
    n = np.zeros((K,), np.int64)
    t = np.zeros((K,), np.int64)
    for k, c in enumerate(clients):
        nk, tk = c.x_train.shape[0], c.x_test.shape[0]
        reps = -(-n_max // nk)
        x[k] = np.tile(c.x_train, (reps, 1))[:n_max]
        y[k] = np.tile(c.y_train, reps)[:n_max]
        reps_t = -(-t_max // tk)
        xt[k] = np.tile(c.x_test, (reps_t, 1))[:t_max]
        yt[k] = np.tile(c.y_test, reps_t)[:t_max]
        n[k], t[k] = nk, tk
    return StackedClients(x, y, n, xt, yt, t, [c.dataset_name for c in clients])


def derive_seed(*entropy: int) -> int:
    """A 63-bit seed from a tuple of non-negative ints (``SeedSequence``):
    the port's stand-in for the reference's ``jax.random.fold_in`` chains."""
    state = np.random.SeedSequence(tuple(int(e) for e in entropy)).generate_state(
        1, np.uint64
    )
    return int(state[0]) >> 1


def draw_indices(
    n: torch.Tensor, shape: tuple[int, ...], generator: torch.Generator
) -> torch.Tensor:
    """``(m, *shape)`` int64 minibatch indices, row ``i`` uniform over
    ``[0, max(n[i], 1))`` (the reference's ``randint(0, max(n, 1))``),
    drawn on ``n``'s device from ``generator``."""
    bound = n.clamp(min=1).to(torch.float64).reshape(-1, *([1] * len(shape)))
    u = torch.rand(
        (n.shape[0], *shape), generator=generator, device=n.device,
        dtype=torch.float64,
    )
    return torch.minimum((u * bound).long(), bound.long() - 1)


def ce_loss(
    model: torch.nn.Module,
    params: Params,
    xb: torch.Tensor,
    yb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross-entropy; with ``mask`` a weighted mean over masked rows
    (used to restrict probes to a client's real, non-cycled samples)."""
    logits = functional_call(model, params, (xb,))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yb[:, None])[:, 0]
    per_example = logz - gold
    if mask is None:
        return per_example.mean()
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _gather_batch(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """Per-client rows ``x[i, idx[i]]``: (m, n_max, d) x (m, B) -> (m, B, d)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx], y[rows, idx]


def make_local_sgd(
    model: torch.nn.Module,
    *,
    steps: int,
    batch_size: int,
    lr: float,
    momentum: float = 0.5,
    prox_mu: float = 0.0,
    use_control_variates: bool = False,
) -> Callable:
    """Build ``local_sgd(params, x, y, idx, anchor, c_diff) -> new_params``
    over ``m`` stacked clients.

    * ``idx``      — ``(m, steps, batch_size)`` minibatch indices.
    * ``anchor``   — global params theta_g (FedProx proximal term); pass
                     params when unused.
    * ``c_diff``   — SCAFFOLD drift correction (c - c_k); ``None`` when
                     unused.
    Returns plain SGD with heavy-ball momentum (paper setup), the
    reference's update step for step.
    """

    def loss_fn(params, anchor, xb, yb):
        l = ce_loss(model, params, xb, yb)
        if prox_mu > 0.0:
            sq = sum(
                torch.sum(torch.square(params[k] - anchor[k])) for k in params
            )
            l = l + 0.5 * prox_mu * sq
        return l

    vgrad = vmap(grad(loss_fn))

    def local_sgd(params, x, y, idx, anchor, c_diff):
        if tuple(idx.shape[1:]) != (steps, batch_size):
            raise ValueError(
                f"idx {tuple(idx.shape)} is not (m, {steps}, {batch_size})"
            )
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        for s in range(steps):
            xb, yb = _gather_batch(x, y, idx[:, s])
            g = vgrad(params, anchor, xb, yb)
            if use_control_variates:
                g = {k: g[k] + c_diff[k] for k in g}
            mu = {k: momentum * mu[k] + g[k] for k in mu}
            params = {k: params[k] - lr * mu[k] for k in params}
        return params

    return local_sgd


def make_perfedavg_local(
    model: torch.nn.Module, *, steps: int, batch_size: int, alpha: float, beta: float
) -> Callable:
    """Per-FedAvg (FO-MAML): theta' = theta - a*g(B1); theta -= b*g(theta', B2).

    ``idx`` is ``(m, steps, 2, batch_size)``: B1 and B2 of each step.
    """
    vgrad = vmap(grad(lambda p, xb, yb: ce_loss(model, p, xb, yb)))

    def local(params, x, y, idx, anchor, c_diff):
        del anchor, c_diff
        if tuple(idx.shape[1:]) != (steps, 2, batch_size):
            raise ValueError(
                f"idx {tuple(idx.shape)} is not (m, {steps}, 2, {batch_size})"
            )
        for s in range(steps):
            g1 = vgrad(params, *_gather_batch(x, y, idx[:, s, 0]))
            inner = {k: params[k] - alpha * g1[k] for k in params}
            g2 = vgrad(inner, *_gather_batch(x, y, idx[:, s, 1]))
            params = {k: params[k] - beta * g2[k] for k in params}
        return params

    return local


# Clients per vmapped evaluation call: bounds the grouped-convolution
# activations of a large federation; the result does not depend on it.
EVAL_CHUNK = 64


def batch_eval(
    model: torch.nn.Module,
    stacked_params: Params,
    xt: torch.Tensor,
    yt: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Per-client top-1 accuracy (float32). stacked_params: (K, ...) dict."""

    def one(params, x, y, tk):
        logits = functional_call(model, params, (x,))
        pred = torch.argmax(logits, dim=-1)
        mask = torch.arange(x.shape[0], device=x.device) < tk
        return ((pred == y) & mask).sum().float() / torch.clamp(tk, min=1)

    veval = vmap(one)
    K = xt.shape[0]
    with torch.no_grad():
        out = [
            veval(
                {k: v[lo : lo + EVAL_CHUNK] for k, v in stacked_params.items()},
                xt[lo : lo + EVAL_CHUNK], yt[lo : lo + EVAL_CHUNK],
                t[lo : lo + EVAL_CHUNK],
            )
            for lo in range(0, K, EVAL_CHUNK)
        ]
    return torch.cat(out)


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """Weighted mean over the leading (client) axis."""
    w = weights / torch.clamp(weights.sum(), min=1e-9)
    return {k: torch.tensordot(w, v, dims=([0], [0])) for k, v in stacked.items()}


def tree_size_bytes(tree: Params) -> int:
    """Bytes of every tensor in ``tree`` (the per-model communication unit;
    strategies add the model's ``meta_bytes``, see ``models/cnn.py``)."""
    return int(sum(v.numel() * v.element_size() for v in tree.values()))
