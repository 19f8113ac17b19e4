"""Minimal functional optimizers over dicts of named tensors.

Port of ``repro.optim``.  The API mirrors the reference's (itself optax's):
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(updates, state)``; ``apply_updates(params, updates)``.  Parameters,
gradients and updates are ``{name: tensor}`` dicts (the names of
``nn.Module.named_parameters``, or any keys); the state holds an int32
``step`` and float32 moments keyed like the parameters.  Not
``torch.optim``: the arithmetic is the reference's, in its order (bias
corrections on ``m`` and ``v`` separately, ``eps`` outside the square root,
the schedule read at ``step + 1``), so an update can be held against the
reference's step by step.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Union

import torch

Tree = Mapping[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[..., tuple[dict, dict]]


def apply_updates(params: Tree, updates: Tree) -> dict[str, torch.Tensor]:
    """``p + u`` for each name, in ``p``'s dtype."""
    return {name: (p + updates[name]).to(p.dtype) for name, p in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float) -> dict[str, torch.Tensor]:
    """``tree`` scaled by ``min(1, max_norm / (global_norm + 1e-9))``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {name: t * scale for name, t in tree.items()}


def _step_zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device(params: Tree):
    return next(iter(params.values())).device if params else None


def _lr(lr: Union[float, Schedule], step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def sgd(lr: Union[float, Schedule], momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with (optional) heavy-ball momentum and decoupled weight decay
    (added to the gradient, as the reference adds it)."""

    def init(params: Tree) -> dict:
        state = {"step": _step_zero(_device(params))}
        if momentum:
            state["mu"] = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return state

    def update(grads: Tree, state: dict, params: Tree = None):
        step = state["step"] + 1
        lr_t = _lr(lr, step)
        if weight_decay and params is not None:
            grads = {n: g + weight_decay * params[n] for n, g in grads.items()}
        if momentum:
            mu = {n: momentum * state["mu"][n] + g.float() for n, g in grads.items()}
            return {n: -lr_t * m for n, m in mu.items()}, {"step": step, "mu": mu}
        return {n: -lr_t * g for n, g in grads.items()}, {"step": step}

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay (``- lr * wd * p``), float32 moments."""

    def init(params: Tree) -> dict:
        return {
            "step": _step_zero(_device(params)),
            "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        }

    def update(grads: Tree, state: dict, params: Tree = None):
        step = state["step"] + 1
        lr_t = _lr(lr, step)
        m = {n: b1 * state["m"][n] + (1 - b1) * g.float() for n, g in grads.items()}
        v = {n: b2 * state["v"][n] + (1 - b2) * torch.square(g.float())
             for n, g in grads.items()}
        t = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        updates = {}
        for n in grads:
            u = -lr_t * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
            if weight_decay and params is not None:
                u = u - lr_t * weight_decay * params[n].float()
            updates[n] = u
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Schedule:
    """Linear warmup over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``min_frac * base_lr`` at ``total``; float32, of the step."""

    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return f
