"""Federated strategies: PACFL + every baseline the paper compares against.

Port of ``repro.fl.strategies``.

Global: FedAvg, FedProx, FedNova, SCAFFOLD.
Personalized: SOLO, LG-FedAvg, Per-FedAvg.
Clustered: IFCA (fixed C), CFL (Sattler bipartitioning), PACFL (this paper).

Each strategy implements ``setup``/``run_round``/``eval_params`` over the
stacked-clients representation.  Parameters are ``{name: tensor}`` dicts on
the strategy's device (stacked ``(K, ...)`` for per-client and per-cluster
state).  Communication bytes are tracked per round (``comm_up``/
``comm_down``) for the Table 5/9/10 reproductions, equal to the
reference's.

Randomness: ``setup(seed, data)`` draws initial parameters through
``init_fn(seed')`` with ``seed'`` derived from ``seed``; ``run_round(rnd,
sampled, idx)`` takes the round's minibatch indices from the caller
(:meth:`Strategy.draw_indices` draws them from a generator on the device).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.pacfl import PACFLConfig, cluster_clients, compute_signatures
from repro_torch.core.signatures import FamilyContext, get_family, payloads_from_stacked
from repro_torch.fl.client import (
    Params,
    StackedClients,
    batch_eval,
    ce_loss,
    derive_seed,
    draw_indices,
    make_local_sgd,
    make_perfedavg_local,
    tree_size_bytes,
    weighted_average,
)


@dataclass
class FLConfig:
    rounds: int = 50
    sample_frac: float = 0.1
    local_epochs: int = 5
    batch_size: int = 20
    lr: float = 0.01
    momentum: float = 0.5
    # strategy-specific knobs (paper defaults)
    prox_mu: float = 0.01
    perfed_alpha: float = 1e-2
    perfed_beta: float = 1e-3
    ifca_clusters: int = 2
    cfl_eps1: float = 0.4
    cfl_eps2: float = 1.6
    pacfl: PACFLConfig = field(default_factory=PACFLConfig)
    personalize_steps: int = 25   # eval-time fine-tune for Per-FedAvg

    def local_steps(self, n_avg: int) -> int:
        return max(1, self.local_epochs * max(1, n_avg // self.batch_size))


# Seed of Per-FedAvg's eval-time fine-tune draws (the reference's
# PRNGKey(1234)).
PERSONALIZE_SEED = 1234


def _take(tree: Params, idx) -> Params:
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long)
    return {k: v[idx.to(v.device)] for k, v in tree.items()}


def _broadcast(tree: Params, m: int) -> Params:
    return {k: v.expand((m,) + tuple(v.shape)) for k, v in tree.items()}


def _zeros_like_stack(tree: Params, m: int) -> Params:
    return {k: v.new_zeros((m,) + tuple(v.shape)) for k, v in tree.items()}


def _set_rows(all_: torch.Tensor, idx, upd: torch.Tensor) -> torch.Tensor:
    """``all_.at[idx].set(upd)``: a new tensor with rows ``idx`` replaced."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=all_.device)
    return all_.index_copy(0, idx, upd.to(all_.dtype))


def _keystr(name: str) -> str:
    """A parameter name as the reference's JAX key path prints
    (``layers.1.w`` -> ``['layers'][1]['w']``), for the key-path rules."""
    return "".join(
        f"[{part}]" if part.isdigit() else f"['{part}']" for part in name.split(".")
    )


def bucket_steps(steps: int) -> int:
    """Geometric step buckets for post-churn local-update rebuilds.

    Snaps to {1..4, 6, 8, 12, 16, 24, 32, ...} — powers of two plus
    midpoints — so a drifting mean client size causes O(log steps) distinct
    local-update builds over a federation's lifetime instead of one per
    churn batch, while keeping the step count (and FedNova's tau) within
    ~20% of the exact post-churn value.
    """
    steps = int(steps)
    if steps <= 4:
        return steps
    base = 1 << int(np.floor(np.log2(steps)))
    cands = (base, base + (base >> 1), base << 1)
    return int(min(cands, key=lambda c: abs(c - steps)))


class Strategy:
    """Base: holds vmapped local updates and communication counters."""

    name = "base"
    # Strategies that can absorb clients joining/leaving between rounds set
    # this and (if they hold per-client or per-cluster state) override
    # handle_churn.  The trainer refuses a churn schedule otherwise.
    supports_churn = False

    def __init__(
        self,
        model: torch.nn.Module,
        init_fn: Callable[[int], Params],
        cfg: FLConfig,
        *,
        device: DeviceLike = None,
    ):
        self.model = model
        self.init_fn = init_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.comm_up = 0      # cumulative bytes clients -> server
        self.comm_down = 0    # cumulative bytes server -> clients

    # -- to be provided by subclasses -------------------------------------
    def setup(self, seed: int, data: StackedClients) -> None:
        raise NotImplementedError

    def run_round(self, rnd: int, sampled: np.ndarray, idx: torch.Tensor) -> None:
        """One round over the ``sampled`` client positions; ``idx`` holds
        their minibatch indices (:meth:`draw_indices`)."""
        raise NotImplementedError

    def eval_params(self) -> Params:
        """Stacked per-client params (K, ...) used for local-test evaluation."""
        raise NotImplementedError

    def handle_churn(self, data: StackedClients, batch) -> None:
        """Absorb one drained churn batch (``repro_torch.fl.churn.ChurnBatch``).

        ``data`` is the stacked clients *after the full drain* (the trainer
        restacks once per drain, not per batch); per-batch engine work must
        come from the batch itself — leave positions resolve against the
        strategy's own membership state and newcomer signatures arrive
        precomputed on the batch.  The base implementation swaps the
        stacked data and refreshes the local update for the post-churn
        client sizes — correct for strategies whose state is global
        (FedAvg/FedProx/FedNova/Per-FedAvg).  Strategies with per-client or
        per-cluster state must override (PACFL routes the batch through its
        cluster engine) or leave ``supports_churn`` False.
        """
        if not self.supports_churn:
            raise NotImplementedError(f"{self.name} does not support churn")
        self._set_data(data)
        self._refresh_local(data)

    def churn_signature_fn(self):
        """Eager-signature hook for the async churn queue.

        Returns a callable ``(ClientData) -> (n, p) signature`` the queue
        runs at enqueue time (overlapping the in-flight round), or ``None``
        when the strategy needs no signatures (everyone but PACFL).
        """
        return None

    # -- shared machinery ---------------------------------------------------
    def _init(self, seed: int) -> Params:
        """``init_fn(seed)`` as float32 tensors on the strategy's device."""
        return {
            k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
            for k, v in self.init_fn(int(seed)).items()
        }

    def _init_stack(self, seeds) -> Params:
        trees = [self._init(s) for s in seeds]
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}

    def _set_data(self, data: StackedClients) -> None:
        """Swap the stacked data and its device copies."""
        dev = self.device
        self.data = data
        self._x = torch.as_tensor(data.x, device=dev)
        self._y = torch.as_tensor(data.y, device=dev)
        self._n = torch.as_tensor(data.n, device=dev)
        self._test = tuple(
            torch.as_tensor(a, device=dev) for a in (data.x_test, data.y_test, data.t)
        )

    def _build(self, data: StackedClients, *, prox_mu: float = 0.0, use_cv: bool = False):
        self._prox_mu = prox_mu
        self._use_cv = use_cv
        self._local_cache: dict[int, Callable] = {}
        self._steps_exact = self.cfg.local_steps(int(np.mean(data.n)))
        self._set_steps(self._steps_exact)
        self._set_data(data)
        self._P = None  # model bytes, set after init

    def _make_local(self, steps: int) -> Callable:
        """Local-update factory for a given step count (Per-FedAvg overrides)."""
        return make_local_sgd(
            self.model,
            steps=steps,
            batch_size=self.cfg.batch_size,
            lr=self.cfg.lr,
            momentum=self.cfg.momentum,
            prox_mu=self._prox_mu,
            use_control_variates=self._use_cv,
        )

    def _set_steps(self, steps: int) -> None:
        self._steps = steps
        fn = self._local_cache.get(steps)
        if fn is None:
            fn = self._make_local(steps)
            self._local_cache[steps] = fn
        self._vupdate = fn

    def _refresh_local(self, data: StackedClients) -> None:
        """Rebuild the local update when churn shifts the mean client size:
        ``self._steps`` (and with it FedNova's tau normalization and the
        local-epoch budget) would otherwise stay sized from the *pre-churn*
        mean.  The trigger compares *exact* step counts — churn that leaves
        the mean unchanged is a true no-op — while the rebuilt count is
        bucketed (:func:`bucket_steps`) and the updates memoized per step
        count, as in the reference.
        """
        exact = self.cfg.local_steps(int(np.mean(data.n)))
        if exact != self._steps_exact:
            self._steps_exact = exact
            steps = bucket_steps(exact)
            if steps != self._steps:
                self._set_steps(steps)

    def _index_shape(self) -> tuple[int, ...]:
        """Per-client shape of :meth:`draw_indices`' draws."""
        return (self._steps, self.cfg.batch_size)

    def draw_indices(self, sampled: np.ndarray, generator: torch.Generator) -> torch.Tensor:
        """The round's minibatch indices for the ``sampled`` clients,
        ``(m, steps, B)`` (Per-FedAvg: ``(m, steps, 2, B)``), each row
        bounded by its client's ``n_k``, drawn on the device."""
        n = self._n[torch.as_tensor(np.asarray(sampled), device=self.device)]
        return draw_indices(n, self._index_shape(), generator)

    def _weights(self, sampled) -> torch.Tensor:
        """Aggregation weights: the sampled clients' true sample counts."""
        return torch.as_tensor(self.data.n[sampled], dtype=torch.float32, device=self.device)

    def _model_bytes(self, params: Params) -> int:
        if self._P is None:
            self._P = tree_size_bytes(params) + int(getattr(self.model, "meta_bytes", 0))
        return self._P

    def _run_local(self, stacked_params, sampled, idx, anchors=None, c_diffs=None):
        rows = torch.as_tensor(np.asarray(sampled), device=self.device)
        x, y = self._x[rows], self._y[rows]
        if anchors is None:
            anchors = stacked_params
        return self._vupdate(stacked_params, x, y, idx.to(self.device), anchors, c_diffs)

    def evaluate(self) -> np.ndarray:
        return batch_eval(self.model, self.eval_params(), *self._test).cpu().numpy()


# ===========================================================================
# Global strategies
# ===========================================================================


class FedAvg(Strategy):
    name = "fedavg"
    supports_churn = True   # all state is global: churn just swaps the data

    def setup(self, seed, data):
        self._build(data)
        self.global_params = self._init(seed)

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        P = self._model_bytes(self.global_params)
        stacked = _broadcast(self.global_params, m)
        new = self._run_local(stacked, sampled, idx)
        self.global_params = weighted_average(new, self._weights(sampled))
        self.comm_down += P * m
        self.comm_up += P * m

    def eval_params(self):
        return _broadcast(self.global_params, self.data.n_clients)


class FedProx(FedAvg):
    name = "fedprox"

    def setup(self, seed, data):
        self._build(data, prox_mu=self.cfg.prox_mu)
        self.global_params = self._init(seed)


class FedNova(FedAvg):
    name = "fednova"

    def run_round(self, rnd, sampled, idx):
        # With uniform local steps FedNova == FedAvg up to the tau_eff scale;
        # we implement the normalized-update form explicitly.
        m = len(sampled)
        P = self._model_bytes(self.global_params)
        stacked = _broadcast(self.global_params, m)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        w = w / w.sum()
        tau = torch.full((m,), float(self._steps), device=self.device)
        tau_eff = torch.sum(w * tau)

        def nova(g, ns):
            # d_k = (g - theta_k) / tau_k ; g' = g - tau_eff * sum_k w_k d_k
            d = (g[None] - ns) / tau.reshape((m,) + (1,) * (ns.ndim - 1))
            return g - tau_eff * torch.tensordot(w, d, dims=([0], [0]))

        self.global_params = {
            k: nova(g, new[k]) for k, g in self.global_params.items()
        }
        self.comm_down += P * m
        self.comm_up += P * m


class Scaffold(Strategy):
    name = "scaffold"

    def setup(self, seed, data):
        self._build(data, use_cv=True)
        self.global_params = self._init(seed)
        self.c = {k: torch.zeros_like(v) for k, v in self.global_params.items()}
        self.c_k = _zeros_like_stack(self.global_params, data.n_clients)

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        P = self._model_bytes(self.global_params)
        stacked = _broadcast(self.global_params, m)
        c_k_s = _take(self.c_k, sampled)
        c_diffs = {k: self.c[k][None] - c_k_s[k] for k in self.c}
        new = self._run_local(stacked, sampled, idx, c_diffs=c_diffs)
        # option II control-variate update
        coef = 1.0 / (self._steps * self.cfg.lr)
        new_c_k = {
            k: c_k_s[k] - self.c[k][None] + coef * (self.global_params[k][None] - new[k])
            for k in self.c
        }
        dc = {k: torch.mean(new_c_k[k] - c_k_s[k], dim=0) for k in self.c}
        frac = m / self.data.n_clients
        self.c = {k: self.c[k] + frac * dc[k] for k in self.c}
        self.c_k = {k: _set_rows(self.c_k[k], sampled, new_c_k[k]) for k in self.c_k}
        w = self._weights(sampled)
        self.global_params = weighted_average(new, w)
        self.comm_down += 2 * P * m   # model + server control variate
        self.comm_up += 2 * P * m

    def eval_params(self):
        return _broadcast(self.global_params, self.data.n_clients)


# ===========================================================================
# Personalized strategies
# ===========================================================================


class Solo(Strategy):
    name = "solo"

    def setup(self, seed, data):
        self._build(data)
        self.params = self._init_stack(
            derive_seed(seed, k) for k in range(data.n_clients)
        )

    def run_round(self, rnd, sampled, idx):
        stacked = _take(self.params, sampled)
        new = self._run_local(stacked, sampled, idx)
        self.params = {k: _set_rows(self.params[k], sampled, new[k]) for k in self.params}
        # no communication

    def eval_params(self):
        return self.params


class LGFedAvg(Strategy):
    """LG-FedAvg: local representation layers + global head.

    Param split: parameters whose reference key path contains one of
    ``global_keys`` are aggregated; the rest stay per-client.  Names are
    matched in the reference's key-path form (:func:`_keystr`), so the same
    tensors are global: the MLP's last layer, LeNet-5's ``f3`` and
    ResNet-9's ``fc``.
    """

    name = "lg"

    def __init__(self, model, init_fn, cfg, global_keys=("layers_-1", "f3", "fc"), *,
                 device: DeviceLike = None):
        super().__init__(model, init_fn, cfg, device=device)
        self.global_keys = global_keys

    def _is_global(self, path: str) -> bool:
        return any(g in path for g in self.global_keys)

    def setup(self, seed, data):
        self._build(data)
        self.params = self._init_stack(
            derive_seed(seed, k) for k in range(data.n_clients)
        )
        paths = [_keystr(name) for name in self.params]
        self._paths = paths
        # auto-detect the classifier head for list-of-layers models (MLP):
        # the LAST entry of a "layers" list is global, the rest local.
        idxs = [
            int(m.group(1))
            for p in paths
            for m in [re.match(r".*\['layers'\]\[(\d+)\]", p)]
            if m
        ]
        if idxs:
            self.global_keys = tuple(self.global_keys) + (f"['layers'][{max(idxs)}]",)

    def _split_bytes(self) -> int:
        return int(sum(
            v.numel() // v.shape[0] * v.element_size()
            for name, v in self.params.items()
            if self._is_global(_keystr(name))
        ))

    def run_round(self, rnd, sampled, idx):
        stacked = _take(self.params, sampled)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        out = {}
        for name, all_ in self.params.items():
            upd = new[name]
            if self._is_global(_keystr(name)):
                g = weighted_average({name: upd}, w)[name]
                upd = g.expand(upd.shape)
            out[name] = _set_rows(all_, sampled, upd)
        self.params = out
        gb = self._split_bytes()
        self.comm_down += gb * len(sampled)
        self.comm_up += gb * len(sampled)

    def eval_params(self):
        return self.params


class PerFedAvg(Strategy):
    name = "perfedavg"
    supports_churn = True   # global params; personalization happens at eval

    def _make_local(self, steps):
        # the churn-refresh path rebuilds through this factory too, so a
        # post-churn rebuild keeps the FO-MAML update (not plain SGD)
        return make_perfedavg_local(
            self.model,
            steps=steps,
            batch_size=self.cfg.batch_size,
            alpha=self.cfg.perfed_alpha,
            beta=self.cfg.perfed_beta,
        )

    def _index_shape(self):
        return (self._steps, 2, self.cfg.batch_size)

    def setup(self, seed, data):
        self._build(data)
        self.global_params = self._init(seed)
        # personalization fine-tune (eval time)
        self._vpers = make_local_sgd(
            self.model, steps=self.cfg.personalize_steps,
            batch_size=self.cfg.batch_size, lr=self.cfg.perfed_alpha, momentum=0.0,
        )

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        P = self._model_bytes(self.global_params)
        stacked = _broadcast(self.global_params, m)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        self.global_params = weighted_average(new, w)
        self.comm_down += P * m
        self.comm_up += P * m

    def eval_params(self):
        K = self.data.n_clients
        stacked = _broadcast(self.global_params, K)
        # the fine-tune's draws come from a fixed seed, as the reference's key
        gen = torch.Generator(device=self.device).manual_seed(PERSONALIZE_SEED)
        idx = draw_indices(self._n, (self.cfg.personalize_steps, self.cfg.batch_size), gen)
        return self._vpers(stacked, self._x, self._y, idx, stacked, None)


# ===========================================================================
# Clustered strategies
# ===========================================================================


class IFCA(Strategy):
    name = "ifca"
    supports_churn = True
    PROBE = 64   # samples per client used to probe cluster fit

    def handle_churn(self, data, batch):
        # cluster models are global; the per-client assignment cache just
        # resizes (re-derived from losses on the next round / eval anyway)
        super().handle_churn(data, batch)
        self.assign = np.zeros(data.n_clients, np.int64)

    def setup(self, seed, data):
        self._build(data)
        C = self.cfg.ifca_clusters
        self.cluster_params = self._init_stack(derive_seed(seed, c) for c in range(C))
        self.assign = np.zeros(data.n_clients, np.int64)

    def _losses(self, x, y, n) -> np.ndarray:
        """(m, C) loss of every cluster model on each client's train data
        head, masked to the n_k real samples: the stacked rows cycle the
        local data, so for n_k < PROBE an unmasked mean double-counts the
        cycled prefix and skews the cluster assignment."""
        xb, yb = x[:, : self.PROBE], y[:, : self.PROBE]
        mask = (
            torch.arange(xb.shape[1], device=xb.device)[None, :] < n[:, None]
        ).float()
        model = self.model

        def one(params, xc, yc, mc):
            return ce_loss(model, params, xc, yc, mask=mc)

        per_cluster = vmap(one, in_dims=(None, 0, 0, 0))
        C = self.cfg.ifca_clusters
        with torch.no_grad():
            ls = torch.stack([
                per_cluster({k: v[c] for k, v in self.cluster_params.items()}, xb, yb, mask)
                for c in range(C)
            ], dim=1)
        return ls.cpu().numpy()

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        C = self.cfg.ifca_clusters
        P = self._model_bytes({k: v[0] for k, v in self.cluster_params.items()})
        rows = torch.as_tensor(np.asarray(sampled), device=self.device)
        ls = self._losses(self._x[rows], self._y[rows], self._n[rows])   # (m, C)
        pick = ls.argmin(axis=1)
        self.assign[sampled] = pick
        stacked = _take(self.cluster_params, pick)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        for c in range(C):
            mask = pick == c
            if not mask.any():
                continue
            sel = np.where(mask)[0]
            avg = weighted_average(_take(new, sel), w[torch.as_tensor(sel, device=self.device)])
            self.cluster_params = {
                k: _set_rows(all_, [c], avg[k][None]) for k, all_ in self.cluster_params.items()
            }
        # every sampled client downloads ALL C cluster models (IFCA's cost)
        self.comm_down += C * P * m
        self.comm_up += P * m

    def eval_params(self):
        # unsampled clients pick their best cluster at eval
        ls = self._losses(self._x, self._y, self._n)
        pick = ls.argmin(axis=1)
        return _take(self.cluster_params, pick)


class CFL(Strategy):
    """Sattler et al. recursive bipartitioning on client-update cosine sim."""

    name = "cfl"

    def setup(self, seed, data):
        self._build(data)
        self.labels = np.zeros(data.n_clients, np.int64)
        self.models: list[Params] = [self._init(seed)]

    @staticmethod
    def _flat(tree: Params) -> np.ndarray:
        return np.concatenate([v.detach().cpu().numpy().ravel() for v in tree.values()])

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        P = self._model_bytes(self.models[0])
        if len(self.models) > 1:
            stacked = {
                k: torch.stack([self.models[self.labels[i]][k] for i in sampled])
                for k in self.models[0]
            }
        else:
            stacked = _broadcast(self.models[0], m)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        # aggregate per cluster + collect update vectors
        updates = {}
        for c in range(len(self.models)):
            mask = self.labels[sampled] == c
            if not mask.any():
                continue
            sel = np.where(mask)[0]
            new_c = _take(new, sel)
            self.models[c] = weighted_average(
                new_c, w[torch.as_tensor(sel, device=self.device)]
            )
            du = [
                self._flat({k: new_c[k][i] - self.models[c][k] for k in new_c})
                for i in range(len(sel))
            ]
            updates[c] = (sampled[sel], np.stack(du))
        # split check (Sattler criteria)
        for c, (cl_ids, du) in list(updates.items()):
            if len(cl_ids) < 4:
                continue
            norms = np.linalg.norm(du, axis=1)
            mean_norm = np.linalg.norm(du.mean(axis=0))
            if mean_norm < self.cfg.cfl_eps1 and norms.max() > self.cfg.cfl_eps2:
                sim = (du @ du.T) / (
                    np.linalg.norm(du, axis=1)[:, None] * np.linalg.norm(du, axis=1)[None] + 1e-9
                )
                i, j = np.unravel_index(np.argmin(sim), sim.shape)
                part = sim[i] >= sim[j]
                new_label = len(self.models)
                self.models.append({k: v.clone() for k, v in self.models[c].items()})
                moved = cl_ids[~part]
                self.labels[moved] = new_label
        self.comm_down += P * m
        self.comm_up += P * m

    def eval_params(self):
        return {
            k: torch.stack([self.models[self.labels[i]][k] for i in range(self.data.n_clients)])
            for k in self.models[0]
        }


class PACFL(Strategy):
    """The paper's method: one-shot principal-angle clustering + per-cluster
    FedAvg (Algorithm 1).

    Membership is owned by the streaming cluster engine, so clients can join
    *and leave* between rounds (``handle_churn``): departures drop out of
    the condensed distance store, newcomers cost only their signature upload
    plus the (M, B) cross block, and surviving clients keep their stable
    cluster ids — cluster models persist across churn.

    Signatures, the proximity kernel and the cluster models live on the
    strategy's device; the engine's clustering state machine on the host.
    Labels equal the reference's bitwise when both see the same client data
    (the engine is the reference's NumPy code; proximity agrees within
    1e-3 degrees).
    """

    name = "pacfl"
    supports_churn = True

    def setup(self, seed, data):
        self._build(data)
        self._seed = int(seed)
        self._sig_seq = 0   # deterministic seed stream for eager signatures
        # One-shot phase: clients compute + upload their signatures through
        # the family selected by cfg.pacfl.family; the proximity matrix goes
        # through cfg.pacfl.proximity_backend (the kernel on the card).
        pcfg = self.cfg.pacfl
        self._family = get_family(pcfg.family)
        payloads = self._family_payloads(data)
        self._fam_ctx = self._family.prepare_context(
            payloads, pcfg,
            FamilyContext(model=self.model, init_fn=self.init_fn, seed0=self._seed),
        )
        U = compute_signatures(
            payloads, pcfg, seed=self._seed, context=self._fam_ctx, device=self.device
        )
        self.clustering = cluster_clients(U, pcfg, device=self.device)
        self.labels = self.clustering.labels
        Z = self.clustering.n_clusters
        # all clusters start from the same theta_g^0 (Algorithm 1 line 12)
        self._theta0 = self._init(self._seed)
        self.cluster_params = _broadcast(self._theta0, Z)
        self.comm_up += self.clustering.signature_bytes
        self.comm_down += self._family.downlink_bytes(
            pcfg, self._fam_ctx, data.n_clients
        )

    @staticmethod
    def _client_mats(data):
        """(features, samples) data matrices, one per stacked client."""
        return [data.x[k, : data.n[k]].T for k in range(data.n_clients)]

    def _family_payloads(self, data):
        """Per-client payloads in the current family's native form: the
        svd family gets the (features, samples) matrices, model-based
        families (x_train, y_train) payloads sliced from the stack."""
        if self.cfg.pacfl.family == "svd":
            return self._client_mats(data)
        return payloads_from_stacked(data)

    def _payload(self, client):
        """One client's payload in the family's form: the (features,
        samples) matrix for svd, the client itself (``x_train``,
        ``y_train``) for the model-based families."""
        return client.x_train.T if self.cfg.pacfl.family == "svd" else client

    def _signatures(self, clients, seed: int) -> torch.Tensor:
        return compute_signatures(
            [self._payload(c) for c in clients], self.cfg.pacfl, seed=seed,
            context=self._fam_ctx, device=self.device,
        )

    def churn_signature_fn(self):
        """Eager per-client signature for the async queue: every family's
        extractor is membership-independent, so it runs at enqueue time and
        overlaps the in-flight round.  Seeds come from a deterministic
        per-strategy stream (exact SVD ignores them; randomized SVD and the
        model-warmup families stay reproducible)."""

        def signature(client) -> torch.Tensor:
            seed = derive_seed(self._seed, 1_000_003 + self._sig_seq)
            self._sig_seq += 1
            return self._family.signature_one(
                self._payload(client), self.cfg.pacfl, seed=seed,
                context=self._fam_ctx, device=self.device,
            )

        return signature

    def handle_churn(self, data, batch):
        """Fold one drained churn batch into the engine (move/depart/admit).

        Mutates ``self.clustering.engine`` in place, tracking the trainer's
        client-list order as a stable-id roster (``self._client_ids``):
        leave positions resolve against it, joins append the engine-assigned
        ids, and refreshes leave it untouched (a fused ``move`` re-orders
        engine rows while the trainer keeps movers in place).  Newcomer and
        refreshed signatures arrive precomputed on the batch; a batch
        without them falls back to computing from the batch's own payloads.
        New clusters get fresh models from theta_g^0; existing clusters keep
        their trained models.  Labels and rosters equal the reference's
        bitwise for the same schedule.
        """
        engine = self.clustering.engine
        roster = getattr(self, "_client_ids", None)
        if roster is None:
            # engine rows == trainer positions until the first move
            roster = [int(i) for i in engine.membership().ids]
        if getattr(batch, "refresh", None):
            ids_mv = np.asarray(
                [roster[p] for p in batch.refresh], dtype=np.int64
            )
            U_ref = getattr(batch, "refresh_signatures", None)
            if U_ref is None:
                U_ref = self._signatures(
                    batch.refresh_clients, derive_seed(self._seed, engine.version)
                )
            engine.move(ids_mv, U_ref)
            extra = self._family.upload_bytes(U_ref)
            self.clustering.signature_bytes += extra
            self.comm_up += extra
        if batch.leave:
            gone, roster = batch.resolve_leaves(roster)
            engine.depart(np.asarray(gone, dtype=np.int64))
        if batch.join:
            U_new = getattr(batch, "signatures", None)
            if U_new is None:
                # compute from the batch's own join payloads — the stacked
                # data reflects the whole drain, so its trailing rows are
                # NOT this batch's newcomers when a drain splits batches
                U_new = self._signatures(
                    batch.join, derive_seed(self._seed, engine.version)
                )
            admitted = engine.admit(U_new)
            roster.extend(int(i) for i in admitted.ids)
            extra = self._family.upload_bytes(U_new)
            self.clustering.signature_bytes += extra
            self.comm_up += extra
        self._client_ids = roster
        # trainer-ordered labels: look stable labels up by client id (engine
        # row order stops matching trainer order after the first move)
        snap = engine.membership()
        label_of = {int(i): l for i, l in zip(snap.ids, snap.labels)}
        self.labels = np.asarray(
            [label_of[i] for i in roster], dtype=snap.labels.dtype
        )
        # grow the per-cluster model stack for any fresh stable ids
        Z_have = next(iter(self.cluster_params.values())).shape[0]
        Z_need = int(self.labels.max()) + 1
        if Z_need > Z_have:
            fresh = _broadcast(self._theta0, Z_need - Z_have)
            self.cluster_params = {
                k: torch.cat([v, fresh[k]], dim=0) for k, v in self.cluster_params.items()
            }
        super().handle_churn(data, batch)   # data swap + local-steps refresh

    def run_round(self, rnd, sampled, idx):
        m = len(sampled)
        P = self._model_bytes({k: v[0] for k, v in self.cluster_params.items()})
        pick = self.labels[sampled]
        stacked = _take(self.cluster_params, pick)
        new = self._run_local(stacked, sampled, idx)
        w = self._weights(sampled)
        params = {k: v.clone() for k, v in self.cluster_params.items()}
        for z in np.unique(pick):
            sel = np.where(pick == z)[0]
            avg = weighted_average(_take(new, sel), w[torch.as_tensor(sel, device=self.device)])
            for k in params:
                params[k][int(z)] = avg[k]
        self.cluster_params = params
        self.comm_down += P * m   # each client downloads only ITS cluster model
        self.comm_up += P * m

    def eval_params(self):
        return _take(self.cluster_params, self.labels)


STRATEGIES: dict[str, type] = {
    s.name: s
    for s in [FedAvg, FedProx, FedNova, Scaffold, Solo, LGFedAvg, PerFedAvg, IFCA, CFL, PACFL]
}
