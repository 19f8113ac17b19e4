"""Federation loop: rounds, client sampling, evaluation, history, churn.

Port of ``repro.fl.trainer``.  ``run_federation`` is the single entry point
used by the launcher, tests and the smoke run.  It is model-agnostic: pass
an ``nn.Module`` from ``repro_torch.models.cnn.MODEL_ZOO`` (or any module
run through ``torch.func.functional_call``) and, optionally, an
``init_fn(seed) -> {name: tensor}``.  Training, evaluation, signatures and
the proximity kernel run on ``device`` (default ``"cuda"``).

Randomness: client sampling is the reference's ``np.random.default_rng(seed)``
stream, so the sampled sets equal the reference's round for round; each
round's minibatch indices come from a ``torch.Generator`` on the device
seeded from ``(seed, rnd)``, and initial parameters from ``(seed, 0)``.

Clients may join and leave via the async churn pipeline
(:mod:`repro_torch.fl.churn`): the declarative ``churn`` schedule of
:class:`ChurnEvent`s is a thin adapter that *enqueues* joins/departs on a
:class:`~repro_torch.fl.churn.ChurnQueue` — newcomer signatures are computed
eagerly at enqueue through the strategy's ``churn_signature_fn`` — and the
queue drains between rounds into admission batches sized by the queue's
:class:`~repro_torch.fl.churn.DrainPolicy`.  Strategies that advertise
``supports_churn`` absorb each drained :class:`~repro_torch.fl.churn.ChurnBatch`
through ``handle_churn`` (PACFL folds it into its streaming cluster engine;
global strategies just swap the data and refresh their local-step count).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, float32_math, resolve_device
from repro_torch.fl.churn import ChurnBatch, ChurnQueue, DrainPolicy
from repro_torch.fl.client import Params, StackedClients, derive_seed, stack_clients
from repro_torch.fl.partition import ClientData
from repro_torch.fl.strategies import STRATEGIES, FLConfig, Strategy


@dataclass
class ChurnEvent:
    """Membership change announced before round ``rnd`` runs.

    ``leave`` holds positions into the client list *as it stands when the
    event fires* (after earlier events); ``join`` appends new clients at the
    end, in order.  ``refresh`` pairs ``(pos, new_client)`` — the client at
    ``pos`` stays but its local data shifted, so its signature must be
    recomputed and its membership re-decided (PACFL routes the drained
    refresh batch through the engine's fused ``move``).  A single event may
    do all three — refreshes are enqueued first, then departures, then
    joins, matching the engine's move/depart/admit order.
    """

    rnd: int
    join: list[ClientData] = field(default_factory=list)
    leave: list[int] = field(default_factory=list)
    refresh: list[tuple[int, ClientData]] = field(default_factory=list)


@dataclass
class RoundRecord:
    rnd: int
    mean_acc: float
    std_acc: float
    comm_up_mb: float
    comm_down_mb: float
    seconds: float


@dataclass
class FederationResult:
    strategy: str
    records: list[RoundRecord]
    final_accs: np.ndarray          # (K,) per-client final local test accuracy
    strategy_obj: Strategy

    @property
    def final_mean(self) -> float:
        return float(self.final_accs.mean())

    @property
    def final_std(self) -> float:
        return float(self.final_accs.std())

    def rounds_to_target(self, target: float) -> Optional[int]:
        for r in self.records:
            if r.mean_acc >= target:
                return r.rnd
        return None

    def comm_mb_to_target(self, target: float) -> Optional[float]:
        for r in self.records:
            if r.mean_acc >= target:
                return r.comm_up_mb + r.comm_down_mb
        return None


def apply_churn_batches(
    queue: ChurnQueue,
    strat: Strategy,
    clients: list[ClientData],
    *,
    rnd: int = 0,
    force: bool = True,
) -> tuple[list[ClientData], Optional[StackedClients], list[ChurnBatch]]:
    """Drain ``queue`` and fold each batch into the client list + strategy.

    Clients are re-stacked ONCE for the whole drain — every
    ``handle_churn`` call receives the post-drain data.  Returns the updated
    client list, the post-drain stacked data (``None`` when nothing
    drained), and the applied batches.  Shared by the round loop and tests
    so queue semantics cannot drift.
    """
    batches = queue.drain(force=force)
    # validate the whole drain before mutating anything: position validity
    # depends only on the evolving member count, so a dry run over lengths
    # keeps a bad later batch from leaving the strategy half-churned
    n = len(clients)
    for batch in batches:
        for pos in batch.refresh:
            if not 0 <= pos < n:
                raise IndexError(
                    f"churn round {rnd}: refresh position {pos} out of range"
                )
        for pos in batch.leave:
            if not 0 <= pos < n:
                raise IndexError(
                    f"churn round {rnd}: leave position {pos} out of range"
                )
            n -= 1
        n += len(batch.join)
        if n == 0:
            raise ValueError(f"churn round {rnd} removed every client")
    if not batches:
        return clients, None, batches
    for batch in batches:
        for pos, client in zip(batch.refresh, batch.refresh_clients):
            clients[pos] = client
        _, clients = batch.resolve_leaves(clients)
        clients.extend(batch.join)
    data = stack_clients(clients)
    for batch in batches:
        strat.handle_churn(data, batch)
    return clients, data, batches


def sample_round(rng: np.random.Generator, K: int, sample_frac: float) -> np.ndarray:
    """The round's sorted client positions (the reference's draw)."""
    m = max(1, min(K, int(round(sample_frac * K))))
    return np.sort(rng.choice(K, size=m, replace=False))


def round_generator(seed: int, rnd: int, device: torch.device) -> torch.Generator:
    """The generator of round ``rnd``'s minibatch draws, seeded from
    ``(seed, rnd)``."""
    return torch.Generator(device=device).manual_seed(derive_seed(seed, rnd))


def run_federation(
    strategy_name: str,
    clients: list[ClientData],
    model: torch.nn.Module,
    cfg: FLConfig,
    *,
    init_fn: Optional[Callable[[int], Params]] = None,
    seed: int = 0,
    eval_every: int = 5,
    verbose: bool = False,
    strategy_kwargs: Optional[dict] = None,
    churn: Optional[list[ChurnEvent]] = None,
    drain_policy: Optional[DrainPolicy] = None,
    device: DeviceLike = None,
) -> FederationResult:
    """Run ``cfg.rounds`` rounds of ``strategy_name`` over ``clients``.

    ``init_fn(seed)`` gives initial parameters (default
    ``model.init_params(seed, device)``).  Deterministic for a fixed
    ``(seed, device)``, bitwise on the card as on the CPU: the sampled
    client sets are the reference's exactly (same NumPy stream), so PACFL's
    labels and every strategy's communication bytes equal the reference's,
    and training and evaluation compute in float32 with deterministic
    algorithms, as the reference does (``_device.float32_math``: no TF32 in
    the model's matmuls and convolutions, cuDNN's deterministic algorithms
    only), so two runs of one seed give the same parameters and accuracies.
    """
    dev = resolve_device(device)
    with float32_math():
        if init_fn is None:
            init_fn = lambda s: model.init_params(s, dev)  # noqa: E731
        clients = list(clients)
        data = stack_clients(clients)
        cls = STRATEGIES[strategy_name]
        strat: Strategy = cls(model, init_fn, cfg, device=dev, **(strategy_kwargs or {}))
        strat.setup(derive_seed(seed, 0), data)

        churn = sorted(churn or [], key=lambda e: e.rnd)
        if churn and not strat.supports_churn:
            raise ValueError(
                f"strategy {strategy_name!r} does not support mid-federation churn"
            )
        for ev in churn:
            if not 1 <= ev.rnd <= cfg.rounds:
                raise ValueError(
                    f"churn event rnd={ev.rnd} outside the federation's "
                    f"round range [1, {cfg.rounds}] — it would silently never fire"
                )
        queue = ChurnQueue(
            signature_fn=strat.churn_signature_fn(), policy=drain_policy
        )

        rng = np.random.default_rng(seed)
        records: list[RoundRecord] = []
        t0 = time.time()
        for rnd in range(1, cfg.rounds + 1):
            # the event schedule is a thin adapter over the arrival queue: in a
            # live deployment enqueues happen mid-round, concurrently with
            # training; here they land at the boundary their event names
            for ev in (e for e in churn if e.rnd == rnd):
                queue.enqueue_event(ev)
            clients, new_data, batches = apply_churn_batches(
                queue, strat, clients, rnd=rnd
            )
            if new_data is not None:
                data = new_data
                if verbose:
                    dj = sum(len(b.join) for b in batches)
                    dl = sum(len(b.leave) for b in batches)
                    dr = sum(len(b.refresh) for b in batches)
                    print(
                        f"[{strategy_name}] round {rnd:4d} churn: "
                        f"-{dl} +{dj} ~{dr} in {len(batches)} batch(es) "
                        f"-> K={len(clients)}"
                    )
            sampled = sample_round(rng, data.n_clients, cfg.sample_frac)
            idx = strat.draw_indices(sampled, round_generator(seed, rnd, dev))
            strat.run_round(rnd, sampled, idx)
            if rnd % eval_every == 0 or rnd == cfg.rounds:
                accs = strat.evaluate()
                rec = RoundRecord(
                    rnd, float(accs.mean()), float(accs.std()),
                    strat.comm_up / 1e6, strat.comm_down / 1e6, time.time() - t0,
                )
                records.append(rec)
                if verbose:
                    print(
                        f"[{strategy_name}] round {rnd:4d} acc {rec.mean_acc:.4f} "
                        f"± {rec.std_acc:.4f}  comm {rec.comm_up_mb + rec.comm_down_mb:.1f} MB"
                    )
        final = strat.evaluate()
        return FederationResult(strategy_name, records, final, strat)
