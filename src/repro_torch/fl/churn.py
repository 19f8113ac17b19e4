"""Async churn pipeline: batched arrival queue + drain-time admission batching.

Port of ``repro.fl.churn`` (signatures are torch tensors; the drain logic
is the reference's, line for line).

The paper's efficiency claim is that membership is decided *outside* the
training loop — a one-shot SVD signature plus server-side principal-angle
clustering.  :class:`ChurnQueue` makes the serving path match the math:
clients may announce joins, departures, and signature *refreshes* (a client
whose local distribution shifted re-uploads) at any time (e.g. while a round
is in flight), newcomer and refreshed signatures are computed **eagerly on
enqueue** (signatures are membership-independent, so the SVD overlaps the
running round), and the queue drains between rounds into :class:`ChurnBatch`
units — departures, admission batches, and exclusive refresh batches (the
fused ``ClusterEngine.move`` input) whose size is picked by a
:class:`DrainPolicy` fitted to the measured cross-block dispatch cost.

Determinism: enqueue order is preserved — a drain applies departures and
joins in exactly the arrival order, only coalescing *adjacent* joins into
admission batches.  Since the cluster engine's labels are a pure function of
the current distance store (oracle-parity property), draining a queue
reproduces the labels of the equivalent synchronous schedule regardless of
how the joins were batched; the parity suite asserts this bitwise.

``repro_torch.fl.trainer`` adapts the declarative :class:`~repro_torch.fl.trainer.
ChurnEvent` schedule into enqueues (the schedule is now a thin adapter) and
drains every round boundary; strategies receive drained batches through
``Strategy.handle_churn``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass
class ChurnBatch:
    """One drained unit: departures applied first, then one admission batch.

    ``leave`` holds **sequential** single-position removals: each position
    indexes the member list as it stands after the previous removal in the
    same batch (and after earlier batches of the same drain) — exactly the
    queue's one-op-at-a-time contract, so two queued leaves at position 0
    remove two different clients.  ``join`` appends new clients at the end,
    in order.  ``signatures`` stacks the eagerly computed (n, p) signatures
    of ``join`` — (B, n, p), or ``None`` when the queue has no signature
    function (global strategies).

    ``refresh`` batches are **exclusive**: a batch carrying refreshes
    carries no leaves or joins (the drain flushes on every kind boundary),
    so the three apply phases never race inside one batch and the
    positions in ``refresh`` unambiguously index the membership as this
    batch is applied.  ``refresh_clients`` holds the replacement payloads
    (same client identity, shifted local data) and ``refresh_signatures``
    their eagerly re-computed (B, n, p) signature stack — the fused
    ``ClusterEngine.move`` input.
    """

    leave: list[int] = field(default_factory=list)
    join: list[Any] = field(default_factory=list)
    signatures: Optional[torch.Tensor] = None
    refresh: list[int] = field(default_factory=list)
    refresh_clients: list[Any] = field(default_factory=list)
    refresh_signatures: Optional[torch.Tensor] = None

    def __bool__(self) -> bool:
        return bool(self.leave or self.join or self.refresh)

    def resolve_leaves(self, order):
        """Apply the sequential-leave contract to ``order`` (any sequence).

        Returns ``(removed, survivors)`` — the elements the batch's leave
        positions pop, one at a time against the shrinking list, and what
        remains.  The single implementation of the contract: the trainer
        resolves clients, PACFL resolves engine stable ids, the parity
        checks resolve both.
        """
        order = list(order)
        return [order.pop(pos) for pos in self.leave], order


@dataclass(frozen=True)
class DrainPolicy:
    """Admission batch size from the cross-block dispatch cost model.

    An admission of B newcomers costs roughly ``c0 + c1 * B``: ``c0`` the
    fixed dispatch cost of the (M, B) cross-block computation (kernel
    launch, host/device sync, script-replay setup) and ``c1`` the marginal
    per-newcomer cost.  The policy picks the smallest B whose amortized
    dispatch overhead ``c0 / (c0 + c1 B)`` is at most ``target_overhead``:

        B* = ceil(c0 (1 - rho) / (c1 rho)),  clamped to [1, max_batch].

    The policy itself is a pure function of ``(c0, c1)`` — deterministic and
    serializable; :meth:`measure` fits the two constants from a seeded
    timing probe against a signature stack.

    Parameters
    ----------
    dispatch_cost_us: fixed admission dispatch cost ``c0``, microseconds.
    per_newcomer_us: marginal per-newcomer cost ``c1``, microseconds.
    target_overhead: max amortized dispatch-overhead fraction ``rho`` in
        (0, 1] (default 0.25 — at most a quarter of admission time spent
        on fixed dispatch).
    max_batch: hard cap on the admission batch size (default 64).
    deadline_s: availability-aware drain slice — when set, a drain only
        consumes the longest *prefix* of the queued operations whose
        modelled apply cost (:meth:`estimated_batch_us` over the batches
        the prefix forms) fits the deadline; the remainder stays queued
        for the next drain.  Bounds how long the write path stalls the
        serving loop per drain (``docs/SERVING.md``'s staleness bound).
        Default ``None`` = unbounded (drain everything).
    priority_departures: when true, a deadline-sliced drain always
        extends through the **last queued departure** (consuming every
        earlier operation too, to preserve arrival order) — a departed
        client must stop being served promptly even under a tight
        deadline, at the price of overshooting it.  Default false.

    Parity guarantee: batch size affects latency only — the engine's
    labels are a pure function of the distance store, so any batching of
    the same arrival order reproduces the synchronous schedule's labels
    bitwise (gated in CI via ``benchmarks/proximity_scale.py --quick``).
    Deadline slicing keeps that guarantee by construction: a drain
    consumes a *prefix* of the arrival order, never reorders, so a
    sequence of deadline-sliced drains applies exactly the operations one
    forced drain would, in the same order.
    """

    dispatch_cost_us: float
    per_newcomer_us: float
    target_overhead: float = 0.25
    max_batch: int = 64
    deadline_s: Optional[float] = None
    priority_departures: bool = False

    def estimated_batch_us(
        self, n_leave: int, n_join: int, n_refresh: int = 0
    ) -> float:
        """Modelled apply cost of one :class:`ChurnBatch` (microseconds).

        Each departure pays the fixed dispatch cost ``c0`` (a depart is a
        store compaction + replay dispatch); the admission, if any, pays
        ``c0 + c1 * n_join`` — the same cost model :meth:`measure` fits.
        A refresh batch is a *fused* depart+admit (one cross-block dispatch,
        one replay), so it is modelled like an admission:
        ``c0 + c1 * n_refresh``.  Deterministic: a pure function of the
        fitted constants.
        """
        c0 = max(self.dispatch_cost_us, 0.0)
        c1 = max(self.per_newcomer_us, 0.0)
        us = n_leave * c0
        if n_join:
            us += c0 + c1 * n_join
        if n_refresh:
            us += c0 + c1 * n_refresh
        return us

    @property
    def batch_size(self) -> int:
        rho = min(max(self.target_overhead, 1e-6), 1.0)
        c0 = max(self.dispatch_cost_us, 0.0)
        c1 = max(self.per_newcomer_us, 1e-9)
        b = int(np.ceil(c0 * (1.0 - rho) / (c1 * rho)))
        return int(np.clip(b, 1, self.max_batch))

    @classmethod
    def measure(
        cls,
        U_stack: torch.Tensor,
        *,
        seed: int = 0,
        reps: int = 3,
        probe_batch: int = 16,
        measure: str = "eq3",
        backend: str = "auto",
        block_size: Optional[int] = None,
        target_overhead: float = 0.25,
        max_batch: int = 64,
    ) -> "DrainPolicy":
        """Fit (c0, c1) by timing the admission blocks at B=1 and B=probe.

        The probe signatures are QR'd Gaussians drawn on ``U_stack``'s
        device from a generator seeded with ``seed`` (deterministic
        workload); each point is a median over ``reps`` timed dispatches
        after one warmup call.  ``proximity_blocks`` returns host arrays,
        so each timed dispatch ends with the device's work done.
        """
        from repro_torch.core.pme import proximity_blocks

        n, p = int(U_stack.shape[1]), int(U_stack.shape[2])
        gen = torch.Generator(device=U_stack.device).manual_seed(int(seed))
        probe = torch.linalg.qr(
            torch.randn((probe_batch, n, p), generator=gen, device=U_stack.device)
        )[0].to(U_stack.dtype)

        def timed(B: int) -> float:
            ts = []
            proximity_blocks(
                U_stack, probe[:B],
                measure=measure, backend=backend, block_size=block_size,
            )  # warmup/compile outside the timed region
            for _ in range(reps):
                t0 = time.perf_counter()
                proximity_blocks(
                    U_stack, probe[:B],
                    measure=measure, backend=backend, block_size=block_size,
                )
                ts.append((time.perf_counter() - t0) * 1e6)
            return sorted(ts)[len(ts) // 2]

        t1 = timed(1)
        tB = timed(probe_batch)
        c1 = max((tB - t1) / max(probe_batch - 1, 1), 1e-3)
        c0 = max(t1 - c1, 0.0)
        return cls(
            dispatch_cost_us=c0,
            per_newcomer_us=c1,
            target_overhead=target_overhead,
            max_batch=max_batch,
        )


@dataclass
class QueueStats:
    """Arrival/drain telemetry."""

    enqueued_joins: int = 0
    enqueued_leaves: int = 0
    enqueued_refreshes: int = 0
    signature_us: float = 0.0     # eager SVD time overlapped with rounds
    drained_batches: int = 0
    drained_joins: int = 0
    drained_leaves: int = 0
    drained_refreshes: int = 0


class ChurnQueue:
    """Arrival queue for joins/departs with drain-time admission batching.

    ``signature_fn`` maps a join payload (a ``ClientData`` in the FL layer,
    any object in core-level use) to its (n, p) signature; it runs at
    enqueue time.  ``policy`` caps admission batches at
    ``policy.batch_size`` — without one, a drain coalesces every adjacent
    join run into a single admission.

    Leave positions are interpreted against the membership as it will stand
    after all earlier queued operations have applied — identical to the
    semantics of a synchronous :class:`~repro_torch.fl.trainer.ChurnEvent`
    schedule, which makes the adapter in the trainer exact.
    """

    def __init__(
        self,
        *,
        signature_fn: Optional[Callable[[Any], torch.Tensor]] = None,
        policy: Optional[DrainPolicy] = None,
    ):
        self.signature_fn = signature_fn
        self.policy = policy
        self._ops: list[tuple[str, Any, Optional[torch.Tensor]]] = []
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._ops)

    @property
    def pending_joins(self) -> int:
        return sum(1 for kind, _, _ in self._ops if kind == "join")

    @property
    def pending_leaves(self) -> int:
        return sum(1 for kind, _, _ in self._ops if kind == "leave")

    @property
    def pending_refreshes(self) -> int:
        return sum(1 for kind, _, _ in self._ops if kind == "refresh")

    # -- enqueue ------------------------------------------------------------

    def enqueue_join(self, client: Any) -> None:
        """Queue a join; the signature is computed now, not at drain."""
        sig = None
        if self.signature_fn is not None:
            t0 = time.perf_counter()
            sig = self.signature_fn(client)
            self.stats.signature_us += (time.perf_counter() - t0) * 1e6
        self._ops.append(("join", client, sig))
        self.stats.enqueued_joins += 1

    def enqueue_leave(self, pos: int) -> None:
        """Queue one departure.  ``pos`` indexes the membership as it will
        stand after all earlier queued operations have applied — each leave
        is a single sequential removal, never a simultaneous set."""
        self._ops.append(("leave", int(pos), None))
        self.stats.enqueued_leaves += 1

    def enqueue_refresh(self, pos: int, client: Any) -> None:
        """Queue a signature refresh: the client at ``pos`` re-uploads with
        shifted local data.  Like a join, the replacement signature is
        computed **now** (the re-SVD overlaps the in-flight round); like a
        leave, ``pos`` indexes the membership as it will stand after all
        earlier queued operations have applied.  A refresh never changes
        the membership size, so positions inside one refresh run are
        mutually independent."""
        sig = None
        if self.signature_fn is not None:
            t0 = time.perf_counter()
            sig = self.signature_fn(client)
            self.stats.signature_us += (time.perf_counter() - t0) * 1e6
        self._ops.append(("refresh", (int(pos), client), sig))
        self.stats.enqueued_refreshes += 1

    def enqueue_event(self, event) -> None:
        """Thin adapter for a :class:`~repro_torch.fl.trainer.ChurnEvent`:
        refreshes enqueue first, then departures, then joins, matching the
        synchronous order.

        An event's ``refresh`` positions index the membership *as the event
        fires*; enqueueing them before the event's leaves (and a refresh
        not changing the size) keeps those indices valid under the queue's
        sequential contract.  Duplicate refresh positions are ambiguous
        (which payload wins?) and raise.

        An event's ``leave`` list is *simultaneous* (all positions index the
        list as the event fires, and duplicates collapse to one removal,
        matching the synchronous trainer's set semantics); the queue's
        contract is sequential, so the deduplicated positions enqueue in
        descending order — removing the highest position first leaves every
        lower position unshifted, which makes the sequential application
        identical to the simultaneous one.
        """
        refresh = list(getattr(event, "refresh", ()) or ())
        seen: set[int] = set()
        for pos, _ in refresh:
            if int(pos) in seen:
                raise ValueError(
                    f"duplicate refresh position {int(pos)} in event"
                )
            seen.add(int(pos))
        for pos, client in refresh:
            self.enqueue_refresh(pos, client)
        for pos in sorted(set(event.leave), reverse=True):
            self.enqueue_leave(pos)
        for client in event.join:
            self.enqueue_join(client)

    # -- drain --------------------------------------------------------------

    def _deadline_prefix(self, deadline_s: float) -> int:
        """Longest prefix of the queued ops whose modelled apply cost fits
        ``deadline_s`` under the policy's cost model.

        Always at least one operation (drains must make progress even
        under an unmeetable deadline).  With ``policy.priority_departures``
        the prefix extends through the last queued departure regardless of
        the budget — including every operation before it, so arrival order
        is never broken.  A prefix slice preserves the queue's bitwise
        label parity by construction: the remainder simply stays queued.
        """
        policy = self.policy
        budget_us = float(deadline_s) * 1e6
        B = policy.batch_size
        c0 = max(policy.dispatch_cost_us, 0.0)
        c1 = max(policy.per_newcomer_us, 0.0)
        spent = 0.0
        jrun = 0  # joins in the current (unflushed) admission batch
        rrun = 0  # refreshes in the current (unflushed) fused-move batch
        limit = 0
        for kind, _, _ in self._ops:
            if kind == "leave":
                cost = c0
                jrun = rrun = 0
            elif kind == "refresh":
                cost = c1 + (c0 if rrun == 0 else 0.0)
                jrun = 0
                rrun += 1
                if rrun == B:
                    rrun = 0
            else:
                cost = c1 + (c0 if jrun == 0 else 0.0)
                rrun = 0
                jrun += 1
                if jrun == B:
                    jrun = 0
            if limit and spent + cost > budget_us:
                break
            spent += cost
            limit += 1
        if policy.priority_departures:
            for i in range(len(self._ops) - 1, limit - 1, -1):
                if self._ops[i][0] == "leave":
                    limit = i + 1
                    break
        return limit

    def drain(
        self, *, force: bool = True, deadline_s: Optional[float] = None
    ) -> list[ChurnBatch]:
        """Pop pending operations as ordered :class:`ChurnBatch` units.

        Arrival order is preserved: departures bound join runs, adjacent
        joins coalesce into admission batches of at most
        ``policy.batch_size``, and adjacent refreshes coalesce into
        **exclusive** fused-move batches of at most ``policy.batch_size``
        (every kind boundary flushes, so no batch mixes refreshes with
        leaves or joins).  With ``force=False`` a trailing join-only
        remainder smaller than the policy batch is *held back* for the next
        drain (throughput mode: admissions amortize the dispatch cost);
        departures and refreshes always drain — a stale signature serves
        wrong assignments for as long as it is held.

        ``deadline_s`` (default: the policy's ``deadline_s``) bounds the
        drain to the longest arrival-order *prefix* whose modelled apply
        cost fits the deadline — see :meth:`_deadline_prefix`; the rest
        stays queued.  Prefix slicing never reorders, so repeated
        deadline-sliced drains reproduce a single forced drain's labels
        bitwise (gated in ``tests/test_churn_queue.py``).
        """
        if deadline_s is None and self.policy is not None:
            deadline_s = self.policy.deadline_s
        if deadline_s is not None and self.policy is not None:
            pending = self._ops[self._deadline_prefix(deadline_s):]
        else:
            pending = []
        ops = self._ops[: len(self._ops) - len(pending)]
        B = self.policy.batch_size if self.policy is not None else None
        batches: list[ChurnBatch] = []
        cur = ChurnBatch()
        sigs: list[torch.Tensor] = []
        rsigs: list[torch.Tensor] = []

        def flush() -> None:
            nonlocal cur, sigs, rsigs
            if cur:
                if sigs:
                    cur.signatures = torch.stack(sigs)
                if rsigs:
                    cur.refresh_signatures = torch.stack(rsigs)
                batches.append(cur)
            cur, sigs, rsigs = ChurnBatch(), [], []

        consumed = 0
        for kind, payload, sig in ops:
            if kind == "leave":
                if cur.join or cur.refresh:
                    flush()
                cur.leave.append(payload)
            elif kind == "refresh":
                if cur.join or cur.leave:
                    flush()
                pos, client = payload
                cur.refresh.append(pos)
                cur.refresh_clients.append(client)
                if sig is not None:
                    rsigs.append(torch.as_tensor(sig).reshape(sig.shape[-2:]))
                if B is not None and len(cur.refresh) == B:
                    flush()
            else:
                if cur.refresh:
                    flush()
                cur.join.append(payload)
                if sig is not None:
                    sigs.append(torch.as_tensor(sig).reshape(sig.shape[-2:]))
                if B is not None and len(cur.join) == B:
                    flush()
            consumed += 1
        # hold back a trailing under-sized join-only remainder only when it
        # is genuinely the queue's tail — a deadline slice's remainder is
        # already staying queued, so the hold-back applies within the slice
        if not force and B is not None and cur.join and not cur.leave:
            if len(cur.join) < B:
                consumed -= len(cur.join)
                cur, sigs = ChurnBatch(), []
        flush()
        self._ops = self._ops[consumed:]  # un-consumed slice tail + remainder
        self.stats.drained_batches += len(batches)
        self.stats.drained_joins += sum(len(b.join) for b in batches)
        self.stats.drained_leaves += sum(len(b.leave) for b in batches)
        self.stats.drained_refreshes += sum(len(b.refresh) for b in batches)
        return batches
