"""Slot scheduler for the continuous-batching engine (pure host code).

Port of ``repro/serve/scheduler.py`` for the padded, paged, ragged and
speculative engines. The engine owns ``B`` slots (one per decode-batch
row); at the start of each step the scheduler admits queued requests into
free slots. A slot frees the step its request terminates.

Admission order is ``(priority class, submission number)``: every
``latency``-tier request is considered before any ``batch``-tier one, and
within a class the oldest first (the number is assigned once at submit and
kept across preemption, so a requeued request goes back ahead of every
same-class request that arrived after it). ``max_queue`` bounds the queue
(the engine rejects with a reason instead of queueing without bound),
``batch_cap`` caps the batch-tier admissions of one wave (the capacity
ladder's degraded budget; latency-tier requests bypass it), and
:meth:`Scheduler.drop` sheds a queued request straight to finished
(deadline expiry or cancellation before admission).

Policies: ``"fcfs"`` fills every free slot. ``"mod_aware"`` (default) also
caps *concurrently prefilling* slots at the MoD router's ``kb`` when
prompts are ingested through the shared decode step (``prefill="step"``):
such slots compete for the kb routed rows of every decode step, so an
unbounded wave of them would crowd decode traffic out of the routed
capacity. Batched-prefill admissions run off the decode path and are not
capped.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.serve.request import PRIORITY_LATENCY, Request

FREE = "free"
PREFILL = "prefill"  # slot is ingesting prompt tokens through the decode step
GENERATE = "generate"  # slot is sampling new tokens


@dataclasses.dataclass
class Slot:
    """Per-row bookkeeping for one decode-batch slot."""

    idx: int
    state: str = FREE
    req: Optional[Request] = None
    pos: int = 0  # next absolute position to decode at
    prompt_idx: int = 0  # next prompt token to feed (stepped prefill)
    next_token: int = 0  # token to feed at the next engine step
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    first_token_step: int = -1
    routed_sum: float = 0.0
    routed_steps: int = 0
    score: float = float("nan")  # latest MoD ranking score
    score_sum: float = 0.0
    score_steps: int = 0

    @property
    def active(self) -> bool:
        return self.state in (PREFILL, GENERATE)


class Scheduler:
    """Admission queue + policy over a fixed slot array."""

    def __init__(self, n_slots: int, policy: str = "mod_aware",
                 routed_capacity: Optional[int] = None,
                 verify_token_budget: Optional[int] = None,
                 max_queue: Optional[int] = None):
        if policy not in ("fcfs", "mod_aware"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.policy = policy
        self.n_slots = n_slots
        self.routed_capacity = routed_capacity  # kb; None when MoD is off
        # speculative rounds: every active slot spends (speculate+1) verify
        # positions a round; None = uncapped
        self.verify_token_budget = verify_token_budget
        # bounded backpressure: queue depth at which submission rejects
        # (None = unbounded)
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()
        self.submitted = 0
        self.admitted = 0
        self._seq = 0

    def speculative_admission_cap(self, n_active: int, verify_cost: int) -> Optional[int]:
        """How many more slots may admit before a speculative round would
        exceed the verify-token budget. Each active slot spends
        ``verify_cost`` (speculate + 1) positions of the verify pass a round,
        accepted or not, so the budget caps concurrency. None when no budget
        is set."""
        if self.verify_token_budget is None:
            return None
        if verify_cost <= 0:
            raise ValueError(f"verify_cost must be positive, got {verify_cost}")
        return max(0, self.verify_token_budget // verify_cost - n_active)

    @property
    def queue_full(self) -> bool:
        return self.max_queue is not None and len(self.queue) >= self.max_queue

    def submit(self, req: Request) -> None:
        req._seq = self._seq  # type: ignore[attr-defined]
        self._seq += 1
        self.queue.append(req)
        self.submitted += 1

    @staticmethod
    def _plan_key(req: Request) -> Tuple[int, int]:
        """Admission order: latency class first, then FCFS seniority."""
        return (0 if req.priority == PRIORITY_LATENCY else 1, getattr(req, "_seq", 0))

    def plan_admissions(self, slots: List[Slot], stepped_prefill: bool,
                        page_gate: Optional[Callable[[Request], bool]] = None,
                        max_admissions: Optional[int] = None,
                        batch_cap: Optional[int] = None,
                        ) -> List[Tuple[Slot, Request]]:
        """(slot, request) pairs to admit this step, latency class first,
        then oldest first.

        ``page_gate`` is the paged pool's admission check (worst-case pages
        obtainable now). A gated request is *skipped, not a barrier*: it
        keeps its place and seniority while smaller requests behind it may
        admit. ``max_admissions`` caps the wave further (the ragged engine
        budgets admissions by free prefill segments, not free slots).
        ``batch_cap`` caps only the wave's batch-tier admissions (the
        capacity controller's degraded budget); latency-tier requests
        bypass it, and capped batch-tier ones keep their place."""
        free = [s for s in slots if s.state == FREE]
        # a zero routed budget (kb == 0) blocks stepped admission; None
        # (MoD off) disables the cap
        if self.policy == "mod_aware" and stepped_prefill and self.routed_capacity is not None:
            budget = self.routed_capacity - sum(1 for s in slots if s.state == PREFILL)
        else:
            budget = len(free)
        if max_admissions is not None:
            budget = min(budget, max_admissions)
        budget = min(budget, len(free))
        plans: List[Tuple[Slot, Request]] = []
        batch_taken = 0
        for req in sorted(self.queue, key=self._plan_key):
            if len(plans) >= budget:
                break
            batch_tier = req.priority != PRIORITY_LATENCY
            if batch_tier and batch_cap is not None and batch_taken >= batch_cap:
                continue
            if page_gate is None or page_gate(req):
                plans.append((free[len(plans)], req))
                batch_taken += batch_tier
        taken = {id(r) for _, r in plans}
        self.queue = deque(r for r in self.queue if id(r) not in taken)
        self.admitted += len(plans)
        return plans

    def requeue(self, req: Request) -> None:
        """Preemption / aborted admission: the request goes back to the
        queue with its admission unwound, keeping its original ``_seq``:
        admission sorts by (class, ``_seq``), so it re-enters ahead of every
        same-class request that arrived after it (a preempted latency-tier
        request ahead of all queued batch-tier work)."""
        self.queue.appendleft(req)
        # modlint: disable=counter-decrement -- `admitted` is a gauge of
        # currently-admitted requests (the invariant queue + admitted ==
        # submitted depends on it unwinding here), not a lifetime counter
        self.admitted -= 1

    def drop(self, req: Request) -> None:
        """Shed a queued request straight to finished (deadline expiry or
        cancellation before admission: no slot, no prefill). It leaves the
        queue and counts as admitted, because the engine appends its output
        to ``finished`` at once, so the invariants keep balancing. Removal
        is by identity (dataclass ``==`` would compare token arrays)."""
        for i, r in enumerate(self.queue):
            if r is req:
                del self.queue[i]
                break
        else:
            raise ValueError(f"request uid={req.uid} is not queued")
        self.admitted += 1

    def check_invariants(self, slots: List[Slot], finished: int) -> None:
        """Every submitted request is in exactly one place (queue, slot or
        finished, shed requests among the finished); no slot leaks."""
        occupied = sum(1 for s in slots if s.active)
        if len(slots) != self.n_slots:
            raise AssertionError((len(slots), self.n_slots))
        if self.admitted != occupied + finished:
            raise AssertionError((self.admitted, occupied, finished))
        if self.submitted != len(self.queue) + self.admitted:
            raise AssertionError((self.submitted, len(self.queue), self.admitted))
        for s in slots:
            if (s.state == FREE) != (s.req is None):
                raise AssertionError(f"slot {s.idx} state {s.state} holds {s.req}")
