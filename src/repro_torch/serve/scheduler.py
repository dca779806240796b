"""Slot scheduler for the continuous-batching engine (pure host code).

Port of ``repro/serve/scheduler.py`` for the padded engine. The engine owns
``B`` slots (one per decode-batch row); at the start of each step the
scheduler admits queued requests into free slots, oldest first (a
monotone submission number breaks ties between equal arrivals). A slot
frees the step its request terminates.

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
from typing import Deque, List, Optional, Tuple

from repro_torch.serve.request import Request

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
    sampler: object = None  # torch.Generator of a sampled request

    @property
    def active(self) -> bool:
        return self.state in (PREFILL, GENERATE)


class Scheduler:
    """Admission queue + policy over a fixed slot array."""

    def __init__(self, n_slots: int, policy: str = "mod_aware",
                 routed_capacity: Optional[int] = None):
        if policy not in ("fcfs", "mod_aware"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.policy = policy
        self.n_slots = n_slots
        self.routed_capacity = routed_capacity  # kb; None when MoD is off
        self.queue: Deque[Request] = deque()
        self.submitted = 0
        self.admitted = 0
        self._seq = 0

    def submit(self, req: Request) -> None:
        req._seq = self._seq  # type: ignore[attr-defined]
        self._seq += 1
        self.queue.append(req)
        self.submitted += 1

    def plan_admissions(self, slots: List[Slot], stepped_prefill: bool
                        ) -> List[Tuple[Slot, Request]]:
        """(slot, request) pairs to admit this step, in FCFS order."""
        free = [s for s in slots if s.state == FREE]
        # a zero routed budget (kb == 0) blocks stepped admission; None
        # (MoD off) disables the cap
        if self.policy == "mod_aware" and stepped_prefill and self.routed_capacity is not None:
            budget = self.routed_capacity - sum(1 for s in slots if s.state == PREFILL)
        else:
            budget = len(free)
        budget = max(0, min(budget, len(free), len(self.queue)))
        order = sorted(self.queue, key=lambda r: r._seq)  # type: ignore[attr-defined]
        plans = list(zip(free[:budget], order[:budget]))
        taken = {id(r) for _, r in plans}
        self.queue = deque(r for r in self.queue if id(r) not in taken)
        self.admitted += len(plans)
        return plans

    def check_invariants(self, slots: List[Slot], finished: int) -> None:
        """Every submitted request is in exactly one place; no slot leaks."""
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
