"""Fault injection for the serving engine.

Port of ``repro/serve/faults.py``. A :class:`FaultInjector`
(``EngineConfig(fault_injector=...)``) fires a scheduled matrix of faults
at chosen engine steps. The injector only creates adverse conditions;
detection and containment are the engine's and always on. Every fault
ends only the affected request (``FINISH_ERROR`` for detected corruption)
or none at all (page exhaustion and preemption storms unwind through the
engine's own preempt/requeue paths): the engine keeps serving, the pool's
books keep balancing, and every other request's tokens are unchanged.

Kinds:

- ``nan_logits`` / ``inf_logits``: overwrite one active slot's host logits
  row with non-finite values after the step, before sampling. The engine
  fails that request; decode rows couple only through MoD *selection*, so
  a poisoned row never corrupts another row's cache.
- ``page_exhaustion``: hold ``pages`` pages out of the pool's free list for
  ``duration`` steps (``PagedCachePool.hold_pages``), closing the admission
  gate and driving lazy growth into preemption.
- ``slow_step``: sleep ``sleep_s`` before the step (a straggler that
  spikes the p99 signal and, on a wall clock, expires deadlines).
- ``preempt_storm``: preempt every mid-prefill slot (or, when none is
  prefilling, the youngest decoding slot) back to the queue.

``FaultInjector.seeded(seed)`` draws a reproducible matrix over all kinds
with ``np.random.default_rng(seed)``, the draws of the JAX package, so both
packages fire the same matrix from one seed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.scheduler import GENERATE, PREFILL

__all__ = ["KINDS", "Fault", "FaultInjector"]

KINDS = (
    "nan_logits",
    "inf_logits",
    "page_exhaustion",
    "slow_step",
    "preempt_storm",
)


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    kind:     one of :data:`KINDS`.
    step:     fires at the first engine step whose ``step_count`` reaches
              this (a speculative round advances several steps at once).
    slot:     nan/inf target slot; None (or an inactive slot) targets the
              lowest-index decoding slot when it fires.
    pages:    page_exhaustion: pages to hold.
    duration: page_exhaustion: steps to keep them held.
    sleep_s:  slow_step: seconds to stall.
    """

    kind: str
    step: int
    slot: Optional[int] = None
    pages: int = 4
    duration: int = 2
    sleep_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; know {KINDS}")


class FaultInjector:
    """Fires a fault schedule against a live engine and records what fired
    in ``fired``, a list of dicts ``{step, kind, ...}``."""

    def __init__(self, faults=()):
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.step)
        self.fired: List[dict] = []
        self._done: set = set()
        self._release_at: Optional[int] = None

    @classmethod
    def seeded(cls, seed: int, n_faults: int = 6, horizon: int = 48, kinds=KINDS,
               sleep_s: float = 0.0) -> "FaultInjector":
        """A reproducible random matrix: ``n_faults`` faults of random kinds
        spread over the first ``horizon`` engine steps."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(kinds))
            faults.append(Fault(
                kind=kind,
                step=int(rng.integers(1, horizon)),
                slot=None,
                pages=int(rng.integers(2, 8)),
                duration=int(rng.integers(1, 4)),
                sleep_s=sleep_s if kind == "slow_step" else 0.0,
            ))
        return cls(faults)

    # -- engine hooks ----------------------------------------------------

    def _due(self, step_count: int, kinds) -> List[Tuple[int, Fault]]:
        return [(i, f) for i, f in enumerate(self.faults)
                if i not in self._done and f.step <= step_count and f.kind in kinds]

    def on_step_start(self, engine) -> None:
        """Time-domain faults: stalls, page holds (and their release) and
        preemption storms. The engine calls it at the top of every step,
        after its lifecycle sweep."""
        step = engine.step_count
        if self._release_at is not None and step >= self._release_at:
            released = engine.pool.release_held()
            self._release_at = None
            self.fired.append({"step": step, "kind": "release_held", "pages": released})
        for i, f in self._due(step, ("slow_step", "page_exhaustion", "preempt_storm")):
            if f.kind == "slow_step":
                if f.sleep_s > 0:
                    time.sleep(f.sleep_s)
                self._done.add(i)
                self.fired.append({"step": step, "kind": f.kind, "sleep_s": f.sleep_s})
            elif f.kind == "page_exhaustion":
                if not engine._paged:
                    self._done.add(i)  # a contiguous pool has nothing to exhaust
                    continue
                held = engine.pool.hold_pages(f.pages)
                until = step + f.duration
                self._release_at = until if self._release_at is None else max(
                    self._release_at, until)
                self._done.add(i)
                self.fired.append({"step": step, "kind": f.kind, "pages": held, "until": until})
            elif f.kind == "preempt_storm":
                victims = [s for s in engine.slots if s.state == PREFILL]
                if not victims:
                    gen = [s for s in engine.slots if s.active]
                    if gen:
                        victims = [max(gen, key=lambda s: (s.admitted_step, s.idx))]
                if not victims:
                    continue  # deferred until some slot runs
                for s in victims:
                    engine._preempt(s)
                self._done.add(i)
                self.fired.append({"step": step, "kind": f.kind, "preempted": len(victims)})

    def corrupt_logits(self, engine, logits_np: np.ndarray) -> np.ndarray:
        """Value-domain faults: overwrite a target slot's row with NaN or
        Inf and return the logits (copied first if read-only). ``logits_np``
        is the (B, V) host array of a padded or ragged step or the
        (n+1, B, V) one of a speculative round: the slot axis is second from
        last either way."""
        step = engine.step_count
        for i, f in self._due(step, ("nan_logits", "inf_logits")):
            target = f.slot
            decoding = [s.idx for s in engine.slots if s.state == GENERATE]
            if target is None or target not in decoding:
                if not decoding:
                    continue  # deferred until a decode row exists
                target = min(decoding)
            bad = np.nan if f.kind == "nan_logits" else np.inf
            if not logits_np.flags.writeable:
                logits_np = logits_np.copy()
            logits_np[..., target, :] = bad
            self._done.add(i)
            self.fired.append({"step": step, "kind": f.kind, "slot": target})
        return logits_np

    @property
    def exhausted(self) -> bool:
        """True once every scheduled fault fired and its holds are released."""
        return len(self._done) == len(self.faults) and self._release_at is None
