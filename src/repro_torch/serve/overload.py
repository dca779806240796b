"""Load-adaptive capacity control of the serving engine.

Port of ``repro/serve/overload.py``. MoD's capacity ratio is a runtime
compute-against-quality knob that a dense engine does not have: ``k`` is
static per level (paper §3), so every discrete capacity level is one
fixed computation. :class:`CapacityController` watches two pressure
signals each engine step, the queue depth and the windowed p99 step
latency, and walks the engine down a small, discrete, bounded ladder of
capacity levels under sustained pressure. Level 0 is full capacity; each
deeper level scales the MoD ``capacity_ratio`` (the decode step's ``kb``,
:func:`repro_torch.core.routing.capacity_ladder`) and the batch-tier
admission budget (admissions a wave, or ragged prefill segments) by the
same factor.

Hysteresis:

- **Degrade** one level after ``degrade_patience`` consecutive hot
  observations (queue depth >= ``queue_high``, or p99 >= ``p99_high_s``
  when a latency SLO is set).
- **Restore** one level after ``restore_patience`` consecutive calm
  observations (queue depth <= ``queue_low`` and p99 below the SLO).
- An observation inside the band (``queue_low`` < depth < ``queue_high``)
  resets both streaks: the controller holds its level.

Degradation only ever applies to ``batch``-tier work: a step with a
``latency``-tier request active decodes at level 0, and latency-tier
admissions bypass the degraded budget. The engine enforces that; the
controller only tracks the level.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

__all__ = ["CapacityController", "EngineOverloaded", "default_levels"]


class EngineOverloaded(RuntimeError):
    """Raised by ``ServingEngine.submit`` when the bounded queue is full
    (``max_queue``): the request is rejected with a ``reason`` instead of
    queueing without bound; the client may retry later."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class CapacityController:
    """Discrete, bounded, hysteretic capacity ladder for one engine.

    n_levels:          ladder length (level 0 = full capacity).
    queue_high:        queue depth at or above which an observation is hot.
    queue_low:         queue depth at or below which an observation is calm
                       (must be < queue_high: the hysteresis band).
    p99_high_s:        optional step-latency SLO in engine-clock seconds;
                       when set, a windowed p99 at or above it is hot too,
                       and restoring also needs the p99 below it.
    window:            sliding step-latency window of the p99.
    degrade_patience:  consecutive hot observations before degrading.
    restore_patience:  consecutive calm observations before restoring one
                       level.
    """

    def __init__(
        self,
        n_levels: int,
        queue_high: int,
        queue_low: int,
        p99_high_s: Optional[float] = None,
        window: int = 64,
        degrade_patience: int = 2,
        restore_patience: int = 8,
    ):
        if n_levels < 1:
            raise ValueError(f"need at least one capacity level, got {n_levels}")
        if not (0 <= queue_low < queue_high):
            raise ValueError(
                f"need 0 <= queue_low < queue_high for hysteresis, "
                f"got low={queue_low} high={queue_high}"
            )
        if degrade_patience < 1 or restore_patience < 1:
            raise ValueError("patience values must be >= 1")
        self.n_levels = int(n_levels)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.p99_high_s = p99_high_s
        self.degrade_patience = int(degrade_patience)
        self.restore_patience = int(restore_patience)
        self.level = 0
        self._lat: Deque[float] = deque(maxlen=int(window))
        self._hot = 0
        self._calm = 0
        # monotone telemetry (ServingEngine.stats())
        self.degraded_steps = 0  # observations spent at level > 0
        self.level_changes = 0
        self.max_level_seen = 0

    def p99(self) -> float:
        """Windowed p99 step latency (0.0 before the first observation)."""
        if not self._lat:
            return 0.0
        return float(np.percentile(np.asarray(self._lat), 99))

    def observe(self, queue_depth: int, step_s: float) -> int:
        """Feed one step's pressure signals; returns the (possibly new)
        level. The engine calls it once per engine step."""
        self._lat.append(float(step_s))
        p99 = self.p99()
        slo_hot = self.p99_high_s is not None and p99 >= self.p99_high_s
        hot = queue_depth >= self.queue_high or slo_hot
        calm = queue_depth <= self.queue_low and not slo_hot
        if hot:
            self._hot += 1
            self._calm = 0
        elif calm:
            self._calm += 1
            self._hot = 0
        else:  # inside the band: hold the level, reset both streaks
            self._hot = 0
            self._calm = 0
        if self._hot >= self.degrade_patience and self.level < self.n_levels - 1:
            self.level += 1
            self.level_changes += 1
            self.max_level_seen = max(self.max_level_seen, self.level)
            self._hot = 0
        elif self._calm >= self.restore_patience and self.level > 0:
            self.level -= 1
            self.level_changes += 1
            self._calm = 0
        if self.level > 0:
            self.degraded_steps += 1
        return self.level

    def stats(self) -> dict:
        return {
            "capacity_level": float(self.level),
            "capacity_level_max": float(self.max_level_seen),
            "capacity_level_changes": float(self.level_changes),
            "degraded_steps": float(self.degraded_steps),
            "step_p99_s": self.p99(),
        }


def default_levels() -> Tuple[float, ...]:
    """The stock 3-level ladder: full, half and quarter capacity."""
    return (1.0, 0.5, 0.25)
