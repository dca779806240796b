"""Continuous-batching serving engine of the port (padded, paged, ragged and
speculative paths, with overload control and fault injection).

- :class:`ServingEngine` — fixed-shape (B, ctx) continuous-batching decode.
- :class:`Request` / :class:`RequestOutput` — job in / out, with priority
  classes, relative deadlines and cancellation; the failure reasons are
  ``FINISH_ERROR`` / ``FINISH_EXPIRED`` / ``FINISH_CANCELLED``.
- :class:`Scheduler` — slot admission (latency class first, FCFS within a
  class, bounded queue).
- :class:`CachePool` / :class:`PagedCachePool` — the contiguous and the
  block-paged KV pools.
- :class:`CapacityController` / :class:`EngineOverloaded` — the capacity
  ladder and bounded backpressure (``EngineConfig(adaptive_capacity=True,
  max_queue=...)``).
- :class:`FaultInjector` / :class:`Fault` — a scheduled fault matrix
  (``EngineConfig(fault_injector=...)``).
- :class:`EngineConfig` and :class:`QuantConfig` — the engine's settings.
"""
from repro_torch.serve.cache import CachePool, PagedCachePool
from repro_torch.serve.config import EngineConfig, add_engine_args
from repro_torch.serve.engine import ServingEngine, routed_capacity
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.overload import CapacityController, EngineOverloaded
from repro_torch.serve.quant import QuantConfig
from repro_torch.serve.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_EXPIRED,
    FINISH_LENGTH,
    PRIORITY_BATCH,
    PRIORITY_LATENCY,
    Request,
    RequestOutput,
    pad_outputs,
)
from repro_torch.serve.scheduler import Scheduler, Slot

__all__ = [
    "CachePool", "CapacityController", "EngineConfig", "EngineOverloaded",
    "FINISH_CANCELLED", "FINISH_EOS", "FINISH_ERROR", "FINISH_EXPIRED", "FINISH_LENGTH",
    "Fault", "FaultInjector", "PRIORITY_BATCH", "PRIORITY_LATENCY", "PagedCachePool",
    "QuantConfig", "Request", "RequestOutput", "Scheduler", "ServingEngine", "Slot",
    "add_engine_args", "pad_outputs", "routed_capacity",
]
