"""Serving-engine configuration of the port.

Port of ``repro/serve/config.py``'s :class:`EngineConfig`, restricted to the
padded (contiguous-pool) engine: ``batch_size``/``ctx`` fix the decode
batch's static shape, ``policy`` picks the admission policy, ``prefill``
the prompt path ("auto" | "batch" | "step") and ``prefill_chunk`` cuts
batched prefill into fixed-size chunks. The settings of the JAX engine's
later paths are fields too, so that a caller who sets one learns at once
that the port does not run it yet: each raises a ``ValueError`` naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["EngineConfig", "add_engine_args"]

# setting -> the ROADMAP item that ports its engine path
_LATER_PATHS = {
    "page_size": "paged pool + prefix cache (ROADMAP Queue 1)",
    "ragged": "ragged mixed step (ROADMAP Queue 1)",
    "speculate": "self-speculative decoding (ROADMAP Queue 1)",
    "quant": "quantized KV and weights (ROADMAP Queue 1)",
    "mesh": "multi-device serving (ROADMAP Queue 1)",
    "adaptive_capacity": "overload control (ROADMAP Queue 1)",
    "fault_injector": "overload control and fault injection (ROADMAP Queue 1)",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int
    ctx: int
    policy: str = "mod_aware"
    prefill: str = "auto"  # "auto" | "batch" | "step"
    prefill_chunk: Optional[int] = None  # chunked batched prefill
    # later engine paths: not ported yet, each raises when set
    page_size: Optional[int] = None
    ragged: bool = False
    speculate: Optional[int] = None
    quant: Any = None
    mesh: Any = None
    adaptive_capacity: bool = False
    fault_injector: Any = None

    def __post_init__(self):
        if not isinstance(self.batch_size, int) or self.batch_size < 1:
            raise ValueError(f"batch_size must be a positive int, got {self.batch_size!r}")
        if not isinstance(self.ctx, int) or self.ctx < 1:
            raise ValueError(f"ctx must be a positive int, got {self.ctx!r}")
        if self.policy not in ("fcfs", "mod_aware"):
            raise ValueError(f"unknown scheduling policy {self.policy!r}")
        if self.prefill not in ("auto", "batch", "step"):
            raise ValueError(f"unknown prefill mode {self.prefill!r}")
        if self.prefill_chunk is not None and int(self.prefill_chunk) < 1:
            raise ValueError("prefill_chunk must be >= 1")
        for name, path in _LATER_PATHS.items():
            if getattr(self, name) not in (None, False):
                raise ValueError(f"{name} selects the {path} path, which the port does not run yet")

    @classmethod
    def from_args(cls, ns, *, batch_size: int, ctx: int) -> "EngineConfig":
        return cls(batch_size=batch_size, ctx=ctx, policy=ns.policy,
                   prefill_chunk=ns.prefill_chunk or None)


def add_engine_args(parser) -> None:
    """The engine flags of the port's serving CLI (the padded path's subset
    of the JAX ``add_engine_args``)."""
    g = parser.add_argument_group("serving engine")
    g.add_argument("--policy", default="mod_aware", choices=["fcfs", "mod_aware"])
    g.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked batched prefill piece size (0 = whole prompt in one call)")
