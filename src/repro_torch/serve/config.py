"""Serving-engine configuration of the port.

Port of ``repro/serve/config.py``'s :class:`EngineConfig`, with the padded
and paged engines' settings: ``batch_size``/``ctx`` fix the decode batch's
static shape, ``policy`` picks the admission policy, ``prefill`` the prompt
path ("auto" | "batch" | "step") and ``prefill_chunk`` cuts batched
prefill into fixed-size chunks. ``page_size`` switches to the block-paged
KV pool (``n_pages`` physical pages, ``prefix_cache`` for shared prompt
prefixes, ``paged_backend`` "xla" | "pallas", both of which run the CUDA
paged kernels on the card), and ``ragged`` to the mixed prefill+decode
step over that pool (``ragged_segments`` prefill chunks per step).
``quant`` (a :class:`repro_torch.serve.quant.QuantConfig`) stores the paged
pool's K/V pages in int8 or fp8 and can serve from int8 weights.
``speculate`` runs self-speculative rounds over the paged pool: draft
``speculate`` tokens at MoD capacity ``draft_ratio``, verify the window at
full capacity, roll rejected tails back (``spec_verify_budget`` caps the
verify positions a round may spend). ``adaptive_capacity`` arms the
overload controller (:mod:`repro_torch.serve.overload`; ``capacity_levels``
sets the ladder's scales, ``capacity_controller`` replaces the default
controller), ``max_queue`` bounds the queue, ``fault_injector`` threads a
:class:`repro_torch.serve.faults.FaultInjector` through the step, ``clock``
replaces the deadline clock (``time.monotonic``) and ``logit_tap`` is
called with the host decode logits ``(B, V)`` after every padded or ragged
step that decoded. ``data_shards`` gives MoD decode the partitioned
``batch_capacity`` routing on one device (each of ``d`` contiguous slot
groups routes its own top ``round(ratio·B/d)``), and ``mesh`` (a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``, every rank running the same engine) serves over ranks: slots
over "data", tensor parallelism over "model". Checks and messages are the
JAX package's, plus the port's own check that ``mesh`` is such a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from repro_torch.serve.quant import GRANULARITIES, KV_MODES, QuantConfig

__all__ = ["EngineConfig", "add_engine_args"]

PAGED_BACKENDS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_size: int
    ctx: int
    policy: str = "mod_aware"
    prefill: str = "auto"  # "auto" | "batch" | "step"
    prefill_chunk: Optional[int] = None  # chunked batched prefill
    page_size: Optional[int] = None  # block-paged KV pool (None = contiguous)
    n_pages: Optional[int] = None  # physical page count (default: B·ctx/page + 2)
    prefix_cache: bool = False  # hash-chained prompt-prefix page reuse
    paged_backend: str = "xla"  # paged gather/scatter: "xla" | "pallas"
    ragged: bool = False  # mixed prefill+decode step over the paged pool
    ragged_segments: int = 4  # prefill segments per ragged step
    quant: QuantConfig = QuantConfig()  # KV/weight quantization policy
    speculate: Optional[int] = None  # self-speculative: draft n tokens/round
    draft_ratio: float = 0.0  # drafter's MoD capacity ratio (0 = pure skip)
    spec_verify_budget: Optional[int] = None  # verify-token budget per round
    adaptive_capacity: bool = False  # load-adaptive MoD capacity ladder
    capacity_levels: Optional[Tuple[float, ...]] = None  # ladder scales
    capacity_controller: Any = None  # overload.CapacityController override
    max_queue: Optional[int] = None  # bounded backpressure: reject at depth
    fault_injector: Any = None  # faults.FaultInjector
    clock: Optional[Callable[[], float]] = None  # deadline clock (monotonic)
    logit_tap: Optional[Callable] = None  # decode-logits telemetry hook
    mesh: Any = None  # DeviceMesh ([pod,] data, model): serving over ranks
    data_shards: Optional[int] = None  # partitioned routing semantics

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
        paged = self.page_size is not None
        if not paged and (self.n_pages is not None or self.prefix_cache):
            raise ValueError("n_pages/prefix_cache require page_size")
        if self.ragged:
            if not paged:
                raise ValueError("ragged=True requires the paged pool (page_size)")
            if int(self.ragged_segments) < 1:
                raise ValueError("ragged_segments must be >= 1")
        if self.speculate is not None:
            if int(self.speculate) < 1:
                raise ValueError("speculate must be >= 1")
            if not paged:
                raise ValueError("speculate requires the paged pool (page_size): rollback "
                                 "releases rejected tail pages via PagedCachePool.truncate")
            if not (0.0 <= float(self.draft_ratio) <= 1.0):
                raise ValueError(f"draft_ratio must be in [0, 1], got {self.draft_ratio}")
        elif self.spec_verify_budget is not None:
            raise ValueError("spec_verify_budget requires speculate")
        adaptive = self.adaptive_capacity or self.capacity_controller is not None
        if self.capacity_levels is not None and not adaptive:
            raise ValueError("capacity_levels requires adaptive_capacity")
        if self.paged_backend not in PAGED_BACKENDS:
            raise ValueError(f"unknown paged backend {self.paged_backend!r}")
        if not isinstance(self.quant, QuantConfig):
            raise ValueError(f"quant must be a QuantConfig, got {type(self.quant).__name__}")
        if self.quant.enabled and not paged:
            raise ValueError("quantized KV requires the paged pool (page_size): narrow pages "
                             "and their scales live behind the page tables")
        if self.mesh is not None:
            names = tuple(getattr(self.mesh, "mesh_dim_names", None) or ())
            if names not in (("data", "model"), ("pod", "data", "model")):
                raise ValueError(
                    "mesh must be a torch.distributed DeviceMesh with dims ('data', 'model') or "
                    "('pod', 'data', 'model') (repro_torch.launch.mesh.auto_mesh), got "
                    f"{self.mesh!r}")
        if self.data_shards is not None and (
                not isinstance(self.data_shards, int) or self.data_shards < 1):
            raise ValueError(f"data_shards must be a positive int, got {self.data_shards!r}")

    @classmethod
    def from_args(cls, ns, *, batch_size: int, ctx: int, **overrides) -> "EngineConfig":
        """The config of an :func:`add_engine_args` namespace; ``overrides``
        replace any field after the flags are mapped (``fault_injector=...``)."""
        fields = dict(
            batch_size=batch_size, ctx=ctx, policy=ns.policy,
            prefill_chunk=ns.prefill_chunk or None,
            page_size=ns.page_size or None, n_pages=ns.n_pages or None,
            prefix_cache=ns.prefix_cache, ragged=ns.ragged,
            ragged_segments=ns.ragged_segments,
            speculate=ns.speculate or None, draft_ratio=ns.draft_ratio,
            spec_verify_budget=ns.verify_budget or None,
            adaptive_capacity=ns.adaptive_capacity,
            quant=QuantConfig(kv=ns.quant_kv, granularity=ns.quant_scale),
            data_shards=ns.data_shards or None,
        )
        fields.update(overrides)
        return cls(**fields)


def add_engine_args(parser) -> None:
    """The engine flags of the port's serving CLI (the JAX
    ``add_engine_args`` flags, same names)."""
    g = parser.add_argument_group("serving engine")
    g.add_argument("--policy", default="mod_aware", choices=["fcfs", "mod_aware"])
    g.add_argument("--page-size", type=int, default=0,
                   help="block-paged KV pool with this page size (0 = contiguous pool); "
                        "memory scales with live pages, admission is page-aware, OOM preempts")
    g.add_argument("--n-pages", type=int, default=0,
                   help="physical page count (default: batch*ctx/page-size + 2)")
    g.add_argument("--prefix-cache", action="store_true",
                   help="reuse chunk-aligned shared prompt prefixes across requests "
                        "(requires --page-size)")
    g.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked batched prefill piece size (0 = whole prompt in one call)")
    g.add_argument("--ragged", action="store_true",
                   help="one mixed step carries decode rows and prefill segments over "
                        "the paged pool (requires --page-size; admission is budgeted by "
                        "free segments)")
    g.add_argument("--ragged-segments", type=int, default=4,
                   help="prefill segments per mixed step (--ragged)")
    g.add_argument("--speculate", type=int, default=0,
                   help="self-speculative decoding: draft N tokens per round with the model "
                        "at --draft-ratio capacity, verify the window at full capacity, roll "
                        "back rejected tails by paged truncation (requires --page-size; "
                        "greedy streams stay identical to N=0)")
    g.add_argument("--draft-ratio", type=float, default=0.0,
                   help="MoD capacity ratio of the drafter (0.0 = pure residual-skip path; "
                        "only meaningful with --speculate)")
    g.add_argument("--verify-budget", type=int, default=0,
                   help="verify-token budget per speculative round: admission stops while "
                        "active slots x (speculate+1) would exceed it (0 = uncapped)")
    g.add_argument("--adaptive-capacity", action="store_true",
                   help="enable the overload capacity controller: under queue/latency "
                        "pressure it walks MoD capacity ratio and the batch-tier admission "
                        "budget down a discrete ladder (latency-tier is exempt)")
    g.add_argument("--quant-kv", default="none", choices=list(KV_MODES),
                   help="paged KV page storage dtype: int8 / fp8 (e4m3) with per-page-row "
                        "pow2 scales, widened by the dequantizing gather kernel (requires "
                        "--page-size)")
    g.add_argument("--quant-scale", default="page", choices=list(GRANULARITIES),
                   help="quantization scale granularity: one scale per page row, or one per "
                        "row per kv head")
    g.add_argument("--data-shards", type=int, default=0,
                   help="partitioned MoD decode routing: each of N contiguous slot groups "
                        "routes its own top round(ratio*B/N) (0 = off; under --spmd it must "
                        "equal the mesh's data degree)")
