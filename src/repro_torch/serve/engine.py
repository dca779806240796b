"""Continuous-batching serving engine over the MoD routing engine.

Port of ``repro/serve/engine.py::ServingEngine``: one ``(B, 1)`` decode
step against a pooled ``(B, ctx)`` cache, kept full by admitting queued
requests into slots as others terminate (:mod:`repro_torch.serve.scheduler`).

- **Batched prefill** (``prefill="auto"`` for the dense and MoE families;
  ``BATCH_PREFILL_FAMILIES``): each
  admitted prompt runs through ``model_prefill`` at batch 1 (token_topk
  MoD routing, capacity-sized cache writes) — or chunk by chunk through
  ``model_prefill_chunk`` with ``prefill_chunk`` — its cache is copied
  into the slot, and the first new token comes from the prefill's
  last-position logits (the last prompt token is not re-decoded).
- **Stepped ingestion** (``prefill="step"``, and ``"auto"`` for the ssm,
  hybrid, enc-dec and VLM families, whose ``prefill="batch"`` raises as in
  JAX): the slot feeds one prompt token per engine step through the
  shared decode step. Prefix cache, ragged step, chunked prefill and
  speculation need batched prefill and raise otherwise; the paged pool
  serves ssm with every state leaf residual, the hybrid with its shared
  block's KV rings paged and its SSM states residual, and enc-dec with its
  full-context self rings paged and its cross-KV residual. An enc-dec
  request's ``enc_emb`` runs through the encoder once at admission
  (``encdec.prefill_cross``) and fills the slot's cross-KV; a preempted
  request refills it on re-admission. The VLM engine decodes text tokens
  (its three M-RoPE streams equal), as JAX's does.
- **Decode**: every step passes an ``active`` mask so padding rows never win
  ``batch_capacity`` routed rows, and reads back the per-sequence
  ``mod/decode_routed`` / ``mod/decode_scores`` telemetry.

**Paged serving** (``EngineConfig.page_size``): the block-paged
:class:`repro_torch.serve.cache.PagedCachePool` holds full-attention KV in
refcounted pages mapped lazily as sequences grow. Admission is page-aware
(worst-case availability, a gated request skipped, not a barrier), pool
exhaustion preempts the youngest slot back to the queue front, and
``prefix_cache`` reuses chunk-aligned shared prompt prefixes (pages plus a
residual-state snapshot) bit-identically to a cold run. The decode step
gathers the logical caches from the pages (paged gather kernel), decodes,
and scatters each slot's new row into its tail page (paged scatter kernel).

**Ragged mixed step** (``ragged=True``, paged): one step per engine step
carries up to ``ragged_segments`` prefill segments (``prefill_chunk``
tokens of some slot's prompt each, oldest slot first) and the decode rows
together, and one ragged write-back kernel per paged leaf puts every KV row
it produced into the pages. Admission is budgeted by free segments. The
JAX step is one ``lax.scan`` over a fixed segment grid; here a Python loop
runs the live segments only, and decode runs only when some slot decodes.

**Quantized serving** (``EngineConfig.quant``): with ``kv`` set, the paged
pool stores its K/V pages in int8 or fp8 with pow2 scales; every chunk of
a chunked prefill (padded or a ragged segment) round-trips the rows it
wrote through the narrow dtype, so the next chunk, a prefix-cache warm
restore and the ragged step all see what the pool stores. With ``weights
= "int8"`` the engine keeps only the narrow parameter tree and widens it
at each model call.

**Self-speculative rounds** (``EngineConfig.speculate = n``, paged): one
round materializes the pool once, drafts ``n`` tokens with the same model
at MoD capacity ``draft_ratio`` (on a clone of the caches), verifies the
``n+1``-token window at full capacity (one chain of decode steps, or a
single fused chain when the drafter is the verifier), collects each step's
KV rows and residual state, and writes the window's rows with one ragged
scatter per paged leaf. The host accepts the longest prefix on which its
sampled tokens agree with the drafts, batch-globally (every slot advances
by the same ``a``, capped at the first in-window termination), and rolls
the rest back: the residual pool to its snapshot after step ``a``, each
slot's page table by :meth:`PagedCachePool.truncate`. Streams equal the
plain engine's token for token. The ragged engine runs its mixed step
while any slot is mid-prompt, and rounds otherwise.

**Overload control and faults** (every path above): each engine step
opens with the lifecycle sweep (:meth:`ServingEngine._police`: cancelled
and deadline-expired requests leave, queued ones shed without prefill)
and the fault injector's time-domain faults, and closes with one
observation of the queue depth and the step's latency by the capacity
controller (``adaptive_capacity``, :mod:`repro_torch.serve.overload`). The
controller's level picks the decode step's config off the capacity ladder
(:func:`repro_torch.core.routing.capacity_ladder`: MoD ``kb`` scaled by
the level) and scales the batch-tier admission budget; a step with a
latency-tier request active decodes at level 0. ``max_queue`` bounds the
queue (``submit`` raises :class:`EngineOverloaded`). After each step and
before sampling, ``logit_tap`` sees the host logits and the fault
injector may poison a row (:mod:`repro_torch.serve.faults`); a non-finite
row fails only its own request.

**Partitioned routing and the mesh** (``EngineConfig.data_shards``,
``EngineConfig.mesh``): ``data_shards=d`` gives MoD decode the partitioned
``batch_capacity`` semantics on one device (each of ``d`` contiguous slot
groups routes its own top ``round(ratio·B/d)`` rows; the scheduler counts
against the global ``d·kb_local``), on the contiguous, paged, prefix and
quantized-KV engines. ``mesh`` (a ``DeviceMesh`` ("data", "model") or
("pod", "data", "model"); the data degree is pod × data, slot groups
pod-major) is the multi-controller engine, for every family: every rank
runs this same engine on the same requests, so host state (queue, slots,
sampled tokens) stays identical.
A rank holds the ``B/d`` slots of its data group and its shards of the
weights (tensor parallelism over "model"), decodes its own rows with
routing local to the shard and no cross-data collective, and the logits
and routing telemetry are gathered over the data group so every rank
samples every slot's token (``token_generator(seed, i)``, as always). A
prompt's prefill runs on the data group that holds its slot, which
broadcasts the first token's logits to its data peers. The mesh serves
the contiguous pool only, and ``ragged``, ``speculate`` and
``adaptive_capacity`` raise with either setting, as in JAX.

Sampling runs on the host: greedy argmax, or a draw keyed by the
request's seed and the token's index (see :mod:`repro_torch.serve.request`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.routing import batch_capacity_k, capacity_ladder
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models import api
from repro_torch.models import encdec as ED
from repro_torch.serve.cache import CachePool, PagedCachePool, flatten, slot_slice
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.overload import CapacityController, EngineOverloaded, default_levels
from repro_torch.serve.quant import dequantize_params, quantize_params
from repro_torch.serve.request import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_EXPIRED,
    FINISH_LENGTH,
    PRIORITY_LATENCY,
    Request,
    RequestOutput,
    pad_outputs,
    token_generator,
)
from repro_torch.serve.scheduler import FREE, GENERATE, PREFILL, Scheduler, Slot


# Families whose prompts run through model_prefill in one shot (the JAX
# engine's list). The others ingest prompts one token per engine step
# through the shared decode step.
BATCH_PREFILL_FAMILIES = ("dense", "moe")


def routed_capacity(cfg: ModelConfig, batch_size: int, data_shards: int = 1) -> Optional[int]:
    """The *global* kb of the batch_capacity router; None when MoD is off.
    Under a partitioned batch each of the ``data_shards`` groups routes
    ``round(ratio·B/d)`` of its own slots, so the scheduler counts against
    the sum over groups, not ``round(ratio·B)`` (B=8, d=4, ratio 0.125
    routes 4 slots a step, not 1: every group routes at least one)."""
    if not cfg.mod.enabled:
        return None
    return batch_capacity_k(cfg, batch_size, data_shards)


class _PoolExhausted(RuntimeError):
    """A gate-passed admission lost its pages (another admission of the same
    wave evicted the prefix entry its page discount relied on); ``_admit``
    unwinds it."""


class ServingEngine:
    """Continuous-batching decode over a fixed (batch_size, ctx) pool.

    ``params`` must live on ``device`` (CUDA unless the caller passes
    ``device="cpu"``). Under ``quant.weights="int8"`` the engine holds
    their int8 quantization instead, not a wide copy."""

    def __init__(self, params: Any, cfg: ModelConfig, engine: EngineConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['tok'].device}, the engine runs on {self.device}"
            )
        self.quant = engine.quant if engine.quant.enabled else None
        self._narrow_weights = engine.quant.weights == "int8"
        self.mesh = engine.mesh
        self.spmd = (SH.shard_ctx(engine.mesh, engine.data_shards)
                     if engine.mesh is not None or engine.data_shards else None)
        if self.spmd is not None:
            self.spmd.check_batch(engine.batch_size)
        shards = self.spmd.data_shards if self.spmd is not None else 1
        if self.mesh is not None:
            if self._narrow_weights:
                raise NotImplementedError(
                    "weight quantization + SPMD mesh: the narrow tree "
                    "needs its own sharding rules"
                )
            # this rank's shards of the weights (tensor parallelism), and
            # the context that records which leaves were cut
            params, self.spmd = SH.shard_params(params, cfg, self.spmd)
        # serve from int8 weights: only the narrow tree stays resident, and
        # each model call widens it (dequantize_params)
        self.params = quantize_params(params) if self._narrow_weights else params
        self.cfg = cfg
        self.batch_size = engine.batch_size
        self.ctx = engine.ctx
        self._batch_prefill = engine.prefill == "batch" or (
            engine.prefill == "auto" and cfg.family in BATCH_PREFILL_FAMILIES)
        if self._batch_prefill and cfg.family not in BATCH_PREFILL_FAMILIES:
            raise ValueError(f"family {cfg.family!r} has no batched prefill")
        prefill_chunk = engine.prefill_chunk
        if prefill_chunk is not None and not self._batch_prefill:
            raise ValueError(
                "prefill_chunk applies to batched prefill (dense/MoE families, prefill "
                f"'auto' or 'batch'); this {cfg.family!r} engine ingests prompts through "
                "decode steps")
        self._paged = engine.page_size is not None
        self._prefix_cache = engine.prefix_cache
        self._ragged = engine.ragged
        self._ragged_segments = int(engine.ragged_segments)
        if self._prefix_cache and not self._batch_prefill:
            raise ValueError("prefix_cache requires batched prefill (a dense/MoE family, "
                             "prefill 'auto' or 'batch')")
        if self._ragged and not self._batch_prefill:
            raise ValueError("ragged=True needs batched prefill (a dense/MoE family, prefill "
                             "'auto' or 'batch'): prefill segments replay model_prefill_chunk "
                             "inside the step")
        if self._paged and self.mesh is not None:
            raise NotImplementedError("paged pool + SPMD mesh: shard the pages")
        if self._ragged and (self.mesh is not None or engine.data_shards):
            raise NotImplementedError("ragged mixed step + SPMD mesh/data_shards")
        if (self._prefix_cache or self._ragged) and prefill_chunk is None:
            prefill_chunk = engine.page_size  # page-aligned boundaries by default
        self._prefill_chunk = prefill_chunk
        self._speculate = None if engine.speculate is None else int(engine.speculate)
        if self._speculate is not None:
            if not self._batch_prefill:
                raise ValueError("speculate needs a batched-prefill family (dense/MoE): "
                                 "stepped prompt ingestion would draft prompt tokens")
            if not cfg.attn.causal:
                raise ValueError("speculate requires causal attention: rolled-back rows inside "
                                 "the last kept page are hidden by the causal mask until the "
                                 "accepted stream overwrites them")
            if self.mesh is not None or engine.data_shards:
                raise NotImplementedError("speculative rounds + SPMD mesh/data_shards")
            ratio = float(engine.draft_ratio)
            self._draft_cfg = dataclasses.replace(
                cfg, mod=dataclasses.replace(cfg.mod, capacity_ratio=ratio))
            # the drafter is the verifier (MoD off, or the engine's own
            # ratio): one chain of n+1 steps drafts and verifies at once
            self._fused = not cfg.mod.enabled or ratio == cfg.mod.capacity_ratio
            # positions the round computes per batch row
            # (padded_token_fraction accounting)
            self._spec_grid = self._speculate + 1 if self._fused else 2 * self._speculate + 1
        if self._paged:
            self.pool: Any = PagedCachePool(
                cfg, self.batch_size, self.ctx, engine.page_size, self.device,
                n_pages=engine.n_pages,
                prefix_chunk=prefill_chunk if self._prefix_cache else None,
                quant=self.quant,
            )
        else:
            self.pool = CachePool(cfg, self.batch_size, self.ctx, self.device, spmd=self.spmd)
        self.scheduler = Scheduler(self.batch_size, engine.policy,
                                   routed_capacity(cfg, self.batch_size, shards),
                                   verify_token_budget=engine.spec_verify_budget,
                                   max_queue=engine.max_queue)
        self.slots = [Slot(i) for i in range(self.batch_size)]
        self.finished: List[RequestOutput] = []
        self.step_count = 0
        self.generated_tokens = 0
        self.decode_steps = 0
        self.preemptions = 0  # mid-generation evictions (pages exhausted)
        self.admission_aborts = 0  # gate-passed admissions unwound pre-batch
        self._prefill_tokens_computed = 0
        self._positions_computed = 0
        self._positions_wasted = 0
        self._routed_frac_sum = 0.0
        self._routed_frac_steps = 0
        self._occupancy_sum = 0
        self._uid = 0
        self._used_uids: set = set()
        self._wall_s = 0.0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._n_prefills = 0
        # speculative telemetry: accepted drafts over drafted tokens
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted_drafts = 0
        self._spec_emitted = 0

        # -- overload control and faults ---------------------------------
        self._clock = engine.clock if engine.clock is not None else time.monotonic
        self._faults = engine.fault_injector
        self._logit_tap = engine.logit_tap
        adaptive = engine.adaptive_capacity or engine.capacity_controller is not None
        if adaptive and self._speculate is not None:
            raise NotImplementedError(
                "adaptive_capacity + speculate: a speculative round already "
                "runs two capacity ratios; composing the ladder with the "
                "rollback machinery is future work"
            )
        if adaptive and (self.mesh is not None or engine.data_shards):
            raise NotImplementedError("adaptive_capacity + SPMD mesh/data_shards")
        scales = (tuple(float(x) for x in engine.capacity_levels)
                  if engine.capacity_levels is not None else default_levels())
        # validates the ladder even when MoD is off (a dense engine still
        # scales its host-side admission budget by the levels)
        self._level_cfgs = capacity_ladder(cfg, scales) if adaptive else (cfg,)
        self._capacity_scales = scales if adaptive else (1.0,)
        self._controller = (engine.capacity_controller or CapacityController(
            n_levels=len(scales), queue_high=2 * self.batch_size,
            queue_low=max(1, self.batch_size // 2))) if adaptive else None
        # a level's decode step: the same step under that level's config,
        # made on first use; nothing else is kept per level
        self._level_fns: Dict[int, Callable] = {}
        self._degraded_decode_steps = 0
        self.last_step_level = 0  # ladder level of the most recent step
        # monotone robustness counters (stats(), always present)
        self._n_shed = 0
        self._n_expired = 0
        self._n_cancelled = 0
        self._n_failed = 0

    @property
    def prefill_mode(self) -> str:
        """How prompts enter: "batch" (model_prefill) or "step" (one prompt
        token per decode step)."""
        return "batch" if self._batch_prefill else "step"

    def _model_params(self) -> Any:
        """The parameters of one model call: widened from the int8 tree when
        the engine serves narrow weights (a transient wide copy)."""
        return dequantize_params(self.params) if self._narrow_weights else self.params

    def _chunk(self, params: Any, work: Any, tokens: np.ndarray, start: int, nv: int):
        """One prefill chunk against a batch-1 working cache (in place);
        on a quantized pool the rows it wrote then go through the narrow
        dtype (the chunk boundary is a quantization boundary)."""
        logits, work = api.model_prefill_chunk(
            params, self.cfg, work, torch.as_tensor(tokens, device=self.device), start, nv,
            spmd=self._mesh_ctx())
        if self.quant is not None:
            j = torch.arange(self.ctx, device=self.device)
            self.pool.quant_roundtrip(work, ((j >= start) & (j < start + nv))[None])
        return logits, work

    # ------------------------------------------------------------------
    # Submission and admission
    # ------------------------------------------------------------------

    def _level_fn(self, level: int) -> Callable:
        """The decode step of one capacity-ladder level, ``(params, caches,
        token, pos, active) -> (logits, caches, aux)``: ``model_decode``
        under the level's config (only MoD's kb differs), made on first use."""
        if level not in self._level_fns:
            cfg, spmd = self._level_cfgs[level], self.spmd
            self._level_fns[level] = lambda p, c, t, pos, act: api.model_decode(
                p, c, cfg, t, pos, act, spmd=spmd)
        return self._level_fns[level]

    def _capacity_level(self) -> int:
        """The ladder level of this step's decode: 0 unless the controller
        is degraded and no latency-tier request is active (latency-tier work
        always decodes at full capacity), and always 0 for a MoD-less config
        (its ladder scales only the admission budget)."""
        if self._controller is None or self._controller.level == 0:
            return 0
        if not self.cfg.mod.enabled:
            return 0
        if any(s.active and s.req.priority == PRIORITY_LATENCY for s in self.slots):
            return 0
        return min(self._controller.level, len(self._level_cfgs) - 1)

    def _step_level(self) -> int:
        """The level of a step that runs: recorded in ``last_step_level``
        and counted when degraded."""
        lvl = self._capacity_level()
        self.last_step_level = lvl
        if lvl:
            self._degraded_decode_steps += 1
        return lvl

    def _batch_admission_cap(self) -> Optional[int]:
        """The degraded per-wave admission budget of batch-tier requests
        (None = uncapped): the base (slots, or ragged segments) scaled by the
        level's factor. Latency-tier admissions bypass it in the scheduler.
        A per-wave budget, not a concurrency cap: the ladder makes steps
        cheaper, not fewer."""
        if self._controller is None or self._controller.level == 0:
            return None
        lvl = min(self._controller.level, len(self._capacity_scales) - 1)
        base = self._ragged_segments if self._ragged else self.batch_size
        return max(1, int(round(base * self._capacity_scales[lvl])))

    def submit(self, req: Request) -> int:
        """Queue a request; returns its uid. Raises ``ValueError`` for a
        request that can never run and :class:`EngineOverloaded` when the
        queue is at ``max_queue``."""
        if req.total_len > self.ctx:
            raise ValueError(f"request needs {req.total_len} positions but engine ctx is {self.ctx}")
        if self._paged and self.pool.pages_needed(req.total_len) > self.pool.allocatable_pages:
            # fail fast: the admission gate would block it forever
            raise ValueError(
                f"request needs {self.pool.pages_needed(req.total_len)} pages worst-case but "
                f"the pool has {self.pool.allocatable_pages}"
            )
        if req.deadline_s is not None and req.deadline_s <= 0.0:
            # never servable: the first lifecycle sweep would shed it
            raise ValueError(
                f"deadline_s must be positive, got {req.deadline_s}: the "
                "deadline has already elapsed at submit"
            )
        if self.scheduler.queue_full:
            # bounded backpressure: reject with a reason instead of growing
            # the queue (and every queued request's wait) without bound
            self._n_shed += 1
            raise EngineOverloaded(
                f"queue depth {len(self.scheduler.queue)} is at max_queue="
                f"{self.scheduler.max_queue}; request rejected, retry later"
            )
        if req.uid is None:
            req.uid = self._uid
        elif req.uid in self._used_uids:
            raise ValueError(f"request uid {req.uid} already submitted")
        self._used_uids.add(req.uid)
        self._uid = max(self._uid, req.uid) + 1
        req._submitted_step = self.step_count  # type: ignore[attr-defined]
        if req.deadline_s is not None:
            # absolute deadline on the engine clock, armed at submit: queue
            # wait counts against it
            req._deadline_t = self._clock() + req.deadline_s  # type: ignore[attr-defined]
        self.scheduler.submit(req)
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Client cancellation by uid: marks the request, and the next
        step's lifecycle sweep ends it with ``FINISH_CANCELLED`` (a queued
        one without prefill, a running one with its partial output and its
        pages released). False for an unknown or already finished uid."""
        for r in self.scheduler.queue:
            if r.uid == uid:
                r.cancel()
                return True
        for s in self.slots:
            if s.active and s.req.uid == uid:
                s.req.cancel()
                return True
        return False

    def _page_gate(self):
        """Admission gate of the paged pool: a request enters only if its
        worst-case page count (less the pages a cached prefix covers) is
        obtainable now, net of what the same wave already claimed.
        Availability, not reservation: running slots still grow lazily, and
        preemption is the backstop for overcommit."""
        if not self._paged:
            return None
        claimed = [0]

        def gate(req: Request) -> bool:
            need = self.pool.pages_needed(req.total_len)
            if self._prefix_cache:
                need -= self.pool.prefix_probe_pages(req.tokens)
            ok = need <= self.pool.available_pages() - claimed[0]
            if ok:
                claimed[0] += need
            return ok

        return gate

    def _start(self, slot: Slot, req: Request) -> None:
        """Bind an admitted request to its slot (pool rows back to empty)."""
        if self._paged:
            self.pool.acquire(slot.idx)
        else:
            self.pool.reset(slot.idx)
        slot.req = req
        slot.generated = []
        slot.admitted_step = self.step_count
        slot.first_token_step = -1
        slot.routed_sum, slot.routed_steps = 0.0, 0
        slot.score, slot.score_sum, slot.score_steps = float("nan"), 0.0, 0
        if self.cfg.family == "encdec" and req.enc_emb is not None and self._holds(slot.idx):
            self._fill_cross(slot.idx, req.enc_emb)

    def _fill_cross(self, slot: int, enc_emb: Any) -> None:
        """Run the encoder over a request's frames (S_enc, D), cast to the
        model's dtype, and write the slot's cross-KV (with the template's
        empty self rings, which the slot holds already)."""
        params = self._model_params()
        emb = torch.as_tensor(enc_emb).to(device=self.device,
                                          dtype=params["embed"]["tok"].dtype)[None]
        with SH.model_parallel(self._mesh_ctx()):  # a rank's heads of the cross-KV
            cross = ED.prefill_cross(params, self.pool._template, emb, self.cfg)
        self.pool.write_slot(slot, cross)

    def _admit(self, max_admissions: Optional[int] = None) -> None:
        plans = self.scheduler.plan_admissions(self.slots, stepped_prefill=not self._batch_prefill,
                                               page_gate=self._page_gate(),
                                               max_admissions=max_admissions,
                                               batch_cap=self._batch_admission_cap())
        for slot, req in plans:
            self._start(slot, req)
            if not self._batch_prefill:
                if self._paged and not self.pool.alloc_pages(slot.idx, 1):
                    self._abort_admission(slot, req)
                    continue
                slot.state = PREFILL
                slot.pos = 0
                slot.prompt_idx = 0
                slot.next_token = int(req.tokens[0])
                continue
            t0 = time.perf_counter()
            owner = self._holds(slot.idx)
            try:
                if self._prefill_chunk is not None:
                    logits = self._chunked_prefill(slot, req, owner)
                else:
                    logits = None
                    if owner:
                        toks = torch.as_tensor(req.tokens, device=self.device)[None]
                        logits, sub = api.model_prefill(self._model_params(), self.cfg,
                                                        {"tokens": toks}, self.ctx,
                                                        spmd=self._mesh_ctx())
                        if self._paged and not self.pool.alloc_pages(slot.idx, req.prompt_len):
                            raise _PoolExhausted
                        self.pool.write_slot(slot.idx, sub)
                        logits = logits[0, -1]
                    self._prefill_tokens_computed += req.prompt_len
                    self._positions_computed += req.prompt_len
            except _PoolExhausted:
                self._abort_admission(slot, req)
                continue
            logits_row = self._share_prefill_logits(slot, logits)
            self._prefill_s += time.perf_counter() - t0
            self._n_prefills += 1
            if not np.isfinite(logits_row).all():
                self._finish(slot, FINISH_ERROR, error="non-finite prefill logits")
                continue
            slot.pos = req.prompt_len
            slot.prompt_idx = req.prompt_len
            tok = self._sample(slot, logits_row)
            self._push_token(slot, tok)
            if slot.req is not None:  # not finished at admission
                slot.state = GENERATE
                slot.next_token = tok

    def _admit_ragged(self, max_admissions: Optional[int] = None) -> None:
        """Token-budget admission of the mixed step: a request enters only
        while the step has free prefill segments left after the slots
        already mid-prompt (and within ``max_admissions``, the speculative
        round's verify budget). Admitted slots enter PREFILL with no
        compute; their prompts drain through the mixed step."""
        n_prefilling = sum(1 for s in self.slots if s.state == PREFILL)
        cap = max(0, self._ragged_segments - n_prefilling)
        if max_admissions is not None:
            cap = min(cap, max_admissions)
        plans = self.scheduler.plan_admissions(
            self.slots, stepped_prefill=False, page_gate=self._page_gate(), max_admissions=cap,
            batch_cap=self._batch_admission_cap())
        for slot, req in plans:
            self._start(slot, req)
            slot.state = PREFILL
            slot.pos = 0
            slot.prompt_idx = 0
            slot.next_token = 0
            if self._prefix_cache:
                m = self.pool.prefix_match(req.tokens)
                if m is not None:
                    key, entry = m
                    self.pool.overlay_resid_slot(slot.idx, self.pool.prefix_attach(slot.idx, key))
                    slot.prompt_idx = entry.n_tokens
                    slot.pos = entry.n_tokens

    def _abort_admission(self, slot: Slot, req: Request) -> None:
        """A gate-passed admission lost its pages before entering the batch:
        unwind it (pages released, request back to the queue front) instead
        of crashing; a later step's gate decides again."""
        self.pool.release(slot.idx)
        slot.req = None
        slot.state = FREE
        slot.generated = []
        self.scheduler.requeue(req)
        self.admission_aborts += 1

    def _holds(self, slot: int) -> bool:
        """Whether this rank holds the slot's cache rows (always, off a mesh)."""
        return self.mesh is None or self.pool.owns(slot)

    def _mesh_ctx(self) -> Optional[SH.ShardCtx]:
        """The context of a model call on this rank's rows and weight
        shards (None off a mesh)."""
        return self.spmd if self.mesh is not None else None

    def _share_prefill_logits(self, slot: Slot, logits: Optional[torch.Tensor]) -> np.ndarray:
        """The first token's logits row (V,) as a host array. Over a mesh
        only the data group holding the slot computed it (``logits`` is None
        elsewhere): it is broadcast over the data axis, so every rank
        samples the same token."""
        if self.mesh is None:
            return logits.float().cpu().numpy()
        buf = (logits.float().contiguous() if logits is not None
               else torch.empty((self.cfg.vocab,), dtype=torch.float32, device=self.device))
        return self.spmd.broadcast_rows(buf, self.pool.owner(slot.idx)).cpu().numpy()

    def _chunked_prefill(self, slot: Slot, req: Request, owner: bool = True
                         ) -> Optional[torch.Tensor]:
        """Ingest the prompt in fixed ``prefill_chunk`` pieces against the
        slot's working cache; returns the last-position logits row (None on
        a mesh rank that does not hold the slot: it only counts).

        With the prefix cache, the longest chunk-aligned cached prefix is
        restored first (shared pages attached, residual snapshot copied in)
        and only the remainder is computed; every chunk boundary prefilled
        here is registered for later requests."""
        tokens = req.tokens
        L, C = req.prompt_len, self._prefill_chunk
        start_tok = 0
        prefix = None
        if self._prefix_cache:
            m = self.pool.prefix_match(tokens)
            if m is not None:
                start_tok = m[1].n_tokens
                # shared prefix pages map first (logical pages 0..n), then
                # the suffix's own pages after them
                prefix = self.pool.prefix_attach(slot.idx, m[0])
        if self._paged:
            if not self.pool.alloc_pages(slot.idx, L):
                raise _PoolExhausted
            work = self.pool.read_slot(slot.idx)
            if prefix is not None:
                self.pool.overlay_resid(work, prefix)
        else:
            work = self.pool.fresh() if owner else None
        boundary_resids: Dict[int, Any] = {}
        logits = None
        off = start_tok
        params = self._model_params()
        while off < L:
            nv = min(C, L - off)
            if owner:
                chunk = np.zeros((1, C), np.int64)
                chunk[0, :nv] = tokens[off : off + nv]
                logits, work = self._chunk(params, work, chunk, off, nv)
            off += nv
            self._prefill_tokens_computed += nv
            self._positions_computed += C
            self._positions_wasted += C - nv
            if self._prefix_cache and off % C == 0:
                boundary_resids[off] = self.pool.snapshot_resid(work)
        if self._paged:
            self.pool.write_slot(slot.idx, work, start_page=start_tok // self.pool.page_size)
            if self._prefix_cache:
                self.pool.prefix_register(slot.idx, tokens, boundary_resids)
        elif owner:
            self.pool.write_slot(slot.idx, work)
        return logits[0] if owner else None

    # ------------------------------------------------------------------
    # Sampling / termination / preemption
    # ------------------------------------------------------------------

    def _sample(self, slot: Slot, logits_row: np.ndarray, index: Optional[int] = None) -> int:
        """The slot's token ``index`` of its output (default: the next one):
        argmax, or a draw from the generator of (seed, index)."""
        req = slot.req
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        seed = req.seed if req.seed is not None else req.uid
        probs = torch.softmax(torch.as_tensor(logits_row, dtype=torch.float64) / req.temperature, -1)
        gen = token_generator(seed, len(slot.generated) if index is None else index)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _push_token(self, slot: Slot, tok: int) -> None:
        """Record a sampled token; finish and free the slot if terminal."""
        req = slot.req
        slot.generated.append(tok)
        self.generated_tokens += 1
        if slot.first_token_step < 0:
            slot.first_token_step = self.step_count
        if req.stream is not None:
            req.stream(req.uid, tok)
        if tok == req.eos_id:
            self._finish(slot, FINISH_EOS)
        elif len(slot.generated) >= req.max_new_tokens:
            self._finish(slot, FINISH_LENGTH)

    def _finish(self, slot: Slot, reason: str, error: Optional[str] = None) -> None:
        """The one terminal path of a running slot, whatever the reason: its
        output (with the tokens so far), the slot freed, its pages released."""
        req = slot.req
        self.finished.append(RequestOutput(
            uid=req.uid,
            prompt=np.asarray(req.tokens),
            tokens=np.asarray(slot.generated, np.int64),
            finish_reason=reason,
            submitted_step=getattr(req, "_submitted_step", 0),
            admitted_step=slot.admitted_step,
            first_token_step=slot.first_token_step,
            finished_step=self.step_count,
            routed_frac=slot.routed_sum / slot.routed_steps if slot.routed_steps else float("nan"),
            mean_score=slot.score_sum / slot.score_steps if slot.score_steps else float("nan"),
            error=error,
        ))
        self._tally(reason)
        slot.req = None
        slot.state = FREE
        slot.generated = []
        if self._paged:
            self.pool.release(slot.idx)

    def _tally(self, reason: str) -> None:
        if reason == FINISH_EXPIRED:
            self._n_expired += 1
        elif reason == FINISH_CANCELLED:
            self._n_cancelled += 1
        elif reason == FINISH_ERROR:
            self._n_failed += 1

    def _finish_queued(self, req: Request, reason: str, error: Optional[str]) -> None:
        """The output of a request shed straight from the queue: never
        admitted, no slot, no tokens (``admitted_step == finished_step``,
        ``first_token_step == -1``)."""
        self.scheduler.drop(req)
        self.finished.append(RequestOutput(
            uid=req.uid,
            prompt=np.asarray(req.tokens),
            tokens=np.asarray([], np.int64),
            finish_reason=reason,
            submitted_step=getattr(req, "_submitted_step", 0),
            admitted_step=self.step_count,
            first_token_step=-1,
            finished_step=self.step_count,
            routed_frac=float("nan"),
            mean_score=float("nan"),
            error=error,
        ))
        self._n_shed += 1
        self._tally(reason)

    def _police(self) -> None:
        """The lifecycle sweep at the top of every step: cancelled and
        deadline-expired requests leave now. Queued ones are shed without
        prefill; running ones finish with their partial output through
        :meth:`_finish`. The clock is read at most once a sweep, and only
        when some request carries a deadline."""
        now = None

        def expired(r: Request) -> bool:
            nonlocal now
            t = getattr(r, "_deadline_t", None)
            if t is None:
                return False
            if now is None:
                now = self._clock()
            return now >= t

        for r in [r for r in self.scheduler.queue if r.cancelled or expired(r)]:
            if r.cancelled:
                self._finish_queued(r, FINISH_CANCELLED, None)
            else:
                self._finish_queued(r, FINISH_EXPIRED, "deadline expired while queued")
        for s in self.slots:
            if not s.active:
                continue
            if s.req.cancelled:
                self._finish(s, FINISH_CANCELLED)
            elif expired(s.req):
                self._finish(s, FINISH_EXPIRED, error=f"deadline expired at step {self.step_count}")

    def _step_prologue(self) -> None:
        """The head of every step path: the lifecycle sweep, then the
        scheduled faults (which fire against the swept state)."""
        self._police()
        if self._faults is not None:
            self._faults.on_step_start(self)

    def _step_epilogue(self, t0: float) -> None:
        """The tail of every step path: wall time, and one controller
        observation (queue depth and this step's latency) an engine step."""
        dt = time.perf_counter() - t0
        self._wall_s += dt
        if self._controller is not None:
            self._controller.observe(len(self.scheduler.queue), dt)

    def _host_logits(self, logits_np: np.ndarray, tap: bool = True) -> np.ndarray:
        """The hooks between a step's logits and sampling: ``logit_tap``
        sees them (padded and ragged steps), then the fault injector may
        poison a decoding slot's row."""
        if tap and self._logit_tap is not None:
            self._logit_tap(logits_np)
        if self._faults is not None:
            logits_np = self._faults.corrupt_logits(self, logits_np)
        return logits_np

    def _preempt(self, slot: Slot) -> None:
        """Page-pool OOM backstop: the slot's request goes back to the
        *front* of the queue with its pages released and restarts from
        scratch on re-admission (a sampled request's draws are keyed by token
        index, so its stream repeats; a ``stream`` callback sees the replay).
        A contiguous pool has no pages to release (a fault's preemption
        storm reaches it; the JAX engine raises there)."""
        req = slot.req
        if self._paged:
            self.pool.release(slot.idx)
        # modlint: disable=counter-decrement -- not a monotone counter here:
        # preemption restarts the request from scratch, so its tokens leave
        # the book and are re-counted on replay; net totals stay exact
        self.generated_tokens -= len(slot.generated)
        slot.req = None
        slot.state = FREE
        slot.generated = []
        self.scheduler.requeue(req)
        self.preemptions += 1

    def _youngest_active(self) -> Slot:
        return max((t for t in self.slots if t.active), key=lambda t: (t.admitted_step, t.idx))

    def _grow_pages(self, lookahead: int = 1) -> None:
        """Map each active slot's next ``lookahead`` write positions before
        the step (a speculative round maps its whole window up front), never
        past the slot's own budget (``total_len``) or ``ctx``; on pool
        exhaustion (free list empty, nothing evictable) preempt the
        youngest-admitted active slot and retry, so the oldest request
        always keeps making progress."""
        def upto(s: Slot) -> int:
            return min(s.pos + lookahead, s.req.total_len, self.ctx)

        while True:
            needy = [s for s in self.slots if s.active
                     and self.pool.pages_needed(upto(s)) > int(self.pool.n_mapped[s.idx])]
            for s in needy:
                if not self.pool.alloc_pages(s.idx, upto(s)):
                    self._preempt(self._youngest_active())
                    break  # re-scan: the victim may have been in `needy`
            else:
                return

    def _plan_segments(self) -> List[Tuple[Slot, int, int]]:
        """Greedy FCFS plan of the mixed step's prefill budget
        (``ragged_segments`` segments of ``prefill_chunk`` tokens): oldest
        mid-prompt slot first, several consecutive segments per slot allowed.
        Also maps every page the step writes (the planned prefill extent and
        each decoding slot's next row); on exhaustion the youngest active
        slot, possibly mid-prefill, is preempted and planning restarts."""
        C = self._prefill_chunk
        while True:
            segs: List[Tuple[Slot, int, int]] = []
            planned_end: Dict[int, int] = {}
            budget = self._ragged_segments
            for s in sorted((t for t in self.slots if t.state == PREFILL),
                            key=lambda t: (t.admitted_step, t.idx)):
                off, L = s.prompt_idx, s.req.prompt_len
                while budget > 0 and off < L:
                    nv = min(C, L - off)
                    segs.append((s, off, nv))
                    off += nv
                    budget -= 1
                if off > s.prompt_idx:
                    planned_end[s.idx] = off
                if budget <= 0:
                    break
            ok = True
            for s in self.slots:
                need = s.pos + 1 if s.state == GENERATE else planned_end.get(s.idx)
                if need is not None and not self.pool.alloc_pages(s.idx, need):
                    ok = False
                    break
            if ok:
                return segs
            self._preempt(self._youngest_active())

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.queue) or any(s.active for s in self.slots)

    def step(self) -> List[RequestOutput]:
        """Lifecycle sweep and faults + admit + one decode (or mixed) step +
        per-slot host update + one controller observation. Returns the
        requests that finished during this call."""
        done_before = len(self.finished)
        t0 = time.perf_counter()
        self._step_prologue()
        self.last_step_level = 0  # unless a step runs below
        advance = 1
        if self._speculate is not None:
            advance = self._step_speculative()
        elif self._ragged:
            self._step_ragged()
        else:
            self._admit()
            if self._paged:
                self._grow_pages()  # may preempt; must precede the active scan
            active_slots = [s for s in self.slots if s.active]
            if active_slots:
                self._decode(active_slots)
        self.step_count += advance
        self._step_epilogue(t0)
        self.scheduler.check_invariants(self.slots, len(self.finished))
        return self.finished[done_before:]

    def _decode_inputs(self, decode_slots: List[Slot]) -> Tuple[np.ndarray, ...]:
        """(tokens (B, 1), pos (B,) int32, active (B,)) of one decode step."""
        B = self.batch_size
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for s in decode_slots:
            tokens[s.idx, 0] = s.next_token
            pos[s.idx] = s.pos
            active[s.idx] = True
        return tokens, pos, active

    def _decode(self, active_slots: List[Slot]) -> None:
        t0 = time.perf_counter()
        step_fn = self._level_fn(self._step_level())
        inputs = self._decode_inputs(active_slots)
        if self.mesh is not None:  # this rank's rows
            r0, r1 = self.pool.row0, self.pool.row0 + self.pool.rows
            inputs = tuple(a[r0:r1] for a in inputs)
        tokens, pos, active = (torch.as_tensor(a, device=self.device) for a in inputs)
        params = self._model_params()
        if self._paged:
            table = self.pool.device_table()
            caches = self.pool.materialize(table)
            logits, caches, aux = step_fn(params, caches, tokens, pos, active)
            self.pool.writeback(caches, table, pos)
        else:
            logits, self.pool.caches, aux = step_fn(params, self.pool.caches, tokens, pos, active)
        if self.mesh is not None:
            logits, aux = self._gather_data(logits, aux)
        logits_np = self._host_logits(logits.float().cpu().numpy())
        aux_np = {k: v.float().cpu().numpy() for k, v in aux.items()}
        self._decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        B = self.batch_size
        self._positions_computed += B
        self._positions_wasted += B - len(active_slots)
        self._occupancy_sum += len(active_slots)
        self._advance(active_slots, logits_np, aux_np)

    def _gather_data(self, logits: torch.Tensor, aux: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Every data rank's decode rows, in slot order: the logits (B, V)
        and the per-sequence telemetry (B,) concatenated, scalar telemetry
        averaged (the groups hold equal row counts, so the mean of means is
        the batch mean)."""
        sp = self.spmd
        out = {}
        for k, v in aux.items():
            out[k] = sp.gather_rows(v.float()[None]).mean() if v.dim() == 0 else sp.gather_rows(v)
        return sp.gather_rows(logits), out

    def _advance(self, decode_slots: List[Slot], logits_np: np.ndarray,
                 aux_np: Dict[str, np.ndarray]) -> None:
        """Host update of the slots that decoded this step."""
        routed_np = aux_np.get("mod/decode_routed")
        scores_np = aux_np.get("mod/decode_scores")
        if "mod/decode_routed_frac" in aux_np:
            self._routed_frac_sum += float(aux_np["mod/decode_routed_frac"])
            self._routed_frac_steps += 1
        for s in decode_slots:
            if not np.isfinite(logits_np[s.idx]).all():
                # a poisoned row fails only its own request: rows couple
                # only through MoD *selection*, never through values
                self._finish(s, FINISH_ERROR, error=f"non-finite logits at step {self.step_count}")
                continue
            if routed_np is not None:
                s.routed_sum += float(routed_np[s.idx])
                s.routed_steps += 1
            if scores_np is not None:
                s.score = float(scores_np[s.idx])
                s.score_sum += s.score
                s.score_steps += 1
            s.pos += 1
            if s.state == PREFILL:
                s.prompt_idx += 1
                if s.prompt_idx < s.req.prompt_len:
                    s.next_token = int(s.req.tokens[s.prompt_idx])
                    continue
            tok = self._sample(s, logits_np[s.idx])
            self._push_token(s, tok)
            if s.req is not None:
                s.state = GENERATE
                s.next_token = tok

    def _step_ragged(self, admit: bool = True) -> None:
        """One mixed prefill+decode step. Each live segment replays the
        exact ``prefill_chunk`` call the padded path makes (same
        boundaries, same batch-1 cache state) on the slot's rows of the
        materialized caches; then decode runs on the updated caches, and one
        ragged write-back per paged leaf stores every produced row. Token
        streams equal the padded engine's whenever the decode batches do.
        ``admit=False``: the speculative round admitted already."""
        if admit:
            self._admit_ragged()
        segs = self._plan_segments()  # maps pages; may preempt mid-prefill
        active_slots = [s for s in self.slots if s.active]
        if not active_slots:
            return
        # prefill segments always run the full config (their boundaries
        # become cached, restorable state); only the decode rows degrade
        step_fn = self._level_fn(self._step_level())
        B, C = self.batch_size, self._prefill_chunk
        decode_slots = [s for s in self.slots if s.state == GENERATE]
        dev = self.device
        t0 = time.perf_counter()
        params = self._model_params()
        table = self.pool.device_table()
        caches = self.pool.materialize(table)
        seg_logits, seg_resid = [], []
        for s, start, nv in segs:
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :nv] = s.req.tokens[start : start + nv]
            sub = slot_slice(caches, s.idx)
            lg, _ = self._chunk(params, sub, chunk, start, nv)
            seg_logits.append(lg[0])
            # prefix boundaries land mid-step: later segments of the same
            # slot advance its rows, so snapshot now
            if self._prefix_cache and (start + nv) % C == 0:
                seg_resid.append(self.pool.snapshot_resid(sub))
            else:
                seg_resid.append(None)
        seg_logits_np = torch.stack(seg_logits).float().cpu().numpy() if segs else None
        t1 = time.perf_counter()
        self._prefill_s += t1 - t0

        dec_tokens, dec_pos, dec_act = self._decode_inputs(decode_slots)
        logits_np, aux_np = None, {}
        if decode_slots:
            # decode runs over every row and writes its caches in place; a
            # slot mid-prefill must not absorb that row (its cursor, its
            # ring entry, a MoD ring row if it won capacity), so its rows of
            # every leaf are saved before and put back after, before the
            # (quantizing) write-back reads them
            keep = [s.idx for s in self.slots if s.state == PREFILL]
            leaves = flatten(caches)
            idx = torch.as_tensor(keep, dtype=torch.int64, device=dev)
            saved = [leaf.index_select(0, idx) for leaf in leaves] if keep else []
            logits, caches, aux = step_fn(
                params, caches, *(torch.as_tensor(a, device=dev)
                                  for a in (dec_tokens, dec_pos, dec_act)))
            for leaf, rows in zip(leaves, saved):
                leaf.index_copy_(0, idx, rows)
            logits_np = self._host_logits(logits.float().cpu().numpy())
            aux_np = {k: v.float().cpu().numpy() for k, v in aux.items()}
            self.decode_steps += 1

        # write-back rows: the B decode rows (valid where a slot decoded),
        # then every live segment's C positions (valid below its length)
        w_slot = [np.arange(B)] + [np.full(C, s.idx) for s, _, _ in segs]
        w_pos = [dec_pos] + [st + np.arange(C) for _, st, _ in segs]
        w_valid = [dec_act] + [np.arange(C) < nv for _, _, nv in segs]
        self.pool.writeback_tokens(
            caches, table,
            torch.as_tensor(np.concatenate(w_slot).astype(np.int64), device=dev),
            torch.as_tensor(np.concatenate(w_pos).astype(np.int32), device=dev),
            torch.as_tensor(np.concatenate(w_valid), device=dev),
        )
        n_pf = sum(nv for _, _, nv in segs)
        self._prefill_tokens_computed += n_pf
        self._positions_computed += len(segs) * C + B
        self._positions_wasted += (len(segs) * C - n_pf) + (B - len(decode_slots))
        self._occupancy_sum += len(active_slots)

        # prefill slots: advance prompt progress, register every boundary a
        # segment completed, sample first tokens where a prompt completed
        # (from that slot's last segment's logits)
        last_seg: Dict[int, int] = {}
        for k, (s, start, nv) in enumerate(segs):
            s.prompt_idx = s.pos = start + nv
            last_seg[s.idx] = k
            if seg_resid[k] is not None:
                self.pool.prefix_register(s.idx, s.req.tokens, {start + nv: seg_resid[k]})
        for s in [t for t in self.slots if t.state == PREFILL and t.idx in last_seg]:
            if s.prompt_idx < s.req.prompt_len:
                continue  # over budget this step; continues next step
            self._n_prefills += 1
            row = seg_logits_np[last_seg[s.idx]]
            if not np.isfinite(row).all():
                self._finish(s, FINISH_ERROR, error="non-finite prefill-segment logits at step "
                                                    f"{self.step_count}")
                continue
            tok = self._sample(s, row)
            self._push_token(s, tok)
            if s.req is not None:
                s.state = GENERATE
                s.next_token = tok
        if decode_slots:
            self._advance(decode_slots, logits_np, aux_np)
        self._decode_s += time.perf_counter() - t1

    def _step_speculative(self) -> int:
        """One self-speculative round; returns the engine steps it advanced.

        Drafts ``n`` tokens per slot at the draft ratio, verifies the
        ``n+1``-token window at full capacity, accepts the longest prefix on
        which the host's sampled tokens agree with the drafts, and rolls the
        rejected tail back (residual snapshot restore + page truncation).
        Acceptance is batch-global: every slot advances by the same ``a`` =
        min over the slots, capped at the first in-window termination (EOS
        or token budget), so the batch's composition, and with it MoD
        ``batch_capacity`` routing, stays step for step the plain engine's.
        In ragged mode the round falls back to the mixed step while any
        prompt is still draining, so no slot is mid-prefill in a round."""
        n = self._speculate
        cap = self.scheduler.speculative_admission_cap(
            sum(1 for s in self.slots if s.active), n + 1)
        if self._ragged:
            self._admit_ragged(max_admissions=cap)
            if any(s.state == PREFILL for s in self.slots):
                self._step_ragged(admit=False)
                return 1
        else:
            self._admit(max_admissions=cap)
        # every verify position writes a KV row: map the window's pages up
        # front (capped at each slot's own budget)
        self._grow_pages(lookahead=n + 1)
        active_slots = [s for s in self.slots if s.active]
        if not active_slots:
            return 1
        t0 = time.perf_counter()
        B, dev = self.batch_size, self.device
        tokens, pos, active = self._decode_inputs(active_slots)
        limit = np.zeros((B,), np.int32)
        for s in active_slots:
            limit[s.idx] = min(s.req.total_len, self.ctx)
        tokens, pos, active, limit_t = (torch.as_tensor(a, device=dev)
                                        for a in (tokens, pos, active, limit))
        params = self._model_params()  # widened once a round
        table = self.pool.device_table()
        caches = self.pool.materialize(table)

        post_step = None
        if self.quant is not None:
            # after each step's own attention, its row goes through the
            # narrow dtype, so the next step attends to what a plain engine
            # reads back from its pages; positions past ctx match nothing
            ar = torch.arange(self.ctx, device=dev)

            def post_step(c, p):
                self.pool.quant_roundtrip(c, ar[None, :] == p[:, None])

        resid_ids = self.pool.spec.resid_ids

        def collect(c, p):
            # each step's rows, and clones of the residual leaves (the next
            # step overwrites them in place): the rollback's restore points
            leaves = flatten(c)
            return self.pool.collect_rows(c, p), [leaves[i].clone() for i in resid_ids]

        if self._fused:
            drafts, logits, aux, (rows, resids) = api.model_fused_window(
                params, self.cfg, caches, tokens, pos, active, n,
                collect=collect, post_step=post_step)
        else:
            drafts = api.model_draft_window(params, self._draft_cfg, caches, tokens, pos,
                                            active, n)
            feed = torch.cat([tokens[:, 0][None], drafts], dim=0)
            logits, aux, (rows, resids) = api.model_verify_window(
                params, self.cfg, caches, feed, pos, active,
                collect=collect, post_step=post_step)
        # one write of the whole window: row s*B + b is step s of slot b;
        # positions past a slot's mapped extent (min(total_len, ctx)) go to
        # the scratch page, and the accept cap discards their tokens
        offs = torch.arange(n + 1, device=dev)
        w_pos = (pos[None, :] + offs[:, None]).reshape(-1)
        w_valid = (active[None, :] & (pos[None, :] + offs[:, None] < limit_t[None, :])).reshape(-1)
        w_slot = torch.arange(B, device=dev).repeat(n + 1)
        self.pool.scatter_rows([r.reshape((-1,) + tuple(r.shape[2:])) for r in rows], table,
                               w_slot, w_pos, w_valid)
        drafts_np = drafts.cpu().numpy()  # (n, B)
        logits_np = self._host_logits(logits.float().cpu().numpy(), tap=False)  # (n+1, B, V)
        aux_np = {k: v.float().cpu().numpy() for k, v in aux.items()}
        self._decode_s += time.perf_counter() - t0

        # finiteness over the whole window: a poisoned row fails only its
        # own request, before it can pull the batch's acceptance down
        ok_slots = []
        for s in active_slots:
            if np.isfinite(logits_np[:, s.idx]).all():
                ok_slots.append(s)
            else:
                self._finish(s, FINISH_ERROR,
                             error=f"non-finite verify logits at step {self.step_count}")
        active_slots = ok_slots
        if not active_slots:
            # nothing accepted, nothing to roll back: the failed slots'
            # pages were released, and the pool's residual state is only
            # read again after a new admission resets its rows
            return 1

        # emitted token k+1 samples from the verify logits L_k, valid while
        # every earlier emitted token matched its draft; a sampled token k
        # draws from (seed, len(generated) + k), so a token sampled past the
        # cap is drawn again, identically, next round
        emitted: Dict[int, List[int]] = {}
        a = n + 1
        for s in active_slots:
            toks: List[int] = []
            c_s = n + 1
            for k in range(n + 1):
                e = self._sample(s, logits_np[k, s.idx], len(s.generated) + k)
                toks.append(e)
                if e == s.req.eos_id or len(s.generated) + k + 1 >= s.req.max_new_tokens:
                    c_s = k + 1  # in-window termination caps the batch
                    break
                if k < n and e != int(drafts_np[k, s.idx]):
                    c_s = k + 1  # draft mismatch: L_{k+1}.. are invalid
                    break
            emitted[s.idx] = toks
            a = min(a, c_s)

        routed_np = aux_np.get("mod/decode_routed")  # (n+1, B)
        scores_np = aux_np.get("mod/decode_scores")
        if "mod/decode_routed_frac" in aux_np:
            self._routed_frac_sum += float(aux_np["mod/decode_routed_frac"][:a].sum())
            self._routed_frac_steps += a
        self._occupancy_sum += len(active_slots) * a
        # the round computes n+1 verify positions a row, plus the n-step
        # draft when drafting is a separate pass; only the accepted tokens of
        # active rows carried real work
        self._positions_computed += self._spec_grid * B
        self._positions_wasted += self._spec_grid * B - a * len(active_slots)
        self.decode_steps += a

        for s in active_slots:
            for k in range(a):
                if routed_np is not None:
                    s.routed_sum += float(routed_np[k, s.idx])
                    s.routed_steps += 1
                if scores_np is not None:
                    s.score = float(scores_np[k, s.idx])
                    s.score_sum += s.score
                    s.score_steps += 1
                s.pos += 1
                self._push_token(s, emitted[s.idx][k])
                if s.req is None:
                    # the global cap puts any termination at k == a - 1
                    assert k == a - 1, (k, a)
                    break
                s.next_token = emitted[s.idx][k]

        # rollback: the residual leaves (MoD rings, cursors) to their state
        # after exactly a steps, and the rejected tail's pages released;
        # stale rows inside the last kept page are causally masked until the
        # accepted stream overwrites them
        for dst, snap in zip(self.pool.resid, resids):
            dst.copy_(snap[a - 1])
        for s in active_slots:
            if s.req is not None:  # finished slots are released already
                self.pool.truncate(s.idx, s.pos)

        self._spec_rounds += 1
        self._spec_drafted += n * len(active_slots)
        self._spec_accepted_drafts += (a - 1) * len(active_slots)
        self._spec_emitted += a
        return a

    def run(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        """Step until queue and slots drain; returns all finished outputs."""
        budget = max_steps if max_steps is not None else self._step_budget()
        while self.has_work:
            if budget <= 0:
                raise RuntimeError("serving engine exceeded its step budget")
            self.step()
            budget -= 1
        return self.finished

    def run_stream(self, requests: List[Request], arrival_every: int) -> List[RequestOutput]:
        """Submit one request every ``arrival_every`` engine steps (<= 0:
        everything upfront) and run to drain."""
        if arrival_every <= 0:
            for r in requests:
                self.submit(r)
            return self.run()
        budget = 4 * (sum(r.total_len for r in requests) + self.batch_size) + 64
        outputs: List[RequestOutput] = []
        submitted = 0
        while submitted < len(requests) or self.has_work:
            if budget <= 0:
                raise RuntimeError("serving engine exceeded its step budget")
            if submitted < len(requests) and submitted * arrival_every <= self.step_count:
                self.submit(requests[submitted])
                submitted += 1
            outputs.extend(self.step())
            budget -= 1
        return outputs

    def _step_budget(self) -> int:
        pending = list(self.scheduler.queue) + [s.req for s in self.slots if s.req is not None]
        return 4 * (sum(r.total_len for r in pending) + self.batch_size) + 64

    # ------------------------------------------------------------------
    # Convenience + telemetry
    # ------------------------------------------------------------------

    def generate(self, prompts: np.ndarray, n_tokens: int, temperature: float = 0.0,
                 seed: Optional[int] = None, eos_id: Optional[int] = None) -> np.ndarray:
        """Submit N requests, run to completion, return the (N, S0 + n_tokens)
        sequences (uid order; early-EOS rows padded)."""
        prompts = np.asarray(prompts)
        n, s0 = prompts.shape
        uids = {
            self.submit(Request(
                tokens=prompts[i], max_new_tokens=n_tokens, temperature=temperature,
                seed=None if seed is None else seed + i, eos_id=eos_id,
            ))
            for i in range(n)
        }
        outs = [o for o in self.run() if o.uid in uids]
        return pad_outputs(outs, s0 + n_tokens)

    def stats(self) -> Dict[str, Any]:
        steps = max(1, self.step_count)
        cb = self.pool.cache_bytes()
        out = {
            "steps": float(self.step_count),
            "decode_steps": float(self.decode_steps),
            "prefills": float(self._n_prefills),
            "generated_tokens": float(self.generated_tokens),
            "finished_requests": float(len(self.finished)),
            "wall_s": self._wall_s,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
            "tokens_per_s": self.generated_tokens / self._wall_s if self._wall_s else 0.0,
            "mean_occupancy": self._occupancy_sum / steps,
            "mean_routed_frac": (
                self._routed_frac_sum / self._routed_frac_steps
                if self._routed_frac_steps else float("nan")
            ),
            # per-leaf-kind byte split: kv_bytes shrinks under quantized KV
            # (narrow pages + f32 scales), resid_bytes never does
            "kv_cache_bytes": cb["total"],
            "kv_bytes": cb["kv_bytes"],
            "resid_bytes": cb["resid_bytes"],
            "quant_kv": self.quant.kv if self.quant is not None else "none",
            "prefill_tokens_computed": float(self._prefill_tokens_computed),
            "padded_token_fraction": (
                self._positions_wasted / self._positions_computed
                if self._positions_computed else 0.0
            ),
            "slot_scores": [s.score for s in self.slots],
            # partitioned routing: the slot groups, the model axis's ranks
            # and the global kb the scheduler counts against
            "data_shards": float(self.spmd.data_shards if self.spmd is not None else 1),
            "model_shards": float(self.spmd.model_shards if self.spmd is not None else 1),
            "routed_kb": (float(self.scheduler.routed_capacity)
                          if self.scheduler.routed_capacity is not None else float("nan")),
            # robustness counters (monotone, always present): shed counts
            # requests that left without a slot (queue drops and
            # backpressure rejections); the others count outputs by reason
            "shed": float(self._n_shed),
            "expired": float(self._n_expired),
            "cancelled": float(self._n_cancelled),
            "failed": float(self._n_failed),
        }
        if self._paged:
            out["preemptions"] = float(self.preemptions)
            out["admission_aborts"] = float(self.admission_aborts)
            out.update(self.pool.page_stats())
        if self._controller is not None:
            # steps that decoded degraded (the latency-tier exemption and
            # MoD-less configs keep this below the controller's count)
            out["degraded_decode_steps"] = float(self._degraded_decode_steps)
            out.update(self._controller.stats())
        if self._speculate is not None:
            out["speculative_rounds"] = float(self._spec_rounds)
            # drafted tokens the verifier accepted
            out["speculative_accept_rate"] = (
                self._spec_accepted_drafts / self._spec_drafted
                if self._spec_drafted else float("nan"))
            # engine steps a slot advances per round (1.0 = no gain; at most
            # speculate + 1)
            out["speculative_tokens_per_round"] = (
                self._spec_emitted / self._spec_rounds if self._spec_rounds else 0.0)
        return out
