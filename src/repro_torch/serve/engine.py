"""Continuous-batching serving engine over the MoD routing engine.

Port of ``repro/serve/engine.py::ServingEngine``, padded path: one
``(B, 1)`` decode step against a pooled ``(B, ctx)`` cache
(:class:`repro_torch.serve.cache.CachePool`), kept full by admitting queued
requests into slots as others terminate (:mod:`repro_torch.serve.scheduler`).

- **Batched prefill** (``prefill="auto"`` for the dense family): each
  admitted prompt runs through ``model_prefill`` at batch 1 (token_topk
  MoD routing, capacity-sized cache writes) — or chunk by chunk through
  ``model_prefill_chunk`` with ``prefill_chunk`` — its cache is copied
  into the slot, and the first new token comes from the prefill's
  last-position logits (the last prompt token is not re-decoded).
- **Stepped ingestion** (``prefill="step"``): the slot feeds one prompt
  token per engine step through the shared decode step.
- **Decode**: every step passes an ``active`` mask so padding rows never win
  ``batch_capacity`` routed rows, and reads back the per-sequence
  ``mod/decode_routed`` / ``mod/decode_scores`` telemetry.

Sampling runs on the host: greedy argmax, or one ``torch.Generator`` per
request (see :mod:`repro_torch.serve.request`). The JAX engine's paged,
ragged, speculative, quantized, SPMD and overload paths are later slices
(:class:`repro_torch.serve.config.EngineConfig` rejects their settings).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.routing import batch_capacity_k
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.serve.cache import CachePool
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.request import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    Request,
    RequestOutput,
    pad_outputs,
)
from repro_torch.serve.scheduler import FREE, GENERATE, PREFILL, Scheduler, Slot


def routed_capacity(cfg: ModelConfig, batch_size: int) -> Optional[int]:
    """kb of the batch_capacity router; None when MoD is off."""
    if not cfg.mod.enabled:
        return None
    return batch_capacity_k(cfg, batch_size)


class ServingEngine:
    """Continuous-batching decode over a fixed (batch_size, ctx) pool.

    ``params`` must live on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, params: Any, cfg: ModelConfig, engine: EngineConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['tok'].device}, the engine runs on {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.batch_size = engine.batch_size
        self.ctx = engine.ctx
        self._batch_prefill = engine.prefill in ("auto", "batch")
        if engine.prefill_chunk is not None and not self._batch_prefill:
            raise ValueError("prefill_chunk applies to batched prefill")
        self._prefill_chunk = engine.prefill_chunk
        self.pool = CachePool(cfg, self.batch_size, self.ctx, self.device)
        self.scheduler = Scheduler(self.batch_size, engine.policy,
                                   routed_capacity(cfg, self.batch_size))
        self.slots = [Slot(i) for i in range(self.batch_size)]
        self.finished: List[RequestOutput] = []
        self.step_count = 0
        self.generated_tokens = 0
        self.decode_steps = 0
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

    # ------------------------------------------------------------------
    # Submission and admission
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its uid."""
        if req.total_len > self.ctx:
            raise ValueError(f"request needs {req.total_len} positions but engine ctx is {self.ctx}")
        if req.uid is None:
            req.uid = self._uid
        elif req.uid in self._used_uids:
            raise ValueError(f"request uid {req.uid} already submitted")
        self._used_uids.add(req.uid)
        self._uid = max(self._uid, req.uid) + 1
        req._submitted_step = self.step_count  # type: ignore[attr-defined]
        self.scheduler.submit(req)
        return req.uid

    def _admit(self) -> None:
        plans = self.scheduler.plan_admissions(self.slots, stepped_prefill=not self._batch_prefill)
        for slot, req in plans:
            self.pool.reset(slot.idx)
            slot.req = req
            slot.generated = []
            slot.admitted_step = self.step_count
            slot.first_token_step = -1
            slot.routed_sum, slot.routed_steps = 0.0, 0
            slot.score, slot.score_sum, slot.score_steps = float("nan"), 0.0, 0
            slot.sampler = None
            if req.temperature > 0.0:
                seed = req.seed if req.seed is not None else req.uid
                slot.sampler = torch.Generator().manual_seed(int(seed))
            if not self._batch_prefill:
                slot.state = PREFILL
                slot.pos = 0
                slot.prompt_idx = 0
                slot.next_token = int(req.tokens[0])
                continue
            t0 = time.perf_counter()
            if self._prefill_chunk is not None:
                logits_row = self._chunked_prefill(slot, req)
            else:
                toks = torch.as_tensor(req.tokens, device=self.device)[None]
                logits, sub = api.model_prefill(self.params, self.cfg, {"tokens": toks}, self.ctx)
                self.pool.write_slot(slot.idx, sub)
                logits_row = logits[0, -1].float().cpu().numpy()
                self._prefill_tokens_computed += req.prompt_len
                self._positions_computed += req.prompt_len
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

    def _chunked_prefill(self, slot: Slot, req: Request) -> np.ndarray:
        """Ingest the prompt in fixed ``prefill_chunk`` pieces against a
        fresh batch-1 cache; returns the last-position logits row."""
        tokens = req.tokens
        L, C = req.prompt_len, self._prefill_chunk
        work = self.pool.fresh()
        logits = None
        off = 0
        while off < L:
            nv = min(C, L - off)
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :nv] = tokens[off : off + nv]
            logits, work = api.model_prefill_chunk(
                self.params, self.cfg, work, torch.as_tensor(chunk, device=self.device), off, nv
            )
            off += nv
            self._prefill_tokens_computed += nv
            self._positions_computed += C
            self._positions_wasted += C - nv
        self.pool.write_slot(slot.idx, work)
        return logits[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    # Sampling / termination
    # ------------------------------------------------------------------

    def _sample(self, slot: Slot, logits_row: np.ndarray) -> int:
        req = slot.req
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        probs = torch.softmax(torch.as_tensor(logits_row, dtype=torch.float64) / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=slot.sampler))

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
        slot.req = None
        slot.state = FREE
        slot.generated = []
        slot.sampler = None

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.queue) or any(s.active for s in self.slots)

    def step(self) -> List[RequestOutput]:
        """Admit + one decode step + per-slot host update. Returns the
        requests that finished during this call."""
        done_before = len(self.finished)
        t0 = time.perf_counter()
        self._admit()
        active_slots = [s for s in self.slots if s.active]
        if active_slots:
            self._decode(active_slots)
        self.step_count += 1
        self._wall_s += time.perf_counter() - t0
        self.scheduler.check_invariants(self.slots, len(self.finished))
        return self.finished[done_before:]

    def _decode(self, active_slots: List[Slot]) -> None:
        t0 = time.perf_counter()
        B = self.batch_size
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for s in active_slots:
            tokens[s.idx, 0] = s.next_token
            pos[s.idx] = s.pos
            active[s.idx] = True
        dev = self.device
        logits, self.pool.caches, aux = api.model_decode(
            self.params, self.pool.caches, self.cfg,
            torch.as_tensor(tokens, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(active, device=dev),
        )
        logits_np = logits.float().cpu().numpy()
        aux_np = {k: v.float().cpu().numpy() for k, v in aux.items()}
        self._decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self._positions_computed += B
        self._positions_wasted += B - len(active_slots)
        routed_np = aux_np.get("mod/decode_routed")
        scores_np = aux_np.get("mod/decode_scores")
        if "mod/decode_routed_frac" in aux_np:
            self._routed_frac_sum += float(aux_np["mod/decode_routed_frac"])
            self._routed_frac_steps += 1
        self._occupancy_sum += len(active_slots)

        for s in active_slots:
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
        return {
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
            "kv_cache_bytes": cb["total"],
            "prefill_tokens_computed": float(self._prefill_tokens_computed),
            "padded_token_fraction": (
                self._positions_wasted / self._positions_computed
                if self._positions_computed else 0.0
            ),
            "slot_scores": [s.score for s in self.slots],
        }
