"""Request/response types for the continuous-batching serving engine.

Port of ``repro/serve/request.py``. A :class:`Request` is one generation
job: a prompt, a token budget, and termination/sampling settings; the
engine returns a :class:`RequestOutput` with the generated tokens and
scheduling telemetry (admission wait, first token step, residency).

Every submitted request ends in exactly one :class:`RequestOutput`, even
one that never produced a token. Besides the success reasons (``eos`` /
``length``) there are three failure reasons: ``FINISH_EXPIRED`` (its
``deadline_s`` elapsed, while queued or mid-decode), ``FINISH_CANCELLED``
(:meth:`Request.cancel` or ``ServingEngine.cancel(uid)``) and
``FINISH_ERROR`` (the engine found a fault on this request, such as
non-finite logits; ``RequestOutput.error`` says what). ``priority``
selects the class: ``"latency"`` requests are admitted ahead of
``"batch"`` ones and always decode at full MoD capacity; ``"batch"``
requests absorb the capacity ladder's degradation under load
(:mod:`repro_torch.serve.overload`).

Sampling: temperature 0 is greedy argmax. A request with temperature > 0
draws token ``i`` from a generator seeded from ``(seed, i)``
(:func:`token_generator`; ``seed`` is the request's uid when unset), as
the JAX engine draws it from ``fold_in(key, i)``: the stream does not
depend on which other requests share the batch, and the same logits at
the same token index give the same token however often they are drawn.
torch cannot reproduce JAX's random bits, so sampled streams are not
comparable across the two packages; greedy streams are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

FINISH_EOS = "eos"  # sampled the request's eos_id
FINISH_LENGTH = "length"  # hit max_new_tokens
FINISH_ERROR = "error"  # engine-detected fault (RequestOutput.error says what)
FINISH_EXPIRED = "expired"  # deadline_s elapsed (queued or mid-decode)
FINISH_CANCELLED = "cancelled"  # client cancellation

# Priority classes (Request.priority).
PRIORITY_LATENCY = "latency"  # admitted first; always full MoD capacity
PRIORITY_BATCH = "batch"  # absorbs capacity degradation under overload


@dataclasses.dataclass
class Request:
    """tokens: prompt ids (S0,), S0 >= 1; max_new_tokens: decode budget
    (an eos token, if sampled, counts); eos_id: stop token (None = run to
    budget); temperature: 0 = greedy; seed: sampling stream of this
    request; enc_emb: encoder-decoder only, the request's precomputed
    encoder frame embeddings (S_enc, D), a numpy array or a tensor, which
    the engine runs through the encoder once at admission to fill the
    slot's cross-KV; stream: optional per-token callback ``(uid, token)``;
    priority: ``"latency"`` or ``"batch"`` (default); deadline_s: optional
    relative deadline in engine-clock seconds, counted from ``submit()``
    (an expired request ends ``FINISH_EXPIRED``: shed without prefill if
    still queued, with its partial output if running)."""

    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: Optional[int] = None
    enc_emb: Optional[Any] = None
    stream: Optional[Callable[[int, int], None]] = None
    uid: Optional[int] = None  # assigned by the engine at submit()
    priority: str = PRIORITY_BATCH
    deadline_s: Optional[float] = None
    cancelled: bool = False  # set by cancel(); honoured at the next step

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int64).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError("prompt must have at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.priority not in (PRIORITY_LATENCY, PRIORITY_BATCH):
            raise ValueError(
                f"priority must be {PRIORITY_LATENCY!r} or {PRIORITY_BATCH!r}, "
                f"got {self.priority!r}"
            )

    def cancel(self) -> None:
        """Client cancellation: the engine ends the request with
        ``FINISH_CANCELLED`` at its next step (a queued request is shed
        without prefill; a running one releases its pages and returns its
        partial output). Idempotent; a no-op once the request finished."""
        self.cancelled = True

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


def token_generator(seed: int, index: int) -> torch.Generator:
    """The generator token ``index`` of a request with sampling seed
    ``seed`` is drawn from: a fresh one, seeded by mixing the pair through
    numpy's ``SeedSequence``, so no draw depends on an earlier one."""
    hi, lo = np.random.SeedSequence([int(seed) % (1 << 64), int(index)]).generate_state(2)
    return torch.Generator().manual_seed((int(hi) << 32) | int(lo))


@dataclasses.dataclass
class RequestOutput:
    """A finished request: generated tokens + scheduling telemetry. Step
    indices count engine steps."""

    uid: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens (includes eos if sampled)
    finish_reason: str
    submitted_step: int
    admitted_step: int
    first_token_step: int
    finished_step: int
    routed_frac: float  # mean MoD routed fraction over its decode steps (NaN: MoD off)
    mean_score: float = float("nan")  # mean batch_capacity ranking score
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        """True iff the request ran to a normal termination: a success
        reason and no ``error`` (the engine sets one with every failure
        reason)."""
        return self.finish_reason in (FINISH_EOS, FINISH_LENGTH) and self.error is None

    @property
    def full_sequence(self) -> np.ndarray:
        return np.concatenate([self.prompt, self.tokens])

    @property
    def queue_steps(self) -> int:
        return self.admitted_step - self.submitted_step

    @property
    def residency_steps(self) -> int:
        return self.finished_step - self.admitted_step


def pad_outputs(outputs: List[RequestOutput], total_len: int, pad_id: int = 0) -> np.ndarray:
    """Stack full sequences (prompt + generated) into (N, total_len),
    right-padding early-terminated rows with ``pad_id`` (uid order)."""
    outputs = sorted(outputs, key=lambda o: o.uid)
    out = np.full((len(outputs), total_len), pad_id, np.int64)
    for i, o in enumerate(outputs):
        seq = o.full_sequence[:total_len]
        out[i, : seq.size] = seq
    return out
