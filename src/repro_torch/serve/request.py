"""Request/response types for the continuous-batching serving engine.

Port of ``repro/serve/request.py`` for the padded engine. A
:class:`Request` is one generation job: a prompt, a token budget, and
termination/sampling settings; the engine returns a :class:`RequestOutput`
with the generated tokens and scheduling telemetry (admission wait, first
token step, residency).

Sampling: temperature 0 is greedy argmax. A request with temperature > 0
draws from its own ``torch.Generator`` seeded with ``seed`` (its uid when
unset), one draw per generated token, so its stream does not depend on
which other requests share the batch. The JAX engine keys its draws with
``jax.random.fold_in``, which torch cannot reproduce: sampled streams are
not comparable across the two packages, greedy streams are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

FINISH_EOS = "eos"  # sampled the request's eos_id
FINISH_LENGTH = "length"  # hit max_new_tokens
FINISH_ERROR = "error"  # engine-detected fault (RequestOutput.error says what)


@dataclasses.dataclass
class Request:
    """tokens: prompt ids (S0,), S0 >= 1; max_new_tokens: decode budget
    (an eos token, if sampled, counts); eos_id: stop token (None = run to
    budget); temperature: 0 = greedy; seed: sampling stream of this
    request; stream: optional per-token callback ``(uid, token)``."""

    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: Optional[int] = None
    stream: Optional[Callable[[int, int], None]] = None
    uid: Optional[int] = None  # assigned by the engine at submit()

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int64).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError("prompt must have at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


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
        return self.finish_reason in (FINISH_EOS, FINISH_LENGTH)

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
