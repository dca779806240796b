"""Serving entry points: the one-token decode step and batch generation.

Port of ``repro/train/serve.py``. :func:`make_serve_step` returns the
one-token step; every family's decode routes through
:mod:`repro_torch.core.routing`'s ``batch_capacity`` strategy, where only
the top ``ratio·B`` scoring sequences run a routed block.
:func:`greedy_generate` is a thin single-batch client of
:class:`repro_torch.serve.ServingEngine`: it admits the whole prompt batch
at once and runs the engine to completion, so dense-family prompts prefill
in one shot and the first new token comes from the prefill's last-position
logits. It runs on CUDA unless the caller passes ``device="cpu"`` (the
parameters must live there).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import api
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import ServingEngine


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode step, ``(params, caches, token, pos) -> (logits,
    caches, aux)``; the caches are updated in place."""

    def serve_step(params, caches, token, pos):
        return api.model_decode(params, caches, cfg, token, pos)

    return serve_step


def greedy_generate(params: Any, cfg: ModelConfig, prompt: Any, n_tokens: int,
                    ctx: Optional[int] = None, temperature: float = 0.0,
                    seed: Optional[int] = None, device: DeviceLike = None) -> np.ndarray:
    """Autoregressive generation: the (B, S0 + n_tokens) token ids.

    All B prompts of ``prompt`` (B, S0) enter a B-slot engine together and
    run to their full budget. With ``temperature > 0`` row ``i`` samples
    from its own stream (``seed + i``; the row's uid when ``seed`` is None),
    so a row's draws do not depend on the others."""
    prompt = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor) else prompt)
    B, S0 = prompt.shape
    engine = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=ctx or (S0 + n_tokens)),
                           device=device)
    return engine.generate(prompt, n_tokens, temperature=temperature, seed=seed)
