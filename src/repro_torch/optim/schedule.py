"""LR schedule (paper §3.6: cosine over the training steps, after a linear
warmup); port of ``repro/optim/schedule.py``, computed in f32."""
from __future__ import annotations

import math

import torch

from repro_torch.config import OptimConfig


def cosine_schedule(step, cfg: OptimConfig) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor), a 0-d f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(f32(math.pi) * t))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac
