"""Gradient compression for the cross-replica reduction: int8 with error
feedback.

Port of ``repro/optim/compression.py``. Each leaf (plus its carried error)
is quantized to int8 against ONE scale that the ranks agree on by a MAX
all-reduce of a scalar (``max|g|/127 + 1e-12``), the int8 payload is summed
as int32 over the group, and the mean is ``qsum·scale/n``, in JAX's order
of operations, so the result and the new error are bitwise JAX's
``compressed_psum``. Error feedback (Seide et al., 2014) carries the
quantization residual into the next step.

The JAX train loop never reads ``OptimConfig.grad_compression`` (its
module docstring says it does), so the port's train step refuses
``"int8"`` rather than ignoring it; this module is the collective itself,
called directly over a process group.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded once, on every device: CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal, which is an ulp off
    for some ``t``; a 0-d tensor on ``t``'s device is divided by."""
    return t / torch.tensor(127.0, dtype=torch.float32, device=t.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale) of ``x`` against its own max."""
    x32 = x.float()
    scale = _div127(torch.max(torch.abs(x32))) + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(grads: List[torch.Tensor], group: Any, error: List[torch.Tensor]
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The int8-compressed mean of every leaf of ``grads`` over ``group``,
    with error feedback ``error`` (f32 leaves of the same shapes, from
    :func:`init_error_feedback`). Returns (mean grads in their dtypes, the
    new error)."""
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32)
    out, new_error = [], []
    for g, e in zip(grads, error):
        g32 = g.float() + e
        peak = torch.max(torch.abs(g32)).reshape(1)
        scale = _div127(C.all_reduce(peak, group, C.MAX)[0]) + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_error.append(g32 - q.float() * scale)
        qsum = C.all_reduce(q.to(torch.int32), group)
        avg = qsum.float() * scale / n.to(g.device)
        out.append(avg.to(g.dtype))
    return out, new_error


def init_error_feedback(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
