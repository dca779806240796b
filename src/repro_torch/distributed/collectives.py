"""The all-gather of the mesh engine, over ``torch.distributed`` groups.

NCCL takes CUDA tensors for every collective; gloo takes CPU tensors for
every collective but CUDA tensors only for broadcast and all-reduce. The
port's all-reduces and broadcasts therefore call ``torch.distributed``
directly, and every all-gather goes through :func:`all_gather`, which
stages a CUDA tensor over a gloo group (two ranks sharing one card, where
NCCL refuses to run) through the host explicitly: the tensor is copied to
the CPU, gathered there and copied back.

Results are the same on every rank of a group (a ring all-reduce hands
each rank the same reduced chunks), which the multi-controller engine
relies on: every rank runs the same routing decisions on the same values.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group: Any) -> bool:
    """Whether a collective other than broadcast / all-reduce on ``t`` has
    to go through the host: a CUDA tensor over a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in group
    rank order. A CUDA tensor over a gloo group is gathered on the host and
    copied back to its device."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src, group):
        host = src.cpu()
        parts: List[torch.Tensor] = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)
