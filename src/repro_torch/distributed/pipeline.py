"""GPipe-style pipeline parallelism over a process group (neighbour
send/recv).

Port of ``repro/distributed/pipeline.py``, which maps the stages onto the
mesh's "pod" axis (``MeshConfig.pp_stages``) with ``shard_map`` and
``lax.ppermute``. Here every rank of ``group`` is one stage, holding its
own stage's parameters: microbatches stream through in the classic GPipe
fill-run-drain loop of ``n_micro + n_stages - 1`` ticks, each tick a
stage function on whatever microbatch is resident and one ring shift to
the next stage. The bubble fraction is ``(S-1)/(M+S-1)``.

Forward only, as the JAX function is used and tested.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
                     stage_params: Any, x_micro: torch.Tensor, group: Any) -> torch.Tensor:
    """Run ``x_micro`` (n_micro, B_mb, ...) through the stages of ``group``
    (stage i = group rank i). ``stage_fn(stage_params, x, stage)`` is this
    rank's stage, applied each tick to the microbatch on it (stage 0 takes
    microbatch ``t`` while any remain; the others what their predecessor
    sent the tick before). Returns the last stage's outputs in microbatch
    order, broadcast to every stage. ``x_micro`` is the same on every rank
    (only stage 0 reads it), and a stage's output has its input's shape."""
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        incoming = x_micro[min(t, n_micro - 1)] if stage == 0 else buf
        y = stage_fn(stage_params, incoming, stage)
        # the last stage collects microbatch t - (n_stages - 1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        buf = C.exchange(y, (stage + 1) % n_stages, (stage - 1) % n_stages, group)
    return C.broadcast(outs, n_stages - 1, group)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
