"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        total: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale the gradients by ``min(1, max_norm / norm)``, the norm over all
    of them in f32; each comes back in its own dtype. Returns (grads, norm).

    ``total`` sums the leaves' f32 square-sums into the global one; over a
    mesh each leaf's square-sum is summed over the axes that leaf is cut on
    and a replicated leaf is counted once
    (``repro_torch.train.loop.MeshLayout.total_square``)."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    if total is None:
        norm = torch.sqrt(torch.sum(torch.stack([s.to(sq[0].device) for s in sq])))
    else:
        norm = torch.sqrt(total(sq))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [(g.float() * scale.to(g.device)).to(g.dtype) for g in grads], norm
