"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""
from __future__ import annotations

from typing import List, Tuple

import torch


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale the gradients by ``min(1, max_norm / norm)``, the norm over all
    of them in f32; each comes back in its own dtype. Returns (grads, norm)."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    norm = torch.sqrt(torch.sum(torch.stack([s.to(sq[0].device) for s in sq])))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [(g.float() * scale.to(g.device)).to(g.dtype) for g in grads], norm
