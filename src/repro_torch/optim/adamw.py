"""Decoupled AdamW on parameter trees.

Port of ``repro/optim/adamw.py``: moments in f32 whatever the parameter
type, the update computed in f32 and cast back, bias correction by the
step ``count``, weight decay only on parameters with ``ndim >= 2`` (not on
norm scales, biases or routers). Unlike the JAX version, which returns new
trees, :func:`adamw_update` writes the parameters and moments in place
(under ``torch.no_grad``), so a step holds no second copy of the model;
each value is computed with the JAX expression's operations and roundings.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import OptimConfig
from repro_torch.utils import tree_leaves, tree_map

OptState = Dict[str, Any]


def adamw_init(params: Any) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt: OptState, cfg: OptimConfig, lr: float) -> OptState:
    """One AdamW step, in place on ``params`` and ``opt``; ``grads`` is a
    tree of the params' structure or a list in :func:`tree_leaves` order.
    ``lr`` is the f32 learning rate as a Python float."""
    count = opt["count"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    n = count.float()
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** n
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** n
    flat_p = tree_leaves(params)
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    c1, c2 = c1.to(flat_p[0].device), c2.to(flat_p[0].device)
    for p, g, m, v in zip(flat_p, flat_g, tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        g32 = g.float()
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p32
        p.copy_((p32 - lr * step).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    opt["count"] = count
    return opt
