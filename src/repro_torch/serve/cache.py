"""Contiguous KV-cache pool of the serving engine.

Port of ``repro/serve/cache.py::CachePool``: one cache tree of fixed shape
backs the whole engine, ``B`` slots by ``ctx`` positions
(:func:`repro_torch.models.api.make_caches`). MoD-block caches inside it
are capacity-sized (``ratio·ctx``), so the pool's footprint already holds
the paper's KV saving; :meth:`CachePool.cache_bytes` reports it. Every
leaf has the slot on axis 0, so the slot lifecycle is two in-place row
copies: :meth:`reset` (back to the empty state: cursors 0, positions -1)
and :meth:`write_slot` (a prefilled batch-1 cache enters the batch).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import api

Params = Dict[str, Any]


def _leaves(tree: Params, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for name, v in tree.items():
        path = f"{prefix}/{name}"
        if isinstance(v, dict):
            yield from _leaves(v, path)
        elif isinstance(v, list):
            for i, g in enumerate(v):
                yield from _leaves(g, f"{path}/{i}")
        else:
            yield path, v


class CachePool:
    """Fixed-shape (B, ctx) cache pool with per-slot reset/write."""

    def __init__(self, cfg: ModelConfig, batch_size: int, ctx: int, device: torch.device):
        self.cfg = cfg
        self.batch_size = batch_size
        self.ctx = ctx
        self.device = device
        self.caches = api.make_caches(cfg, batch_size, ctx, device)
        self._template = api.make_caches(cfg, 1, ctx, device)

    def fresh(self) -> Params:
        """An empty batch-1 cache tree (prefill writes into it in place)."""
        return api.make_caches(self.cfg, 1, self.ctx, self.device)

    def reset(self, slot: int) -> None:
        """Return the slot's cache rows to their initial (empty) state."""
        self.write_slot(slot, self._template)

    def write_slot(self, slot: int, sub_caches: Params) -> None:
        """Copy a batch-1 cache tree (same structure) into a slot's rows."""
        for (_, dst), (_, src) in zip(_leaves(self.caches), _leaves(sub_caches)):
            dst[slot].copy_(src[0])

    def cache_bytes(self) -> Dict[str, float]:
        """Pool footprint, split by routed ("mod") vs full-capacity leaves."""
        sizes = {"total": 0.0, "mod": 0.0, "full": 0.0}
        for path, leaf in _leaves(self.caches):
            b = float(leaf.numel() * leaf.element_size())
            sizes["total"] += b
            sizes["mod" if "/mod/" in path else "full"] += b
        sizes["mod_vs_full_ratio"] = sizes["mod"] / sizes["full"] if sizes["full"] else 0.0
        return sizes
