"""Pre-norm transformer block (dense MLP): the forms the serving path runs.

Port of ``repro/models/blocks.py``: ``block_delta`` (the residual
contribution f(X̃) of paper Eq. 1), ``block_prefill``, ``block_chunk`` and
``block_decode`` (against a KV cache, updated in place). MoE blocks come
with the MoE slice (``models/api.py`` rejects the family).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

Params = Dict[str, Dict[str, torch.Tensor]]
Aux = Dict[str, torch.Tensor]


def init_block(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(gen, cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), cfg)


def block_delta(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Aux]:
    """f(X̃) in paper Eq. 1: attention + MLP contribution (no outer residual),
    on a sequence without a cache."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    m = _ffn(p, x + a, cfg)
    return a + m, {}


def block_prefill(p, x, positions, cache, cfg: ModelConfig,
                  write_mask: Optional[torch.Tensor] = None, delta_only: bool = False):
    a, cache = A.prefill_self_attention(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cache, cfg, write_mask
    )
    h = x + a
    m = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, {}


def block_chunk(p, x, positions, cache, cfg: ModelConfig,
                write_mask: Optional[torch.Tensor] = None, delta_only: bool = False):
    """Continuation-prefill block: attend over cache + chunk, then the MLP."""
    a, cache = A.chunk_self_attention(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cache, cfg, write_mask
    )
    h = x + a
    m = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, {}


def block_decode(p, x, positions, cache, cfg: ModelConfig, delta_only: bool = False):
    a, cache = A.decode_attention(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cache, cfg
    )
    h = x + a
    m = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, {}
