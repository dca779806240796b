"""Pre-norm transformer block (dense MLP).

Port of ``repro/models/blocks.py``: ``block_apply`` (the full residual
block of the training forward), ``block_delta`` (the residual contribution
f(X̃) of paper Eq. 1), ``block_delta_fused`` (Eq. 1 end to end through the
fused routed-attention and routed-MLP kernels, the ``pallas_fused``
backend), ``block_prefill``, ``block_chunk`` and ``block_decode`` (against
a KV cache, updated in place). MoE blocks come with the MoE slice
(``models/api.py`` rejects the family).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels.swiglu import RoutedMlpSpec, routed_mlp_scatter
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


def block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Aux]:
    """The full residual block on a sequence without a cache."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    h = x + a
    return h + _ffn(p, h, cfg), {}


def block_delta(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Aux]:
    """f(X̃) in paper Eq. 1: attention + MLP contribution (no outer residual),
    on a sequence without a cache."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    m = _ffn(p, x + a, cfg)
    return a + m, {}


def fused_dispatch_supported(cfg: ModelConfig) -> bool:
    """Whether this config's routed blocks run the fused-dispatch mode:
    backend ``pallas_fused`` and 1-D positions (M-RoPE stays on the
    gather/scatter path in the JAX package). The JAX version's mesh
    conditions have no single-device counterpart."""
    return cfg.mod.backend == "pallas_fused" and cfg.attn.pos_emb in ("rope", "none")


def block_delta_fused(
    p: Params,
    x: torch.Tensor,  # (B, S, D) FULL residual stream
    positions: torch.Tensor,  # (B, S)
    decision,  # core.routing.RouteDecision (token_topk)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Aux]:
    """Paper Eq. 1 with fused dispatch: returns the full updated stream.
    Two kernels and no standalone dispatch pass: routed attention gathers,
    norms and attends the routed rows straight out of ``x``, and the routed
    MLP's epilogue performs ``x + P @ (gate·(a + m))``."""
    if "moe" in p:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP Queue 1, MoE + MoDE)")
    idx, gate = decision.idx, decision.gate
    pos_sub = torch.take_along_dim(positions, idx, dim=1)
    a_sub, h_sub = A.routed_self_attention(p["attn"], p["ln1"], x, idx, pos_sub, cfg)
    mp = {"ln": p["ln2"]["scale"], **p["mlp"]}
    out = routed_mlp_scatter(x, h_sub, a_sub, idx, gate, mp,
                             RoutedMlpSpec(act=cfg.act, eps=float(cfg.norm_eps)))
    return out, {}


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
