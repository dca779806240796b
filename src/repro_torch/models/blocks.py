"""Pre-norm transformer block (dense or MoE MLP).

Port of ``repro/models/blocks.py``: ``block_apply`` (the full residual
block of the training forward), ``block_apply_ragged`` (the same block
over a flat ragged stream), ``block_delta``  (the residual contribution
f(X̃) of paper Eq. 1), ``block_delta_fused`` (Eq. 1 end to end through the
fused routed-attention and routed-MLP kernels, the ``pallas_fused``
backend), ``block_prefill``, ``block_chunk`` and ``block_decode`` (against
a KV cache, updated in place). A block built with ``use_moe`` holds the
token-choice MoE (:mod:`repro_torch.models.moe`) in place of the MLP; every
form returns the MoE's aux terms (``{}`` for a dense block).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels.routing import scatter_add_rows
from repro_torch.kernels.swiglu import RoutedMlpSpec, routed_mlp_scatter
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

Params = Dict[str, Dict[str, torch.Tensor]]
Aux = Dict[str, torch.Tensor]


def init_block(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
               use_moe: bool = False) -> Params:
    dtype = torch_dtype(cfg.dtype)
    p = {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(gen, cfg, device),
    }
    if use_moe:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg, device)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Aux]:
    hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
    if "moe" in p:
        return MOE.moe_mlp(p["moe"], hn, cfg)
    return mlp(p["mlp"], hn, cfg), {}


def block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Aux]:
    """The full residual block on a sequence without a cache."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    h = x + a
    m, aux = _ffn(p, h, cfg)
    return h + m, aux


def block_apply_ragged(p: Params, x: torch.Tensor, positions: torch.Tensor,
                       seg_id: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Aux]:
    """The full residual block over a flat ragged ``(1, T, D)`` stream:
    attention is segment-block-diagonal, the MLP pointwise."""
    a = A.ragged_self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                                seg_id, cfg)
    h = x + a
    m, aux = _ffn(p, h, cfg)
    return h + m, aux


def block_delta(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Aux]:
    """f(X̃) in paper Eq. 1: attention + MLP contribution (no outer residual),
    on a sequence without a cache."""
    a = A.self_attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cfg)
    m, aux = _ffn(p, x + a, cfg)
    return a + m, aux


def fused_dispatch_supported(cfg: ModelConfig, spmd=None) -> bool:
    """Whether this config's routed blocks run the fused-dispatch mode:
    backend ``pallas_fused`` and 1-D positions (M-RoPE stays on the
    gather/scatter path in the JAX package).

    Under a mesh (``spmd`` a ``ShardCtx`` with ``spmd.spmd``: the training
    forward passes the running call's) the fused kernels run on a rank's
    rows, which needs every dim they fuse over whole on the rank, so they
    fall back to gather/scatter when the model axis is split (heads and
    ``d_ff`` columns across ranks: the kernels have no reduction epilogue),
    under FSDP (JAX's rule: a rank's weights are fragments), and for MoE
    (its aux statistics are global over the batch), as in JAX."""
    if not (cfg.mod.backend == "pallas_fused" and cfg.attn.pos_emb in ("rope", "none")):
        return False
    if spmd is not None and spmd.spmd:
        if spmd.model_shards > 1 or spmd.fsdp:
            return False
        if cfg.family == "moe" or cfg.moe.enabled:
            return False
    return True


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
    MLP's epilogue performs ``x + P @ (gate·(a + m))``. MoE blocks fuse the
    attention half; the experts run on the routed rows and the
    ``scatter_add_rows`` kernel does the gated combine."""
    idx, gate = decision.idx, decision.gate
    pos_sub = torch.take_along_dim(positions, idx, dim=1)
    a_sub, h_sub = A.routed_self_attention(p["attn"], p["ln1"], x, idx, pos_sub, cfg)
    if "moe" in p:
        m, aux = MOE.moe_mlp(p["moe"], rmsnorm(p["ln2"], h_sub, cfg.norm_eps), cfg)
        return scatter_add_rows(x, idx, a_sub + m, gate), aux
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
    m, aux = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, aux


def block_chunk(p, x, positions, cache, cfg: ModelConfig,
                write_mask: Optional[torch.Tensor] = None, delta_only: bool = False):
    """Continuation-prefill block: attend over cache + chunk, then the MLP."""
    a, cache = A.chunk_self_attention(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cache, cfg, write_mask
    )
    h = x + a
    m, aux = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, aux


def block_decode(p, x, positions, cache, cfg: ModelConfig, delta_only: bool = False):
    a, cache = A.decode_attention(
        p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions, cache, cfg
    )
    h = x + a
    m, aux = _ffn(p, h, cfg)
    return ((a + m) if delta_only else (h + m)), cache, aux
