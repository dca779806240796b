"""MoD routers: expert-choice top-k selection and causal sampling scores.

Port of ``repro/core/router.py``. A per-block linear router emits a scalar
per token (f32); the top-k tokens (k = capacity) run the block, the rest
take the residual path (paper §3.2). Decode ranks sequences by the causal
predictor (or the router itself) instead (paper §3.5).

Ties: ``jax.lax.top_k`` breaks ties toward the lower index, and ties are
real here (identical prompts give identical decode scores; inactive slots
and padded chunk tails all rank at ``-inf``). ``torch.topk`` leaves the tie
order unspecified, so selection here is a *stable descending sort*, which
keeps equal scores in index order — the lower index first, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import MoDConfig, ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def init_router(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    # f32: a scalar per token whose scale gates the block output
    return {"w": dense_init(gen, cfg.d_model, (cfg.d_model,), torch.float32, device)}


def router_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """r_i = w^T x_i in f32. x: (B, S, D) -> (B, S)."""
    return torch.einsum("bsd,d->bs", x.float(), params["w"])


def init_predictor(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    h = cfg.mod.predictor_hidden
    return {
        "w1": dense_init(gen, cfg.d_model, (cfg.d_model, h), torch.float32, device),
        "b1": torch.zeros((h,), dtype=torch.float32, device=device),
        "w2": dense_init(gen, h, (h,), torch.float32, device),
    }


def predictor_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal top-k membership predictor on detached inputs."""
    h = torch.relu(x.detach().float() @ params["w1"] + params["b1"])
    return torch.einsum("bsh,h->bs", h, params["w2"])


def stable_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order), in descending score order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def mod_select(
    logits: torch.Tensor,  # (B, S) f32 router logits
    capacity: int,
    mod_cfg: MoDConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert-choice top-k selection.

    Returns ``idx`` (B, k) int64 sorted ascending (the routed sub-sequence
    keeps temporal order), ``gate`` (B, k) f32 router logits of the
    selected tokens, and ``topk_mask`` (B, S) bool."""
    B, S = logits.shape
    k = int(capacity)
    if mod_cfg.router_type != "learned":
        # the stochastic control of the paper's Fig. 3 is a training-time
        # experiment; serving routes with the learned router only
        raise NotImplementedError(f"router_type {mod_cfg.router_type!r}")
    idx = torch.sort(stable_topk_indices(logits, k), dim=-1).values
    gate = torch.take_along_dim(logits, idx, dim=-1)
    topk_mask = torch.zeros((B, S), dtype=torch.bool, device=logits.device)
    topk_mask.scatter_(1, idx, True)
    return idx, gate, topk_mask


def batch_select(scores: torch.Tensor, kb: int) -> torch.Tensor:
    """Batch-capacity selection: the top ``kb`` of (B,) scores, as sorted
    int64 row indices (ties to the lower row)."""
    return torch.sort(stable_topk_indices(scores, kb)).values


def apply_gate(gate_logits: torch.Tensor, mod_cfg: MoDConfig) -> torch.Tensor:
    """"raw" is the paper's Eq. 1; "sigmoid" a bounded variant."""
    if mod_cfg.gate == "sigmoid":
        return torch.sigmoid(gate_logits)
    return gate_logits

