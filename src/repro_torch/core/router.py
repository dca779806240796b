"""MoD routers: expert-choice top-k selection, causal sampling scores and
their training losses.

Port of ``repro/core/router.py``. A per-block linear router emits a scalar
per token (f32); the top-k tokens (k = capacity) run the block, the rest
take the residual path (paper §3.2). Decode ranks sequences by the causal
predictor (or the router itself) instead (paper §3.5). Training adds the
router BCE against top-k membership and the predictor's BCE, with targets
and predictor inputs detached (JAX's ``stop_gradient``).

Ties: ``jax.lax.top_k`` breaks ties toward the lower index, and ties are
real here (identical prompts give identical decode scores; inactive slots
and padded chunk tails all rank at ``-inf``). ``torch.topk`` leaves the tie
order unspecified, so selection here is a *stable descending sort*, which
keeps equal scores in index order — the lower index first, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoDConfig, ModelConfig
from repro_torch.distributed import sharding as SH
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
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert-choice top-k selection.

    Returns ``idx`` (B, k) int64 sorted ascending (the routed sub-sequence
    keeps temporal order), ``gate`` (B, k) f32 router logits of the
    selected tokens, and ``topk_mask`` (B, S) bool. With
    ``router_type="stochastic"`` (the Gaussian control of the paper's
    Fig. 3) the selection ranks N(0, 1) draws from ``generator`` instead of
    the logits; the gates still come from the learned router. Its draws are
    not JAX's: the two frameworks' generators differ. A rank of a training
    call on a mesh draws the global batch's ``(B·d, S)`` noise and takes
    its own rows, so its selection is the single process's."""
    B, S = logits.shape
    k = int(capacity)
    if mod_cfg.router_type == "stochastic":
        if generator is None:
            raise ValueError("stochastic routing needs a generator")
        part, parts = SH.batch_rows()
        noise = torch.randn((B * parts, S), generator=generator, device=generator.device,
                            dtype=torch.float32)
        sel_scores = noise[part * B:(part + 1) * B].to(logits.device)
    elif mod_cfg.router_type == "learned":
        sel_scores = logits
    else:
        raise ValueError(f"unknown router_type {mod_cfg.router_type!r}")
    idx = torch.sort(stable_topk_indices(sel_scores, k), dim=-1).values
    gate = torch.take_along_dim(logits, idx, dim=-1)
    topk_mask = torch.zeros((B, S), dtype=torch.bool, device=logits.device)
    topk_mask.scatter_(1, idx, True)
    return idx, gate, topk_mask


def batch_select(scores: torch.Tensor, kb_local: int, data_shards: int = 1) -> torch.Tensor:
    """Partitioned batch-capacity selection: the top ``kb_local`` of (B,)
    scores *within each of ``data_shards`` contiguous batch groups* (ties
    to the lower row), as global int64 row indices sorted ascending.

    With ``data_shards == 1`` this is the plain top-k over the batch. With
    more, each group selects on its own, which is what each data rank of a
    mesh computes over its own rows (no cross-rank information, and a
    routed row's cache stays on its rank); the global budget is
    ``data_shards · kb_local``. Groups are contiguous, so the per-group
    sorted indices concatenate into a sorted vector."""
    if data_shards <= 1:
        return torch.sort(stable_topk_indices(scores, kb_local)).values
    B = scores.shape[0]
    if B % data_shards:
        raise ValueError(f"batch {B} not divisible by data_shards={data_shards}")
    bl = B // data_shards
    local = torch.sort(stable_topk_indices(scores.reshape(data_shards, bl), kb_local),
                       dim=-1).values  # (d, kb_local)
    offsets = torch.arange(data_shards, device=scores.device)[:, None] * bl
    return (local + offsets).reshape(-1)


def apply_gate(gate_logits: torch.Tensor, mod_cfg: MoDConfig) -> torch.Tensor:
    """"raw" is the paper's Eq. 1; "sigmoid" a bounded variant."""
    if mod_cfg.gate == "sigmoid":
        return torch.sigmoid(gate_logits)
    return gate_logits


def _bce(logits: torch.Tensor, topk_mask: torch.Tensor) -> torch.Tensor:
    targets = topk_mask.float()  # a bool mask carries no gradient
    return -SH.global_mean(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def router_aux_loss(router_logits_: torch.Tensor, topk_mask: torch.Tensor) -> torch.Tensor:
    """BCE(router logits, top-k membership): pushes sigmoid(r) above 0.5 for
    selected tokens and below for the rest (paper §3.5, method 1)."""
    return _bce(router_logits_, topk_mask)


def predictor_loss_and_acc(
    pred_logits: torch.Tensor, topk_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BCE + accuracy of the causal predictor (paper §3.5, method 2)."""
    acc = SH.global_mean(((pred_logits > 0) == topk_mask).float())
    return _bce(pred_logits, topk_mask), acc
