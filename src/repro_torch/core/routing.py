"""Routed execution: route selection, dispatch and combine (paper Eq. 1).

Port of ``repro/core/routing.py``, single-device paths only:

    x_{l+1}[i] = x_l[i] + r_i * f(X̃)[i]   if i routed
    x_{l+1}[i] = x_l[i]                    otherwise

1. a :class:`RouteDecision` — which rows run the block and with what gate.
   ``token_topk`` (train / prefill): per-sequence expert-choice top-k over
   time, ``idx`` (B, k). ``batch_capacity`` (decode): the causal score
   ranks sequences and the top ``round(ratio·B)`` run the block, ``idx``
   (kb,).
2. :func:`execute_routed` — run the block's residual on the routed rows
   and gated scatter-add the result back, by ``MoDConfig.backend``:

   - ``"xla"`` and ``"pallas"``: gather -> block -> gated scatter-add,
     through the wrappers of kernels/routing.py (the CUDA kernels on the
     card, their plain versions on the CPU). The two JAX backends compute
     the same values, so here they share one path.
   - ``"pallas_fused"`` with a ``fused_block_fn`` (the training forward's
     routed blocks): no dispatch passes. The block gets the full stream and
     the decision and returns the full updated stream; the gather rides the
     routed-attention kernel and the gated combine the routed-MLP kernel
     (kernels/flash_attention.py, kernels/swiglu.py). Without a fused fn
     (prefill, chunked prefill) it falls back to gather/scatter, as in the
     JAX package.

   ``batch_capacity`` moves (kb, 1, D) rows and uses torch ops, as the JAX
   decode path uses no Pallas kernel.
3. :func:`routing_aux` — the router BCE, predictor BCE/accuracy and routing
   statistics that the training loss weights in (:func:`apply_mod`).

Indices are int64 throughout (torch's index type); their values equal
the JAX package's int32 indices. The JAX SPMD (``shard_map``) branches have
no counterpart yet: passing an SPMD context raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.kernels import routing as KR

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]

# block_delta_fn(x_sub, pos_sub) -> (delta_sub, aux)
BlockDeltaFn = Callable[[torch.Tensor, Optional[torch.Tensor]], Tuple[torch.Tensor, Aux]]
# fused_block_fn(x_full, decision, positions_full) -> (x_new_full, aux)
FusedBlockFn = Callable[..., Tuple[torch.Tensor, Aux]]
# block_fn(x_sub, pos_sub, caches_sub, decision) -> (delta, new_caches_sub, aux)
DecodeBlockFn = Callable[..., Tuple[torch.Tensor, Params, Aux]]

BACKENDS = ("xla", "pallas", "pallas_fused")


class RouteDecision(NamedTuple):
    """strategy: "token_topk" (idx (B, k)) or "batch_capacity" (idx (kb,));
    idx: routed rows, sorted ascending, unique, int64; gate: f32 router
    weight per routed row; mask: (B, S) / (B,) bool routed membership;
    logits: (B, S) f32 router logits (token_topk, for the aux losses);
    scores: (B,) causal ranking scores (batch_capacity)."""

    strategy: str
    idx: torch.Tensor
    gate: torch.Tensor
    mask: torch.Tensor
    logits: Optional[torch.Tensor] = None
    scores: Optional[torch.Tensor] = None


def _no_spmd(spmd: Any) -> None:
    if spmd is not None:
        raise NotImplementedError(
            "SPMD routed execution is not ported yet (ROADMAP Queue 1, multi-device)"
        )


# ---------------------------------------------------------------------------
# Route selection
# ---------------------------------------------------------------------------


def decide_tokens(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  generator: Optional[torch.Generator] = None, spmd: Any = None
                  ) -> RouteDecision:
    """Train/prefill strategy: expert-choice top-k over the sequence axis
    (``generator`` drives the stochastic-router control only)."""
    _no_spmd(spmd)
    k = cfg.mod.capacity(x.shape[1])
    logits = R.router_logits(params["router"], x)  # (B, S) f32
    idx, gate_logits, topk_mask = R.mod_select(logits, k, cfg.mod, generator)
    gate = R.apply_gate(gate_logits, cfg.mod)
    return RouteDecision("token_topk", idx, gate, topk_mask, logits)


def batch_capacity_k(cfg: ModelConfig, batch: int) -> int:
    """kb of the batch_capacity strategy: ``max(1, round(ratio·B))`` rows per
    decode step (0 when the ratio is 0: the pure residual-skip path)."""
    if cfg.mod.capacity_ratio <= 0.0:
        return 0
    return max(1, int(round(cfg.mod.capacity_ratio * batch)))


def decide_batch(
    params: Params,
    x: torch.Tensor,  # (B, 1, D) — one decode token per sequence
    cfg: ModelConfig,
    active: Optional[torch.Tensor] = None,  # (B,) bool — live serving slots
) -> RouteDecision:
    """Decode strategy: the top ``kb`` sequences by causal score (predictor,
    or the router itself) run the block this step. Inactive rows rank at
    ``-inf``, below every live row, so padding never takes routed capacity."""
    B = x.shape[0]
    kb = batch_capacity_k(cfg, B)
    if cfg.mod.sampling == "predictor" and "predictor" in params:
        scores = R.predictor_logits(params["predictor"], x)[:, 0]  # (B,)
    else:
        scores = R.router_logits(params["router"], x)[:, 0]
    ranking = scores if active is None else torch.where(
        active, scores, torch.full_like(scores, float("-inf")))
    idx = R.batch_select(ranking, kb)
    gate_logits = R.router_logits(params["router"], x)[:, 0]  # causal gate
    gate = R.apply_gate(gate_logits[idx], cfg.mod)
    routed = torch.zeros((B,), dtype=torch.bool, device=x.device)
    routed[idx] = True
    return RouteDecision("batch_capacity", idx, gate, routed, scores=scores)


# ---------------------------------------------------------------------------
# Dispatch / combine
# ---------------------------------------------------------------------------


def gather_positions(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Token-axis position gather. positions: (B, S); idx: (B, k)."""
    return torch.take_along_dim(positions, idx, dim=1)


def gather_batch(decision: RouteDecision, tree: Params) -> Params:
    """The routed sequences' rows of a cache dict (decode); copies."""
    return {name: leaf.index_select(0, decision.idx) for name, leaf in tree.items()}


def scatter_batch(decision: RouteDecision, tree: Params, sub: Params) -> Params:
    """Write updated routed-sequence rows back into a cache dict, in place."""
    for name, leaf in tree.items():
        leaf.index_copy_(0, decision.idx, sub[name])
    return tree


def execute_routed(
    decision: RouteDecision,
    x: torch.Tensor,  # (B, S, D) token_topk / (B, 1, D) batch_capacity
    block_delta_fn: BlockDeltaFn,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    fused_block_fn: Optional[FusedBlockFn] = None,
    spmd: Any = None,
) -> Tuple[torch.Tensor, Aux]:
    """Gather routed rows -> block residual -> gated scatter-add (Eq. 1);
    under ``pallas_fused`` with a ``fused_block_fn``, the block's fused
    kernels do all three."""
    _no_spmd(spmd)
    if cfg.mod.backend not in BACKENDS:
        raise ValueError(f"unknown MoD backend {cfg.mod.backend!r} (want one of {BACKENDS})")
    if decision.strategy == "token_topk":
        if cfg.mod.backend == "pallas_fused" and fused_block_fn is not None:
            return fused_block_fn(x, decision, positions)
        x_sub = KR.gather_rows(x, decision.idx)
        pos_sub = None if positions is None else gather_positions(positions, decision.idx)
        delta, aux = block_delta_fn(x_sub, pos_sub)
        return KR.scatter_add_rows(x, decision.idx, delta, decision.gate), aux
    if decision.strategy != "batch_capacity":
        raise ValueError(f"unknown routing strategy {decision.strategy!r}")
    x_sub = x.index_select(0, decision.idx)
    pos_sub = None if positions is None else positions.index_select(0, decision.idx)
    delta, aux = block_delta_fn(x_sub, pos_sub)
    update = (decision.gate[:, None, None] * delta.float()).to(x.dtype)
    return x.index_put((decision.idx,), update, accumulate=True), aux


# ---------------------------------------------------------------------------
# Aux losses / stats, and the train-time entry point
# ---------------------------------------------------------------------------


def routing_aux(decision: RouteDecision, params: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Aux:
    """Router BCE + stats (+ predictor BCE/acc) for a token_topk decision."""
    aux: Aux = {
        "mod/router_bce": R.router_aux_loss(decision.logits, decision.mask),
        "mod/frac_above_half": (torch.sigmoid(decision.logits) > 0.5).float().mean(),
        "mod/gate_mean": decision.gate.mean(),
    }
    if "predictor" in params:
        plogits = R.predictor_logits(params["predictor"], x)
        ploss, pacc = R.predictor_loss_and_acc(plogits, decision.mask)
        aux["mod/predictor_bce"] = ploss
        aux["mod/predictor_acc"] = pacc
    return aux


def apply_mod(
    params: Params,  # {"router": ..., "predictor"?: ..., "block": ...}
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    block_delta_fn: BlockDeltaFn,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    fused_block_fn: Optional[FusedBlockFn] = None,
    spmd: Any = None,
) -> Tuple[torch.Tensor, Aux]:
    """Train-time routed block: token top-k decision + routed execution,
    with the routing aux losses."""
    decision = decide_tokens(params, x, cfg, generator, spmd)
    out, inner_aux = execute_routed(decision, x, block_delta_fn, cfg, positions, fused_block_fn)
    aux: Aux = dict(inner_aux)
    aux.update(routing_aux(decision, params, x, cfg))
    return out, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_aux(decision: RouteDecision) -> Aux:
    """Per-step decode telemetry: the routed fraction, the (B,) routed mask
    and the (B,) causal scores the serving scheduler co-ranks slots with."""
    aux: Aux = {
        "mod/decode_routed_frac": decision.mask.float().mean(),
        "mod/decode_routed": decision.mask.float(),  # (B,)
    }
    if decision.scores is not None:
        aux["mod/decode_scores"] = decision.scores.float()  # (B,)
    return aux


def _exec_batch_capacity(
    decision: RouteDecision,
    x: torch.Tensor,  # (B, 1, D)
    caches: Params,
    block_fn: DecodeBlockFn,
    positions: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Params, Aux]:
    """Row gather -> block -> Eq. 1 gated combine, plus the cache-row gather
    and the in-place scatter of the routed rows' updated caches."""
    caches_sub = gather_batch(decision, caches)
    delta, new_caches_sub, inner = block_fn(
        x.index_select(0, decision.idx),
        None if positions is None else positions.index_select(0, decision.idx),
        caches_sub,
        decision,
    )
    update = (decision.gate[:, None, None] * delta.float()).to(x.dtype)
    out = x.index_put((decision.idx,), update, accumulate=True)
    return out, scatter_batch(decision, caches, new_caches_sub), inner


def route_decode(
    params: Params,
    x: torch.Tensor,  # (B, 1, D)
    caches: Params,
    block_fn: DecodeBlockFn,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    spmd: Any = None,
) -> Tuple[torch.Tensor, Params, Aux]:
    """Decode-time routed block: batch-capacity decision + routed execution.
    ``caches`` is updated in place (the routed rows only) and returned."""
    _no_spmd(spmd)
    decision = decide_batch(params, x, cfg, active)
    out, new_caches, inner_aux = _exec_batch_capacity(decision, x, caches, block_fn, positions)
    aux: Aux = dict(inner_aux)
    aux.update(decode_aux(decision))
    return out, new_caches, aux
