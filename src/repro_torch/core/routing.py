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
   :func:`execute_routed_ragged` is the flat-token forward's dispatch
   (:func:`decide_tokens_ragged`: per-segment top-k over a packed
   ``(1, T, D)`` stream, flat ``idx`` with ``-1`` tails): every backend
   name goes through the ragged gather/scatter wrappers of
   kernels/ragged.py (the JAX ``pallas_fused`` has no ragged fused block
   and falls back to them too).
3. :func:`routing_aux` — the router BCE, predictor BCE/accuracy and routing
   statistics that the training loss weights in (:func:`apply_mod`).

Indices are int64 throughout (torch's index type); their values equal
the JAX package's int32 indices.

SPMD (a :class:`~repro_torch.distributed.sharding.ShardCtx` as ``spmd``):
``batch_capacity`` decode takes the *partitioned* semantics, the batch
split into ``data_shards`` contiguous groups that each route their own top
``round(ratio·B/d)`` rows (:func:`decide_batch`, :func:`route_decode`).
Without a mesh the groups are cut from the whole batch on one device; over
a mesh the model code holds this rank's rows only, which form one group,
so the decision, the cache-row gather and both scatters are local to the
shard (the JAX package's ``shard_map`` regions). ``token_topk`` is per
sequence, so :func:`decide_tokens` and :func:`execute_routed` compute the
single-device function on whatever rows they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.kernels import ragged as KRG
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
    """strategy: "token_topk" (idx (B, k)), "batch_capacity" (idx (kb,)) or
    "token_topk_ragged" (idx (n_seg, k) flat int32 rows, -1 past a short
    segment's end); idx: routed rows, sorted ascending, unique, int64
    (ragged: int32); gate: f32 router weight per routed row (0 at -1);
    mask: (B, S) / (B,) / flat (1, T) bool routed membership;
    logits: (B, S) f32 router logits (token_topk, for the aux losses);
    scores: (B,) causal ranking scores (batch_capacity)."""

    strategy: str
    idx: torch.Tensor
    gate: torch.Tensor
    mask: torch.Tensor
    logits: Optional[torch.Tensor] = None
    scores: Optional[torch.Tensor] = None


def _check_spmd(spmd: Any) -> None:
    if spmd is not None and not isinstance(spmd, ShardCtx):
        raise TypeError(f"spmd must be a repro_torch.distributed.sharding.ShardCtx, got "
                        f"{type(spmd).__name__}")


# ---------------------------------------------------------------------------
# Route selection
# ---------------------------------------------------------------------------


def decide_tokens(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  generator: Optional[torch.Generator] = None,
                  spmd: Optional[ShardCtx] = None) -> RouteDecision:
    """Train/prefill strategy: expert-choice top-k over the sequence axis
    (``generator`` drives the stochastic-router control only). Per
    sequence, so under a ``spmd`` context each rank's decision over its own
    rows is bitwise the single-device decision of those rows."""
    _check_spmd(spmd)
    k = cfg.mod.capacity(x.shape[1])
    logits = R.router_logits(params["router"], x)  # (B, S) f32
    idx, gate_logits, topk_mask = R.mod_select(logits, k, cfg.mod, generator)
    gate = R.apply_gate(gate_logits, cfg.mod)
    return RouteDecision("token_topk", idx, gate, topk_mask, logits)


def decide_tokens_ragged(params: Params, x: torch.Tensor, row_offsets: torch.Tensor,
                         cfg: ModelConfig, seg_cap: int,
                         generator: Optional[torch.Generator] = None) -> RouteDecision:
    """Segment-aware ``token_topk`` over a flat ``(1, T, D)`` stream.

    Each segment (one request's tokens between consecutive row offsets)
    gets the padded path's per-sequence selection: its router logits are
    windowed into a ``(n_seg, seg_cap)`` view with tails at ``-inf`` and
    :func:`~repro_torch.core.router.mod_select` runs on that (its stable
    sort ranks the ``-inf`` tails last, lower index first), so for
    equal-length segments the decision is the padded one. ``idx`` comes
    back as flat rows ``(n_seg, k)`` int32 with masked tail selections at
    ``-1`` (never a pointer into the next segment) and ``gate`` 0 there;
    ``mask`` and ``logits`` keep the flat ``(1, T)`` layout, so
    :func:`routing_aux` works unchanged."""
    T = x.shape[1]
    C = int(seg_cap)
    k_cap = cfg.mod.capacity(C)
    offs = row_offsets.to(device=x.device, dtype=torch.int64)
    lens = offs[1:] - offs[:-1]  # (n_seg,)
    logits_flat = R.router_logits(params["router"], x)  # (1, T) f32
    ar = torch.arange(C, device=x.device)
    win = (offs[:-1, None] + ar[None]).clamp(0, T - 1)
    valid = ar[None] < lens[:, None]
    wlogits = torch.where(valid, logits_flat[0][win], torch.full_like(win, float("-inf"),
                                                                      dtype=torch.float32))
    idx_l, gate_logits, _ = R.mod_select(wlogits, k_cap, cfg.mod, generator)
    gate = R.apply_gate(gate_logits, cfg.mod)
    sel_valid = torch.take_along_dim(valid, idx_l, dim=1)
    gate = torch.where(sel_valid, gate, torch.zeros_like(gate))
    idx = torch.where(sel_valid, offs[:-1, None] + idx_l, torch.full_like(idx_l, -1))
    mask = torch.zeros((T + 1,), dtype=torch.bool, device=x.device)
    mask[torch.where(idx >= 0, idx, T).flatten()] = True
    return RouteDecision("token_topk_ragged", idx.to(torch.int32), gate, mask[:T][None],
                         logits_flat)


def batch_capacity_k(cfg: ModelConfig, batch: int, data_shards: int = 1) -> int:
    """kb of the batch_capacity strategy, the rows routed per decode step:
    ``max(1, round(ratio·B))`` (0 when the ratio is 0: the pure
    residual-skip path). With a partitioned batch every one of the
    ``data_shards`` groups routes ``batch_capacity_k(cfg, B // d)`` of its
    own rows, so the *global* budget is ``d · kb_local`` — Python's
    ``round`` halves to even, so ratio 0.125 at ``B=8, d=2`` gives ``2 ·
    max(1, round(0.5)) = 2``. The serving scheduler counts against this
    same global number."""
    if cfg.mod.capacity_ratio <= 0.0:
        return 0
    if data_shards > 1:
        if batch % data_shards:
            raise ValueError(f"batch {batch} not divisible by data_shards={data_shards}")
        return data_shards * batch_capacity_k(cfg, batch // data_shards)
    return max(1, int(round(cfg.mod.capacity_ratio * batch)))


def capacity_ladder(cfg: ModelConfig, scales) -> Tuple[ModelConfig, ...]:
    """The degraded-capacity configs of the serving engine's capacity
    ladder (:class:`repro_torch.serve.overload.CapacityController`).

    ``scales`` is a strictly descending ladder of multipliers on
    ``cfg.mod.capacity_ratio`` starting at 1.0 (level 0). Each config
    differs from ``cfg`` in the ratio only, which changes no decode shape:
    the pool's caches are sized by the full config, a level only shrinks
    ``kb`` (:func:`batch_capacity_k`). A MoD-less config gets an
    all-identical ladder (only the engine's host-side budgets degrade)."""
    scales = tuple(float(s) for s in scales)
    if not scales or scales[0] != 1.0:
        raise ValueError(f"capacity ladder must start at 1.0, got {scales!r}")
    if any(not (0.0 < s <= 1.0) for s in scales):
        raise ValueError(f"capacity scales must lie in (0, 1], got {scales!r}")
    if any(b >= a for a, b in zip(scales, scales[1:])):
        raise ValueError(f"capacity scales must strictly descend, got {scales!r}")
    if not cfg.mod.enabled:
        return (cfg,) * len(scales)
    return tuple(
        dataclasses.replace(cfg, mod=dataclasses.replace(
            cfg.mod, capacity_ratio=cfg.mod.capacity_ratio * s))
        for s in scales
    )


def decide_batch(
    params: Params,
    x: torch.Tensor,  # (B, 1, D) — one decode token per sequence
    cfg: ModelConfig,
    active: Optional[torch.Tensor] = None,  # (B,) bool — live serving slots
    data_shards: int = 1,
) -> RouteDecision:
    """Decode strategy: the top ``kb`` sequences by causal score (predictor,
    or the router itself) run the block this step. Inactive rows rank at
    ``-inf``, below every live row of their group, so padding never takes
    routed capacity. ``data_shards > 1`` is the partitioned selection: each
    of ``d`` contiguous groups routes its top ``kb_local = round(ratio·B/d)``
    rows (:func:`~repro_torch.core.router.batch_select`)."""
    B = x.shape[0]
    kb = batch_capacity_k(cfg, B // data_shards if data_shards > 1 else B)
    if cfg.mod.sampling == "predictor" and "predictor" in params:
        scores = R.predictor_logits(params["predictor"], x)[:, 0]  # (B,)
    else:
        scores = R.router_logits(params["router"], x)[:, 0]
    ranking = scores if active is None else torch.where(
        active, scores, torch.full_like(scores, float("-inf")))
    idx = R.batch_select(ranking, kb, data_shards)
    gate_logits = R.router_logits(params["router"], x)[:, 0]  # causal gate
    gate = R.apply_gate(gate_logits[idx], cfg.mod)
    routed = torch.zeros((B,), dtype=torch.bool, device=x.device)
    routed[idx] = True
    return RouteDecision("batch_capacity", idx, gate, routed, scores=scores)


# ---------------------------------------------------------------------------
# Dispatch / combine
# ---------------------------------------------------------------------------


def gather_positions(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Token-axis position gather. positions: (B, S) or M-RoPE's (3, B, S);
    idx: (B, k)."""
    if positions.dim() == 3:
        return torch.take_along_dim(positions, idx[None].expand(3, -1, -1), dim=2)
    return torch.take_along_dim(positions, idx, dim=1)


def take_batch_positions(positions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batch-axis position gather. positions: (B, 1) or (3, B, 1); idx: (kb,)."""
    return positions.index_select(1 if positions.dim() == 3 else 0, idx)


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
    spmd: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, Aux]:
    """Gather routed rows -> block residual -> gated scatter-add (Eq. 1);
    under ``pallas_fused`` with a ``fused_block_fn``, the block's fused
    kernels do all three. Under ``spmd`` the rows are this rank's: the
    dispatch is local to the shard as it stands (the caller passes a fused
    fn only where ``blocks.fused_dispatch_supported`` allows one)."""
    _check_spmd(spmd)
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
    pos_sub = None if positions is None else take_batch_positions(positions, decision.idx)
    delta, aux = block_delta_fn(x_sub, pos_sub)
    update = (decision.gate[:, None, None] * delta.float()).to(x.dtype)
    return x.index_put((decision.idx,), update, accumulate=True), aux


def execute_routed_ragged(
    decision: RouteDecision,
    x: torch.Tensor,  # (1, T, D) flat token stream
    block_delta_fn: BlockDeltaFn,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,  # (1, T) int32
) -> Tuple[torch.Tensor, Aux]:
    """Eq. 1 over the flat stream: gather every segment's routed rows into
    one ``(n_seg, k, D)`` sub-tensor (zeros at ``-1``), run the block delta
    on it (segments as batch rows, the padded path's shapes; ``-1`` rows
    at position -1), and gated-scatter-add the result onto a fresh copy of
    the stream (``-1`` dropped). Every backend name runs the ragged
    dispatch kernels on the card and their plain versions on the CPU."""
    if decision.strategy != "token_topk_ragged":
        raise ValueError(f"execute_routed_ragged needs a token_topk_ragged decision, got "
                         f"{decision.strategy!r}")
    if cfg.mod.backend not in BACKENDS:
        raise ValueError(f"unknown MoD backend {cfg.mod.backend!r} (want one of {BACKENDS})")
    T = x.shape[1]
    idx = decision.idx
    pos_sub = None
    if positions is not None:
        pos_sub = torch.where(idx >= 0, positions[0][idx.long().clamp(0, T - 1)],
                              torch.full_like(idx, -1)).to(torch.int32)
    x_sub = KRG.ragged_gather_rows(x[0], idx)
    delta, aux = block_delta_fn(x_sub, pos_sub)
    return KRG.ragged_scatter_add_rows(x[0], idx, delta, decision.gate)[None], aux


# ---------------------------------------------------------------------------
# Aux losses / stats, and the train-time entry point
# ---------------------------------------------------------------------------


def routing_aux(decision: RouteDecision, params: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Aux:
    """Router BCE + stats (+ predictor BCE/acc) for a token_topk decision;
    means over the global batch in a training call on a mesh."""
    aux: Aux = {
        "mod/router_bce": R.router_aux_loss(decision.logits, decision.mask),
        "mod/frac_above_half": SH.global_mean((torch.sigmoid(decision.logits) > 0.5).float()),
        "mod/gate_mean": SH.global_mean(decision.gate),
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
    positions: torch.Tensor,  # (B, S) or (3, B, S)
    block_delta_fn: BlockDeltaFn,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    fused_block_fn: Optional[FusedBlockFn] = None,
    spmd: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, Aux]:
    """Train-time routed block: token top-k decision + routed execution,
    with the routing aux losses."""
    decision = decide_tokens(params, x, cfg, generator, spmd)
    out, inner_aux = execute_routed(decision, x, block_delta_fn, cfg, positions, fused_block_fn,
                                    spmd)
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
        None if positions is None else take_batch_positions(positions, decision.idx),
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
    spmd: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, Params, Aux]:
    """Decode-time routed block: batch-capacity decision + routed execution.
    ``caches`` is updated in place (the routed rows only) and returned.

    ``spmd`` with no mesh (``ShardCtx(data_shards=d)``): the partitioned
    decision over the whole batch, as on one device. Over a mesh
    (``spmd.spmd``): ``x``, ``caches``, ``positions`` and ``active`` are this
    rank's ``B/d`` rows, one group, so the rank routes its own top
    ``kb_local`` and gathers and scatters only cache rows it holds — the
    same function, row for row, as the single-device reference."""
    _check_spmd(spmd)
    shards = 1
    if spmd is not None and not spmd.spmd:
        # the clear ValueError, not batch_select's
        spmd.check_batch(x.shape[0])
        shards = spmd.data_shards
    decision = decide_batch(params, x, cfg, active, data_shards=shards)
    out, new_caches, inner_aux = _exec_batch_capacity(decision, x, caches, block_fn, positions)
    aux: Aux = dict(inner_aux)
    aux.update(decode_aux(decision))
    return out, new_caches, aux
