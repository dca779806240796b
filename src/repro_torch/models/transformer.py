"""Decoder-only LM assembly (dense, MoE and VLM backbones) with MoD routing:
init, the training forward, the flat ragged forward, caches, prefill,
chunked prefill and decode.

Port of ``repro/models/transformer.py``. The JAX package stacks layers
into groups for ``lax.scan``; here parameters and caches are per layer and
the scan is a Python loop over groups:

- MoD off:            one group per layer: {"full": block}
- MoD every=2 (paper): L//2 groups of {"full": block, "mod": routed block}
- MoD every=1:        one group per layer: {"mod": routed block}

``params["groups"]`` and ``caches["groups"]`` are lists of such dicts (a
routed entry is {"block", "router", "predictor"?}); an odd layer count adds
``params["tail"]``. MoD block KV caches are capacity-sized (``ratio·ctx``).
With ``cfg.uses_moe`` every block's MLP is the MoE; a full block's MoE aux
terms come back under ``full/`` (``tail/``), a routed block's unprefixed,
as the JAX package names them (the loss sums every ``*moe/lb_loss`` and
``*moe/z_loss``). Prefill, chunked prefill and decode drop them, as JAX's
do. The VLM backbone (``pos_emb="mrope"``) takes ``embeds`` (pre-merged
text and patch embeddings) and M-RoPE's ``(3, B, S)`` positions in
place of tokens; its decode step feeds text tokens, the three streams
equal.

Under a mesh (a ``spmd`` context, :mod:`repro_torch.distributed.sharding`)
prefill, chunked prefill and decode run on one rank's rows with its shards
of the weights: the embedding, attention, MLP, MoE and unembedding layers
make the model-axis collectives their weights' placement implies, and a
prefill sizes its caches to the rank's kv heads.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.core import routing as ROUT
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.ragged import flat_segment_ids
from repro_torch.models import attention as A
from repro_torch.models import blocks as BLK
from repro_torch.models.layers import (
    embed,
    init_embedding,
    init_rmsnorm,
    rmsnorm,
    unembed,
)

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]


def group_structure(cfg: ModelConfig) -> Tuple[int, bool, bool, int]:
    """(n_groups, has_full, has_mod, n_tail_full)."""
    L = cfg.n_layers
    if not cfg.mod.enabled:
        return L, True, False, 0
    if cfg.mod.every <= 1:
        return L, False, True, 0
    if cfg.mod.every != 2:
        raise ValueError("mod.every must be 1 or 2 (paper settings)")
    return L // 2, True, True, L % 2


def init_mod_wrap(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    p: Params = {
        "block": BLK.init_block(gen, cfg, device, cfg.uses_moe),
        "router": R.init_router(gen, cfg, device),
    }
    if cfg.mod.sampling == "predictor":
        p["predictor"] = R.init_predictor(gen, cfg, device)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """Parameters drawn from the same distributions as the JAX ``init_lm``
    (not the same values: the generators differ)."""
    n_groups, has_full, has_mod, n_tail = group_structure(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg, device),
        "final_norm": init_rmsnorm(cfg.d_model, torch_dtype(cfg.dtype), device),
    }
    groups: List[Params] = []
    for _ in range(n_groups):
        g: Params = {}
        if has_full:
            g["full"] = BLK.init_block(gen, cfg, device, cfg.uses_moe)
        if has_mod:
            g["mod"] = init_mod_wrap(gen, cfg, device)
        groups.append(g)
    params["groups"] = groups
    if n_tail:
        params["tail"] = BLK.init_block(gen, cfg, device, cfg.uses_moe)
    return params


# ---------------------------------------------------------------------------
# Training / teacher-forced forward
# ---------------------------------------------------------------------------


def _prefix(tag: str, aux: Aux) -> Aux:
    return {f"{tag}/{k}": v for k, v in aux.items()}


def _train_group(gp: Params, positions: torch.Tensor, cfg: ModelConfig, seed: Optional[int],
                 h: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
    """One layer group of the training forward (the JAX scan body). The
    stochastic router's generator is rebuilt here from ``seed``, so a
    recomputation under ``remat="full"`` draws the same selection."""
    aux: Aux = {}
    if "full" in gp:
        h, a = BLK.block_apply(gp["full"], h, positions, cfg)
        aux.update(_prefix("full", a))
    if "mod" in gp:
        mp = gp["mod"]
        gen = None if seed is None else torch.Generator(device=h.device).manual_seed(seed)

        def delta_fn(xs, ps):
            return BLK.block_delta(mp["block"], xs, ps, cfg)

        fused_fn = None
        if BLK.fused_dispatch_supported(cfg, SH.running()):
            def fused_fn(xf, decision, pf):
                return BLK.block_delta_fused(mp["block"], xf, pf, decision, cfg)

        h, a = ROUT.apply_mod(mp, h, positions, delta_fn, cfg, gen, fused_block_fn=fused_fn)
        aux.update(a)
    return h, aux


def _group_body(run, group_fn, gp, positions, cfg, seed, x):
    """One layer group under the running model call's mesh context
    (re-entered: a recomputation runs on autograd's threads), the group's
    FSDP leaves gathered here, inside the remat boundary: under
    ``remat="full"`` the recomputation gathers them again, and a rank
    holds one group's gathered weights at a time."""
    with SH.resumed(run):
        return group_fn(SH.gather_data(gp, SH.running()), positions, cfg, seed, x)


def mean_aux(aux_steps: List[Aux]) -> Aux:
    """Aux leaves averaged over the layer groups (axis 0 of the JAX scan's
    stacked aux): scalars stay scalar, per-sequence (B,) entries keep B."""
    if not aux_steps or not aux_steps[0]:
        return {}
    return {key: torch.stack([a[key] for a in aux_steps]).mean(dim=0) for key in aux_steps[0]}


_aten = torch.ops.aten
# products whose output the selective policy may keep; a product of batch
# extent 1 (the only batch an einsum over no batch dims lowers to) has no
# batch dims in JAX's sense
_MATMULS = (_aten.mm.default, _aten.addmm.default)
_BATCHED_MATMULS = (_aten.bmm.default, _aten.baddbmm.default)


def save_dots(ctx, func, *args, **kwargs):
    """The ``remat="selective"`` policy, JAX's
    ``dots_with_no_batch_dims_saveable``: keep the output of every matrix
    product with no batch dimension (``mm`` / ``addmm``, and ``bmm`` /
    ``baddbmm`` of batch 1: ``x @ w``, ``F.linear`` and an einsum such as
    ``bsd,df->bsf``), recompute everything else (attention's and the SSD's
    batched products, MoE's expert ``bmm`` over E, elementwise ops). A
    CUDA kernel of the port is a call the dispatcher never sees, so it is
    recomputed, as JAX recomputes a ``pallas_call``."""
    if func in _MATMULS or (func in _BATCHED_MATMULS and args[0].shape[0] == 1):
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _selective_contexts():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(save_dots)


REMAT_MODES = ("none", "full", "selective")


def run_groups(groups: List[Params], group_fn, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, Aux]:
    """The training forward's loop over layer groups (the JAX scan):
    ``group_fn(gp, positions, cfg, seed, h) -> (h, aux)`` per group, with
    one stochastic-router seed per group drawn from ``generator`` (a CPU
    generator). Under ``cfg.remat="full"`` each group is recomputed in the
    backward (``torch.utils.checkpoint``); under ``"selective"`` the
    recomputation keeps the products :func:`save_dots` saves. On an FSDP
    mesh each group's leaves are gathered as the group runs
    (:func:`_group_body`), so both recomputations gather them again.
    Returns (h, aux means over the groups)."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"remat {cfg.remat!r}: one of {REMAT_MODES}")
    stochastic = cfg.mod.enabled and cfg.mod.router_type == "stochastic"
    root = generator if generator is not None else torch.Generator().manual_seed(0)
    aux_steps: List[Aux] = []
    run = SH.current()  # the mesh context, re-entered by the recomputation
    for gp in groups:
        seed = int(torch.randint(0, 2**62, (1,), generator=root)) if stochastic else None
        body = partial(_group_body, run, group_fn, gp, positions, cfg, seed)
        if cfg.remat == "full":
            x, a = torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False)
        elif cfg.remat == "selective":
            x, a = torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False,
                                                     context_fn=_selective_contexts)
        else:
            x, a = body(x)
        aux_steps.append(a)
    return x, mean_aux(aux_steps)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """Full-sequence forward. Returns (logits (B, S, V), aux); aux leaves are
    means over the layer groups. ``generator`` (a CPU generator) seeds the
    stochastic router's draws, one seed per group; ``cfg.remat`` ("full",
    "selective") recomputes each group in the backward
    (:func:`run_groups`)."""
    x = embed(params["embed"], tokens) if embeds is None else embeds
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = _default_positions(B, S, x.device, cfg)
    x, aux = run_groups(params["groups"], _train_group, x, positions, cfg, generator)
    if "tail" in params:
        x, a = BLK.block_apply(params["tail"], x, positions, cfg)
        aux.update(_prefix("tail", a))
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


def forward_ragged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (T,) flat token stream
    row_offsets: torch.Tensor,  # (n_seg+1,) int32; row_offsets[-1] <= T
    seg_cap: int,  # every segment has <= seg_cap tokens
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Aux]:
    """Flat-token forward (the ``input_row_offsets`` layout): segments are
    packed back to back on one ``(T,)`` stream instead of padded ``(B, S)``
    rows. Attention is segment-block-diagonal
    (:func:`~repro_torch.models.blocks.block_apply_ragged`), MoD selection
    per segment (:func:`~repro_torch.core.routing.decide_tokens_ragged`),
    and the routed block sees segments as batch rows, so for equal-length
    segments every layer computes the padded path's function. Rows behind
    ``row_offsets[-1]`` are a masked padded tail (positions -1). The
    router aux losses read the stream as it was before the scatter.
    Returns (logits (T, V), aux)."""
    T = tokens.shape[0]
    x = embed(params["embed"], tokens[None])  # (1, T, D)
    offs = row_offsets.to(device=x.device, dtype=torch.int32)
    seg_id = flat_segment_ids(offs, T)
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    positions = torch.where(t < offs[-1], t - offs[seg_id.long()], -1)[None].to(torch.int32)
    stochastic = cfg.mod.enabled and cfg.mod.router_type == "stochastic"
    root = generator if generator is not None else torch.Generator().manual_seed(0)
    aux_steps: List[Aux] = []
    for gp in params["groups"]:
        seed = int(torch.randint(0, 2**62, (1,), generator=root)) if stochastic else None
        aux: Aux = {}
        if "full" in gp:
            x, a = BLK.block_apply_ragged(gp["full"], x, positions, seg_id, cfg)
            aux.update(_prefix("full", a))
        if "mod" in gp:
            mp = gp["mod"]
            gen = None if seed is None else torch.Generator(device=x.device).manual_seed(seed)
            decision = ROUT.decide_tokens_ragged(mp, x, offs, cfg, seg_cap, gen)

            def delta_fn(xs, ps, mp=mp):
                return BLK.block_delta(mp["block"], xs, ps, cfg)

            h_in = x
            x, a = ROUT.execute_routed_ragged(decision, x, delta_fn, cfg, positions)
            aux.update(a)
            aux.update(ROUT.routing_aux(decision, mp, h_in, cfg))
        aux_steps.append(aux)
    aux = mean_aux(aux_steps)
    if "tail" in params:
        x, a = BLK.block_apply_ragged(params["tail"], x, positions, seg_id, cfg)
        aux.update(_prefix("tail", a))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[0], aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, ctx: int, device: torch.device) -> Params:
    """Per-group KV caches: full blocks hold ``ctx`` entries, MoD blocks
    ``cfg.mod.capacity(ctx)``."""
    n_groups, has_full, has_mod, n_tail = group_structure(cfg)
    groups: List[Params] = []
    for _ in range(n_groups):
        g: Params = {}
        if has_full:
            g["full"] = A.init_kv_cache(batch, ctx, cfg, device)
        if has_mod:
            g["mod"] = A.init_kv_cache(batch, cfg.mod.capacity(ctx), cfg, device)
        groups.append(g)
    caches: Params = {"groups": groups}
    if n_tail:
        caches["tail"] = A.init_kv_cache(batch, ctx, cfg, device)
    return caches


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _mod_prefill_group(gp, h, positions, cache, cfg):
    decision = ROUT.decide_tokens(gp, h, cfg)

    def delta_fn(h_sub, pos_sub):
        delta, _, inner = BLK.block_prefill(gp["block"], h_sub, pos_sub, cache, cfg,
                                            delta_only=True)
        return delta, inner

    h, _ = ROUT.execute_routed(decision, h, delta_fn, cfg, positions)
    return h


def _default_positions(B: int, S: int, device: torch.device,
                       cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """0..S-1 per row: (B, S), or M-RoPE's three equal (3, B, S) streams."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    if cfg is not None and cfg.attn.pos_emb == "mrope":
        return pos[None].expand(3, B, S)
    return pos


def prefill(params: Params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None,
            ctx: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Teacher-forced pass (over ``tokens`` or ``embeds``) that also fills
    fresh caches. Returns (logits (B, S, V), caches)."""
    x = embed(params["embed"], tokens) if embeds is None else embeds
    B, S = x.shape[0], x.shape[1]
    ctx = ctx or cfg.max_seq_len
    if positions is None:
        positions = _default_positions(B, S, x.device, cfg)
    caches = make_cache(SH.running_cache_config(cfg), B, ctx, x.device)
    for gp, gc in zip(params["groups"], caches["groups"]):
        if "full" in gp:
            x, _, _ = BLK.block_prefill(gp["full"], x, positions, gc["full"], cfg)
        if "mod" in gp:
            x = _mod_prefill_group(gp["mod"], x, positions, gc["mod"], cfg)
    if "tail" in params:
        x, _, _ = BLK.block_prefill(params["tail"], x, positions, caches["tail"], cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), caches


# ---------------------------------------------------------------------------
# Chunked / continuation prefill
# ---------------------------------------------------------------------------


def _mod_chunk_group(gp, h, positions, cache, cfg):
    """Chunk-local token_topk: the router picks the top ``capacity(C)``
    tokens within this chunk, padded tail positions ranked at ``-inf`` and
    given a zero gate; routed tokens attend over the MoD ring."""
    k_cap = cfg.mod.capacity(h.shape[1])
    logits = R.router_logits(gp["router"], h)
    valid = positions >= 0
    idx, gate_logits, mask = R.mod_select(
        torch.where(valid, logits, torch.full_like(logits, float("-inf"))), k_cap, cfg.mod
    )
    gate = R.apply_gate(gate_logits, cfg.mod)
    gate = torch.where(torch.take_along_dim(valid, idx, dim=1), gate, torch.zeros_like(gate))
    decision = ROUT.RouteDecision("token_topk", idx, gate, mask)

    def delta_fn(h_sub, pos_sub):
        delta, _, _ = BLK.block_chunk(gp["block"], h_sub, pos_sub, cache, cfg, delta_only=True)
        return delta, {}

    h, _ = ROUT.execute_routed(decision, h, delta_fn, cfg, positions)
    return h


def prefill_chunk(params: Params, cfg: ModelConfig, caches: Params, tokens: torch.Tensor,
                  start: int, n_valid: int) -> Tuple[torch.Tensor, Params]:
    """One continuation-prefill step: ingest ``tokens[:, :n_valid]`` at
    positions ``start..start+n_valid`` against partly filled caches (updated
    in place). Returns (last-valid-position logits (B, V), caches)."""
    x = embed(params["embed"], tokens)
    B, C = tokens.shape
    ar = torch.arange(C, dtype=torch.int32, device=x.device)
    positions = torch.where(ar < n_valid, start + ar, torch.full_like(ar, -1))
    positions = positions[None].expand(B, C)
    for gp, gc in zip(params["groups"], caches["groups"]):
        if "full" in gp:
            x, _, _ = BLK.block_chunk(gp["full"], x, positions, gc["full"], cfg)
        if "mod" in gp:
            x = _mod_chunk_group(gp["mod"], x, positions, gc["mod"], cfg)
    if "tail" in params:
        x, _, _ = BLK.block_chunk(params["tail"], x, positions, caches["tail"], cfg)
    last = min(max(n_valid - 1, 0), C - 1)
    x = rmsnorm(params["final_norm"], x[:, last:last + 1], cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _mod_decode_group(gp, h, positions, cache, cfg, active=None, spmd=None):
    """Batch-capacity MoD decode: the top round(ratio·B) sequences route
    (per data group under ``spmd``)."""

    def block_fn(h_sub, pos_sub, cache_sub, decision):
        delta, c, _ = BLK.block_decode(gp["block"], h_sub, pos_sub, cache_sub, cfg,
                                       delta_only=True)
        return delta, c, {}

    return ROUT.route_decode(gp, h, cache, block_fn, cfg, positions, active, spmd)


def decode_step(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                pos: torch.Tensor, active: Optional[torch.Tensor] = None, spmd=None
                ) -> Tuple[torch.Tensor, Params, Aux]:
    """One autoregressive step; caches are updated in place. Returns
    (logits (B, V), caches, aux). Aux leaves are means over the routed
    groups: scalars stay scalar, per-sequence entries keep their (B,).

    ``spmd`` (a ``ShardCtx``) gives MoD decode the partitioned
    ``batch_capacity`` semantics. The JAX step downgrades an MoE model's
    context to ``semantic_only`` (its expert top-k cannot run inside a
    ``shard_map`` region); here no region exists: the MoE's dispatch
    groups are sequences, so a rank's rows run the same function either
    way and the context passes as it is."""
    x = embed(params["embed"], token)  # (B, 1, D)
    positions = pos.to(torch.int32)[:, None]
    if cfg.attn.pos_emb == "mrope":  # a text token: the three streams equal
        positions = positions[None].expand(3, -1, -1)
    aux_steps: List[Aux] = []
    for gp, gc in zip(params["groups"], caches["groups"]):
        if "full" in gp:
            x, _, _ = BLK.block_decode(gp["full"], x, positions, gc["full"], cfg)
        if "mod" in gp:
            x, _, a = _mod_decode_group(gp["mod"], x, positions, gc["mod"], cfg, active, spmd)
            aux_steps.append(a)
    aux = mean_aux(aux_steps)
    if "tail" in params:
        x, _, _ = BLK.block_decode(params["tail"], x, positions, caches["tail"], cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches, aux
