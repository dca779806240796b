"""SSM and hybrid LM assemblies with MoD routing: Mamba2 (pure SSD) and
the Zamba2-style hybrid; init, the training forward, caches and decode.

Port of ``repro/models/ssm_lm.py``. The Mamba2 LM is a stack of SSD
blocks with pre-norm residuals. MoD routes around SSD blocks as it routes
around attention+MLP blocks: the gathered sub-sequence runs the conv and
the SSD recurrence over the routed tokens only, so skipped tokens do not
enter that layer's state. As in :mod:`repro_torch.models.transformer`,
the JAX layer stack becomes a list of per-group dicts and ``lax.scan`` a
Python loop:

- MoD off:            one group per layer: {"full": layer}
- MoD every=2 (paper): L//2 groups of {"full": layer, "mod": routed layer}
- MoD every=1:        one group per layer: {"mod": routed layer}

A layer is {"ln", "ssm"}; a routed entry {"block": layer, "router",
"predictor"?}. The routed blocks run the gather/scatter dispatch under
every backend, as the JAX package falls back to it for them under
``pallas_fused`` (an SSD block has no fused routed kernel). Decode caches
are updated in place.

The Zamba2 hybrid runs ``n_layers`` Mamba2 layers in ``n_seg`` segments
of ``hybrid_attn_every``, with ONE weight-shared attention + MLP block
(``params["shared_attn"]``, dense, never routed) at every segment start;
each site keeps its own full-context KV cache (``caches["attn"][s]``).
The JAX ``(n_seg, n_pairs)`` stacks become ``params["groups"][s][p]``, a
list of segments, each a list of the layer groups above (``{"full",
"mod"}`` pairs with MoD every 2, ``{"full"}`` layers with MoD off); the
two nested scans become two loops, with aux means taken over the pairs of
a segment and then over the segments, as JAX's are.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.core import routing as ROUT
from repro_torch.device import torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import blocks as BLK
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed, init_embedding, init_rmsnorm, rmsnorm, unembed

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]


def group_structure(cfg: ModelConfig) -> Tuple[int, bool, bool]:
    """(n_groups, has_full, has_mod)."""
    L = cfg.n_layers
    if not cfg.mod.enabled:
        return L, True, False
    if cfg.mod.every <= 1:
        return L, False, True
    if cfg.mod.every != 2 or L % 2:
        raise ValueError("an SSM LM with MoD needs mod.every 1, or 2 with an even layer count")
    return L // 2, True, True


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    return {"ln": init_rmsnorm(cfg.d_model, torch_dtype(cfg.dtype), device),
            "ssm": SSM.init_ssm_block(gen, cfg, device)}


def init_ssm_mod_wrap(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    p: Params = {"block": _init_ssm_layer(gen, cfg, device),
                 "router": R.init_router(gen, cfg, device)}
    if cfg.mod.sampling == "predictor":
        p["predictor"] = R.init_predictor(gen, cfg, device)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """Pure-SSM LM (mamba2), from the JAX ``init_lm``'s distributions."""
    n_groups, has_full, has_mod = group_structure(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg, device),
        "final_norm": init_rmsnorm(cfg.d_model, torch_dtype(cfg.dtype), device),
    }
    groups: List[Params] = []
    for _ in range(n_groups):
        g: Params = {}
        if has_full:
            g["full"] = _init_ssm_layer(gen, cfg, device)
        if has_mod:
            g["mod"] = init_ssm_mod_wrap(gen, cfg, device)
        groups.append(g)
    params["groups"] = groups
    return params


def _ssm_delta(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return SSM.ssm_block(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps), cfg)


def _train_group(gp: Params, positions: torch.Tensor, cfg: ModelConfig, seed: Optional[int],
                 h: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
    """One layer group (the JAX scan body). The stochastic router's
    generator is rebuilt from ``seed``, so a recomputation under
    ``remat="full"`` draws the same selection."""
    aux: Aux = {}
    if "full" in gp:
        h = h + _ssm_delta(gp["full"], h, cfg)
    if "mod" in gp:
        mp = gp["mod"]
        gen = None if seed is None else torch.Generator(device=h.device).manual_seed(seed)

        def delta_fn(xs, ps):
            return _ssm_delta(mp["block"], xs, cfg), {}

        h, a = ROUT.apply_mod(mp, h, positions, delta_fn, cfg, gen)
        aux.update(a)
    return h, aux


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """Full-sequence forward. Returns (logits (B, S, V), aux); the group
    loop, remat and router seeds are the dense family's
    (:func:`repro_torch.models.transformer.run_groups`)."""
    x = embed(params["embed"], tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, aux = T.run_groups(params["groups"], _train_group, x, positions, cfg, generator)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


def make_cache(cfg: ModelConfig, batch: int, device: torch.device,
               heads: Optional[int] = None) -> Params:
    """Per-group decode states; routed layers keep a full-batch state too
    (a sequence's state advances only on the steps it is routed).
    ``heads``: a tensor-parallel rank's SSM heads (all by default)."""
    n_groups, has_full, has_mod = group_structure(cfg)
    groups: List[Params] = []
    for _ in range(n_groups):
        g: Params = {}
        if has_full:
            g["full"] = SSM.init_ssm_cache(batch, cfg, device, heads)
        if has_mod:
            g["mod"] = SSM.init_ssm_cache(batch, cfg, device, heads)
        groups.append(g)
    return {"groups": groups}


def _decode_delta(p: Params, h: torch.Tensor, cache: Params, cfg: ModelConfig):
    return SSM.ssm_block_decode(p["ssm"], rmsnorm(p["ln"], h, cfg.norm_eps), cache, cfg)


def _decode_group(gp: Params, gc: Params, x: torch.Tensor, cfg: ModelConfig,
                  active: Optional[torch.Tensor], spmd=None
                  ) -> Tuple[torch.Tensor, Optional[Aux]]:
    """One layer group's decode step (the JAX scan body), caches in place.
    Returns (h, the routed layer's aux or None)."""
    a = None
    if "full" in gp:
        d, new = _decode_delta(gp["full"], x, gc["full"], cfg)
        x = x + d
        for name, leaf in gc["full"].items():
            leaf.copy_(new[name])
    if "mod" in gp:
        def block_fn(h_sub, pos_sub, c_sub, decision, p=gp["mod"]["block"]):
            d, c = _decode_delta(p, h_sub, c_sub, cfg)
            return d, c, {}

        x, _, a = ROUT.route_decode(gp["mod"], x, gc["mod"], block_fn, cfg, active=active,
                                    spmd=spmd)
    return x, a


def _decode_groups(groups: List[Params], caches: List[Params], x: torch.Tensor,
                   cfg: ModelConfig, active: Optional[torch.Tensor], spmd=None
                   ) -> Tuple[torch.Tensor, Aux]:
    """The decode step's loop over layer groups; aux means over the routed ones."""
    aux_steps: List[Aux] = []
    for gp, gc in zip(groups, caches):
        x, a = _decode_group(gp, gc, x, cfg, active, spmd)
        if a is not None:
            aux_steps.append(a)
    return x, T.mean_aux(aux_steps)


def decode_step(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                active: Optional[torch.Tensor] = None, spmd=None
                ) -> Tuple[torch.Tensor, Params, Aux]:
    """One step; caches are updated in place. Returns (logits (B, V), caches,
    aux); aux leaves are means over the routed groups (per-sequence entries
    keep their (B,)). ``spmd``: partitioned MoD decode routing."""
    x = embed(params["embed"], token)  # (B, 1, D)
    x, aux = _decode_groups(params["groups"], caches["groups"], x, cfg, active, spmd)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches, aux


# ---------------------------------------------------------------------------
# Zamba2-style hybrid
# ---------------------------------------------------------------------------


def hybrid_segments(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_seg, seg): segments of ``hybrid_attn_every`` Mamba2 layers."""
    seg = cfg.hybrid_attn_every
    if seg <= 0 or cfg.n_layers % seg:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of hybrid_attn_every {seg}")
    return cfg.n_layers // seg, seg


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, bool]:
    """(n_seg, groups a segment, has_mod): MoD every 2 pairs a segment's
    layers as {full, mod} groups; MoD off keeps one {full} group a layer."""
    n_seg, seg = hybrid_segments(cfg)
    if not cfg.mod.enabled:
        return n_seg, seg, False
    if cfg.mod.every != 2 or seg % 2:
        raise ValueError("the hybrid with MoD needs mod.every 2 and an even hybrid_attn_every")
    return n_seg, seg // 2, True


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """Shared attention block + ``n_seg`` segments of Mamba2 layer groups,
    from the JAX ``init_hybrid``'s distributions (the full layers drawn
    before the routed ones, as its two key streams are)."""
    n_seg, n_groups, has_mod = _hybrid_layout(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg, device),
        "final_norm": init_rmsnorm(cfg.d_model, torch_dtype(cfg.dtype), device),
        "shared_attn": BLK.init_block(gen, cfg, device, use_moe=False),
    }
    full = [_init_ssm_layer(gen, cfg, device) for _ in range(n_seg * n_groups)]
    mods = [init_ssm_mod_wrap(gen, cfg, device) for _ in range(n_seg * n_groups)] if has_mod \
        else None
    groups: List[List[Params]] = []
    for s in range(n_seg):
        seg: List[Params] = []
        for p in range(n_groups):
            g: Params = {"full": full[s * n_groups + p]}
            if mods is not None:
                g["mod"] = mods[s * n_groups + p]
            seg.append(g)
        groups.append(seg)
    params["groups"] = groups
    return params


def _train_segment(shared: Params, seg: List[Params], positions: torch.Tensor,
                   cfg: ModelConfig, seed: Optional[int], h: torch.Tensor
                   ) -> Tuple[torch.Tensor, Aux]:
    """One segment (the JAX outer scan body): the shared block, then the
    segment's layer groups, each with a router seed drawn from ``seed``
    (so a recomputation under ``remat="full"`` draws the same ones)."""
    h, _ = BLK.block_apply(shared, h, positions, cfg)
    root = None if seed is None else torch.Generator().manual_seed(seed)
    aux_steps: List[Aux] = []
    for gp in seg:
        s = None if root is None else int(torch.randint(0, 2**62, (1,), generator=root))
        h, a = _train_group(gp, positions, cfg, s, h)
        aux_steps.append(a)
    return h, T.mean_aux(aux_steps)


def forward_hybrid(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """Full-sequence forward of the hybrid. Returns (logits (B, S, V), aux);
    ``cfg.remat="full"`` recomputes each segment (shared block included) in
    the backward, as JAX checkpoints its outer scan body."""
    x = embed(params["embed"], tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, aux = T.run_groups(params["groups"], partial(_train_segment, params["shared_attn"]), x,
                          positions, cfg, generator)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


def make_hybrid_cache(cfg: ModelConfig, batch: int, ctx: int, device: torch.device,
                      heads: Optional[int] = None) -> Params:
    """One full-context KV cache per shared-block site (``attn``, at
    ``cfg``'s kv heads) and the segments' SSM states (``groups``, laid out
    as the parameters; ``heads``: a tensor-parallel rank's SSM heads)."""
    n_seg, n_groups, has_mod = _hybrid_layout(cfg)
    groups: List[List[Params]] = []
    for _ in range(n_seg):
        seg: List[Params] = []
        for _ in range(n_groups):
            g: Params = {"full": SSM.init_ssm_cache(batch, cfg, device, heads)}
            if has_mod:
                g["mod"] = SSM.init_ssm_cache(batch, cfg, device, heads)
            seg.append(g)
        groups.append(seg)
    return {"attn": [A.init_kv_cache(batch, ctx, cfg, device) for _ in range(n_seg)],
            "groups": groups}


def decode_step_hybrid(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                       pos: torch.Tensor, active: Optional[torch.Tensor] = None, spmd=None
                       ) -> Tuple[torch.Tensor, Params, Aux]:
    """One step of the hybrid; caches are updated in place. Each segment
    runs the shared block against its site's KV cache at ``pos``, then its
    layer groups. Aux leaves are means over a segment's routed groups, then
    over the segments. ``spmd``: partitioned MoD decode routing."""
    x = embed(params["embed"], token)
    positions = pos.to(torch.int32)[:, None]
    aux_segs: List[Aux] = []
    for seg_p, seg_c, attn_c in zip(params["groups"], caches["groups"], caches["attn"]):
        x, _, _ = BLK.block_decode(params["shared_attn"], x, positions, attn_c, cfg)
        x, a = _decode_groups(seg_p, seg_c, x, cfg, active, spmd)
        aux_segs.append(a)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches, T.mean_aux(aux_segs)
