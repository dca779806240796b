"""Mamba2 LM assembly with MoD routing: init, the training forward, caches
and decode.

Port of the Mamba2 half of ``repro/models/ssm_lm.py``: a stack of SSD
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
are updated in place. The Zamba2 hybrid is a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import router as R
from repro_torch.core import routing as ROUT
from repro_torch.device import torch_dtype
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


def make_cache(cfg: ModelConfig, batch: int, device: torch.device) -> Params:
    """Per-group decode states; routed layers keep a full-batch state too
    (a sequence's state advances only on the steps it is routed)."""
    n_groups, has_full, has_mod = group_structure(cfg)
    groups: List[Params] = []
    for _ in range(n_groups):
        g: Params = {}
        if has_full:
            g["full"] = SSM.init_ssm_cache(batch, cfg, device)
        if has_mod:
            g["mod"] = SSM.init_ssm_cache(batch, cfg, device)
        groups.append(g)
    return {"groups": groups}


def _decode_delta(p: Params, h: torch.Tensor, cache: Params, cfg: ModelConfig):
    return SSM.ssm_block_decode(p["ssm"], rmsnorm(p["ln"], h, cfg.norm_eps), cache, cfg)


def decode_step(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params, Aux]:
    """One step; caches are updated in place. Returns (logits (B, V), caches,
    aux); aux leaves are means over the routed groups (per-sequence entries
    keep their (B,))."""
    x = embed(params["embed"], token)  # (B, 1, D)
    aux_steps: List[Aux] = []
    for gp, gc in zip(params["groups"], caches["groups"]):
        if "full" in gp:
            d, new = _decode_delta(gp["full"], x, gc["full"], cfg)
            x = x + d
            for name, leaf in gc["full"].items():
                leaf.copy_(new[name])
        if "mod" in gp:
            def block_fn(h_sub, pos_sub, c_sub, decision, p=gp["mod"]["block"]):
                d, c = _decode_delta(p, h_sub, c_sub, cfg)
                return d, c, {}

            x, _, a = ROUT.route_decode(gp["mod"], x, gc["mod"], block_fn, cfg, active=active)
            aux_steps.append(a)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x)[:, 0], caches, T.mean_aux(aux_steps)
