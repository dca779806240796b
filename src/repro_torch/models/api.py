"""Family dispatcher: the entry points the trainer and the serving engine
call.

Port of ``repro/models/api.py`` for the ``dense`` family (the paper's
``mod-paper-*`` models, :mod:`repro_torch.models.transformer`) and the
``ssm`` family (Mamba2, :mod:`repro_torch.models.ssm_lm`). Other families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm_lm as SL
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "ssm")
_LATER = {
    "moe": "ROADMAP Queue 1, MoE + MoDE",
    "vlm": "ROADMAP Queue 1, enc-dec + VLM",
    "encdec": "ROADMAP Queue 1, enc-dec + VLM",
    "hybrid": "ROADMAP Queue 1, the Zamba2 hybrid",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({_LATER.get(cfg.family, 'ROADMAP Queue 1')})"
        )


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None, seed: int = 0) -> Params:
    """Random parameters on ``device`` (CUDA unless asked otherwise), drawn
    from ``generator`` or a fresh one seeded with ``seed``."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "ssm":
        return SL.init_lm(generator, cfg, dev)
    return T.init_lm(generator, cfg, dev)


def model_forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None, last_only: bool = False
                  ) -> Tuple[torch.Tensor, Aux]:
    """Teacher-forced forward. Returns (logits, aux)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return SL.forward(params, cfg, batch["tokens"], generator=generator, last_only=last_only)
    return T.forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                     positions=batch.get("positions"), generator=generator,
                     last_only=last_only)


def combine_losses(ce: torch.Tensor, aux: Aux, cfg: ModelConfig) -> torch.Tensor:
    """CE plus the router BCE (weighted) and the predictor BCE."""
    loss = ce
    if cfg.mod.enabled:
        if "mod/router_bce" in aux:
            loss = loss + cfg.mod.aux_loss_weight * aux["mod/router_bce"]
        if "mod/predictor_bce" in aux:
            loss = loss + aux["mod/predictor_bce"]  # detached inputs: trains the predictor only
    return loss


def model_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Aux]:
    """CE + the weighted aux losses, and the aux dict with ``ce`` and
    ``loss``: :func:`model_forward` -> cross-entropy -> :func:`combine_losses`
    for every family. batch: tokens, labels, optional loss_mask."""
    logits, aux = model_forward(params, cfg, batch, generator)
    ce = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    loss = combine_losses(ce, aux, cfg)
    aux = dict(aux)
    aux["ce"] = ce
    aux["loss"] = loss
    return loss, aux


def model_forward_ragged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                         row_offsets: torch.Tensor, seg_cap: int,
                         generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Aux]:
    """Flat-token ("ragged") forward: segments packed on one (T,) stream,
    delimited by ``row_offsets``, no per-sequence padding rows. For
    equal-length segments the logits match :func:`model_forward`'s.
    Returns (logits (T, V), aux)."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"ragged forward for family {cfg.family}: use the padded model_forward")
    return T.forward_ragged(params, cfg, tokens, row_offsets, seg_cap, generator=generator)


def make_caches(cfg: ModelConfig, batch: int, ctx: int, device: DeviceLike = None) -> Params:
    _check_family(cfg)
    if cfg.family == "ssm":
        return SL.make_cache(cfg, batch, resolve_device(device))
    return T.make_cache(cfg, batch, ctx, resolve_device(device))


def model_prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], ctx: int
                  ) -> Tuple[torch.Tensor, Params]:
    """Prompt pass that fills fresh (B, ctx) caches. Returns (logits, caches)."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(f"prefill for family {cfg.family} uses forward+decode")
    return T.prefill(params, cfg, batch["tokens"], positions=batch.get("positions"), ctx=ctx)


def model_prefill_chunk(params: Params, cfg: ModelConfig, caches: Params,
                        tokens: torch.Tensor, start: int, n_valid: int
                        ) -> Tuple[torch.Tensor, Params]:
    """One continuation-prefill chunk (B, C) against partly filled caches."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"chunked prefill for family {cfg.family}: prompts ingest via decode steps")
    return T.prefill_chunk(params, cfg, caches, tokens, int(start), int(n_valid))


def model_decode(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                 pos: torch.Tensor, active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Params, Aux]:
    """One decode step. ``active`` (B,) bool marks live rows so MoD
    ``batch_capacity`` routing never spends routed slots on padding."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return SL.decode_step(params, caches, cfg, token, active)
    return T.decode_step(params, caches, cfg, token, pos, active)
