"""Family dispatcher: the entry points the trainer and the serving engine
call.

Port of ``repro/models/api.py`` for the ``dense`` family (the paper's
``mod-paper-*`` models). Other families raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]

_LATER = {
    "moe": "ROADMAP Queue 1, MoE + MoDE",
    "vlm": "ROADMAP Queue 1, enc-dec + VLM",
    "encdec": "ROADMAP Queue 1, enc-dec + VLM",
    "ssm": "ROADMAP Queue 1, SSM + hybrid",
    "hybrid": "ROADMAP Queue 1, SSM + hybrid",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
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
    return T.init_lm(generator, cfg, dev)


def model_forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None, last_only: bool = False
                  ) -> Tuple[torch.Tensor, Aux]:
    """Teacher-forced forward. Returns (logits, aux)."""
    _check_family(cfg)
    return T.forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                     positions=batch.get("positions"), generator=generator,
                     last_only=last_only)


combine_losses = T.combine_losses


def model_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Aux]:
    """CE + weighted aux losses, and the aux dict with ``ce`` and ``loss``
    (the dense family's ``lm_loss``)."""
    _check_family(cfg)
    return T.lm_loss(params, cfg, batch, generator)


def model_forward_ragged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                         row_offsets: torch.Tensor, seg_cap: int,
                         generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Aux]:
    """Flat-token ("ragged") forward: segments packed on one (T,) stream,
    delimited by ``row_offsets``, no per-sequence padding rows. For
    equal-length segments the logits match :func:`model_forward`'s.
    Returns (logits (T, V), aux)."""
    _check_family(cfg)
    return T.forward_ragged(params, cfg, tokens, row_offsets, seg_cap, generator=generator)


def make_caches(cfg: ModelConfig, batch: int, ctx: int, device: DeviceLike = None) -> Params:
    _check_family(cfg)
    return T.make_cache(cfg, batch, ctx, resolve_device(device))


def model_prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], ctx: int
                  ) -> Tuple[torch.Tensor, Params]:
    """Prompt pass that fills fresh (B, ctx) caches. Returns (logits, caches)."""
    _check_family(cfg)
    return T.prefill(params, cfg, batch["tokens"], positions=batch.get("positions"), ctx=ctx)


def model_prefill_chunk(params: Params, cfg: ModelConfig, caches: Params,
                        tokens: torch.Tensor, start: int, n_valid: int
                        ) -> Tuple[torch.Tensor, Params]:
    """One continuation-prefill chunk (B, C) against partly filled caches."""
    _check_family(cfg)
    return T.prefill_chunk(params, cfg, caches, tokens, int(start), int(n_valid))


def model_decode(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                 pos: torch.Tensor, active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Params, Aux]:
    """One decode step. ``active`` (B,) bool marks live rows so MoD
    ``batch_capacity`` routing never spends routed slots on padding."""
    _check_family(cfg)
    return T.decode_step(params, caches, cfg, token, pos, active)
