"""Family dispatcher: the entry points the trainer and the serving engine
call.

Port of ``repro/models/api.py`` for the ``dense`` family (the paper's
``mod-paper-*`` models) and the ``moe`` family (token-choice MoE and both
MoDE variants), both :mod:`repro_torch.models.transformer`, and the
``ssm`` family (Mamba2, :mod:`repro_torch.models.ssm_lm`). Other families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm_lm as SL
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy
from repro_torch.utils import tree_map

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "moe", "ssm")
# families that run models/transformer.py
_TRANSFORMER = ("dense", "moe")
_LATER = {
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
    """CE plus the router BCE (weighted), the predictor BCE and every
    block's weighted MoE load-balance and router-z losses."""
    loss = ce
    if cfg.mod.enabled:
        if "mod/router_bce" in aux:
            loss = loss + cfg.mod.aux_loss_weight * aux["mod/router_bce"]
        if "mod/predictor_bce" in aux:
            loss = loss + aux["mod/predictor_bce"]  # detached inputs: trains the predictor only
    for k, v in aux.items():
        if k.endswith("moe/lb_loss"):
            loss = loss + cfg.moe.load_balance_weight * v
        elif k.endswith("moe/z_loss"):
            loss = loss + cfg.moe.router_z_weight * v
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
    equal-length segments the dense logits match :func:`model_forward`'s
    (MoE capacity buckets span the whole stream, as in JAX).
    Returns (logits (T, V), aux)."""
    _check_family(cfg)
    if cfg.family not in _TRANSFORMER:
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
    if cfg.family not in _TRANSFORMER:
        raise NotImplementedError(f"prefill for family {cfg.family} uses forward+decode")
    return T.prefill(params, cfg, batch["tokens"], positions=batch.get("positions"), ctx=ctx)


def model_prefill_chunk(params: Params, cfg: ModelConfig, caches: Params,
                        tokens: torch.Tensor, start: int, n_valid: int
                        ) -> Tuple[torch.Tensor, Params]:
    """One continuation-prefill chunk (B, C) against partly filled caches."""
    _check_family(cfg)
    if cfg.family not in _TRANSFORMER:
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


# ---------------------------------------------------------------------------
# Self-speculative windows
# ---------------------------------------------------------------------------

Collect = Callable[[Params, torch.Tensor], Any]
PostStep = Callable[[Params, torch.Tensor], Any]


def _stack(steps: List[Any]) -> Any:
    """Per-step outputs (tensors in dicts, lists and tuples) stacked on a new
    leading axis, as ``lax.scan`` stacks its ``ys``."""
    first = steps[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(steps)
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([s[i] for s in steps]) for i in range(len(first)))
    return first  # () and other constants


def _window_step(params, cfg, caches, t, p, active, collect, post_step):
    """One in-window decode step (caches in place), then the hooks."""
    logits, caches, aux = model_decode(params, caches, cfg, t, p, active)
    if post_step is not None:
        post_step(caches, p)
    extra = collect(caches, p) if collect is not None else ()
    return logits, aux, extra


def model_draft_window(params: Params, cfg: ModelConfig, caches: Params, token: torch.Tensor,
                       pos: torch.Tensor, active: Optional[torch.Tensor], n: int
                       ) -> torch.Tensor:
    """Self-speculative draft pass: ``n`` chained greedy decode steps; step
    ``j`` feeds the previous step's argmax at ``pos + j``. Returns the
    (n, B) drafts ``d_1..d_n``. ``cfg`` is normally the serving config with
    ``mod.capacity_ratio`` set to the draft ratio (0.0: ``batch_capacity_k``
    is 0 and every routed block is a residual skip).

    The port's decode step writes caches in place, so the drafter runs on a
    clone of ``caches``: the caller's tree (which may hold the paged pool's
    own residual tensors) is left bitwise unchanged, as JAX's scan leaves
    its input untouched."""
    c = tree_map(lambda t: t.clone(), caches)
    t, drafts = token, []
    for j in range(n):
        logits, c, _ = model_decode(params, c, cfg, t, pos + j, active)
        nxt = torch.argmax(logits, dim=-1)
        drafts.append(nxt)
        t = nxt[:, None]
    return torch.stack(drafts)


def model_verify_window(params: Params, cfg: ModelConfig, caches: Params, feed: torch.Tensor,
                        pos: torch.Tensor, active: Optional[torch.Tensor],
                        collect: Optional[Collect] = None, post_step: Optional[PostStep] = None
                        ) -> Tuple[torch.Tensor, Aux, Any]:
    """Full-capacity verify pass over a speculative window ``feed`` (n+1, B)
    = [current token, d_1..d_n]: ``n+1`` chained decode steps (not one
    chunk forward: MoD ``batch_capacity`` ranks batch rows per step, and
    the capacity rings advance one conditional append per step, so only
    the decode step itself reproduces the plain engine's computation).

    ``caches`` is updated in place, as by :func:`model_decode`. After each
    step ``post_step(caches, positions)`` may rewrite the caches in place
    (the quantized engine round-trips the step's row), then
    ``collect(caches, positions)`` extracts what the caller keeps of that
    step. Returns per-step stacks: logits (n+1, B, V), aux (each leaf with a
    leading n+1 axis) and the collected outputs."""
    logits, aux, extra = [], [], []
    for j in range(feed.shape[0]):
        lg, a, e = _window_step(params, cfg, caches, feed[j][:, None], pos + j, active,
                                collect, post_step)
        logits.append(lg)
        aux.append(a)
        extra.append(e)
    return torch.stack(logits), _stack(aux), _stack(extra)


def model_fused_window(params: Params, cfg: ModelConfig, caches: Params, token: torch.Tensor,
                       pos: torch.Tensor, active: Optional[torch.Tensor], n: int,
                       collect: Optional[Collect] = None, post_step: Optional[PostStep] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, Aux, Any]:
    """Draft + verify in one chain of ``n+1`` decode steps, for the case
    where the drafter is the verifier (MoD off, or draft ratio == capacity
    ratio): each step feeds the previous step's argmax, so the argmaxes of
    the first ``n`` steps are the drafts and the logits the verify stack,
    equal to :func:`model_draft_window` + :func:`model_verify_window` by
    construction. ``caches`` is updated in place. Returns (drafts (n, B),
    logits (n+1, B, V), aux stacks, collected stacks)."""
    t, logits, nxt, aux, extra = token, [], [], [], []
    for j in range(n + 1):
        lg, a, e = _window_step(params, cfg, caches, t, pos + j, active, collect, post_step)
        d = torch.argmax(lg, dim=-1)
        logits.append(lg)
        nxt.append(d)
        aux.append(a)
        extra.append(e)
        t = d[:, None]
    return torch.stack(nxt[:n]), torch.stack(logits), _stack(aux), _stack(extra)
