"""Family dispatcher: the entry points the trainer and the serving engine
call.

Port of ``repro/models/api.py``. Each family maps onto (init, forward,
loss, caches, decode):

    dense / moe / vlm  -> models.transformer
    ssm / hybrid       -> models.ssm_lm (mamba2 / zamba2)
    encdec             -> models.encdec (whisper)

An unknown family raises ``ValueError``, as in JAX. The ``vlm`` batch
carries ``embeds`` (B, S, D) in the model's dtype and M-RoPE ``positions``
(3, B, S) in place of ``tokens``; the ``encdec`` batch carries ``enc_emb``
(B, S_enc, D) beside its ``tokens``. :func:`stub_inputs` makes both from a
seed, as the JAX package's tests do.

``spmd`` (a :class:`repro_torch.distributed.sharding.ShardCtx`) on
:func:`model_decode` carries the partitioned ``batch_capacity`` routing
into every family's decode step, as in JAX. Over a mesh every entry point
takes one rank's rows and weight shards and makes the mesh's model axis
the group the layers reduce over, for every family (whole query heads and
whole SSM heads a rank: ``sharding.check_tensor_parallel``). The training
entry points (:func:`model_forward`, :func:`model_loss`) take ``spmd`` as
JAX's do: the rank's FSDP shards are gathered where they are used (each
layer group's inside its remat boundary), and the loss and aux terms
are the global batch's (sums over the data-parallel ranks), so the
data-axis mean of the ranks' gradients is the global batch's gradient.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.models import encdec as ED
from repro_torch.models import ssm_lm as SL
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy
from repro_torch.utils import tree_map

Params = Dict[str, Any]
Aux = Dict[str, torch.Tensor]

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
# families that run models/transformer.py
_TRANSFORMER = ("dense", "moe", "vlm")
# families whose prompts run through model_prefill_chunk and the flat forward
_BATCHED = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


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
    if cfg.family == "hybrid":
        return SL.init_hybrid(generator, cfg, dev)
    if cfg.family == "encdec":
        return ED.init_encdec(generator, cfg, dev)
    return T.init_lm(generator, cfg, dev)


def model_forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None, last_only: bool = False,
                  spmd: Optional[SH.ShardCtx] = None) -> Tuple[torch.Tensor, Aux]:
    """Teacher-forced forward. Returns (logits, aux); over a mesh
    (``spmd``) the logits of this rank's rows and the global batch's aux."""
    _check_family(cfg)
    _check_spmd(cfg, spmd)
    with SH.model_parallel(spmd, batch=True):
        # FSDP: the leaves outside the layer groups gathered here, each
        # group's where it runs (transformer.run_groups)
        return _forward(SH.gather_data(params, spmd, skip=("groups",)), cfg, batch, generator,
                        last_only)


def _forward(params, cfg, batch, generator, last_only):
    if cfg.family == "ssm":
        return SL.forward(params, cfg, batch["tokens"], generator=generator, last_only=last_only)
    if cfg.family == "hybrid":
        return SL.forward_hybrid(params, cfg, batch["tokens"], generator=generator,
                                 last_only=last_only)
    if cfg.family == "encdec":
        return ED.forward(params, cfg, batch["tokens"], batch["enc_emb"], generator=generator,
                          last_only=last_only)
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
               generator: Optional[torch.Generator] = None,
               spmd: Optional[SH.ShardCtx] = None) -> Tuple[torch.Tensor, Aux]:
    """CE + the weighted aux losses, and the aux dict with ``ce`` and
    ``loss``: :func:`model_forward` -> cross-entropy -> :func:`combine_losses`
    for every family. batch: tokens (``vlm``: embeds and positions;
    ``encdec``: and enc_emb), labels, optional loss_mask. Over a mesh
    (``spmd``) the batch holds this rank's rows and the loss is the global
    batch's on every rank."""
    logits, aux = model_forward(params, cfg, batch, generator, spmd=spmd)
    with SH.model_parallel(spmd, batch=True):
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
    if cfg.family not in _BATCHED:
        raise NotImplementedError(
            f"ragged forward for family {cfg.family}: use the padded model_forward")
    return T.forward_ragged(params, cfg, tokens, row_offsets, seg_cap, generator=generator)


def make_caches(cfg: ModelConfig, batch: int, ctx: int, device: DeviceLike = None,
                ssm_heads: Optional[int] = None) -> Params:
    """Empty decode caches of ``batch`` rows; ``ssm_heads``: the SSM heads
    a tensor-parallel rank's states hold (``sharding.local_ssm_heads``;
    None: all of them)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return SL.make_cache(cfg, batch, resolve_device(device), ssm_heads)
    if cfg.family == "hybrid":
        return SL.make_hybrid_cache(cfg, batch, ctx, resolve_device(device), ssm_heads)
    if cfg.family == "encdec":
        return ED.make_cache(cfg, batch, ctx, resolve_device(device))
    return T.make_cache(cfg, batch, ctx, resolve_device(device))


def _check_spmd(cfg: ModelConfig, spmd: Optional[SH.ShardCtx]) -> None:
    if spmd is not None:
        SH.check_tensor_parallel(cfg, spmd.model_shards)


def model_prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], ctx: int,
                  spmd: Optional[SH.ShardCtx] = None) -> Tuple[torch.Tensor, Params]:
    """Prompt pass that fills fresh (B, ctx) caches (``vlm``: over the
    batch's ``embeds`` and ``positions``). Returns (logits, caches)."""
    _check_family(cfg)
    if cfg.family not in _TRANSFORMER:
        raise NotImplementedError(f"prefill for family {cfg.family} uses forward+decode")
    _check_spmd(cfg, spmd)
    with SH.model_parallel(spmd):
        return T.prefill(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                         positions=batch.get("positions"), ctx=ctx)


def model_prefill_chunk(params: Params, cfg: ModelConfig, caches: Params,
                        tokens: torch.Tensor, start: int, n_valid: int,
                        spmd: Optional[SH.ShardCtx] = None) -> Tuple[torch.Tensor, Params]:
    """One continuation-prefill chunk (B, C) against partly filled caches."""
    _check_family(cfg)
    if cfg.family not in _BATCHED:
        raise NotImplementedError(
            f"chunked prefill for family {cfg.family}: prompts ingest via decode steps")
    _check_spmd(cfg, spmd)
    with SH.model_parallel(spmd):
        return T.prefill_chunk(params, cfg, caches, tokens, int(start), int(n_valid))


def model_decode(params: Params, caches: Params, cfg: ModelConfig, token: torch.Tensor,
                 pos: torch.Tensor, active: Optional[torch.Tensor] = None,
                 spmd: Optional[SH.ShardCtx] = None) -> Tuple[torch.Tensor, Params, Aux]:
    """One decode step. ``active`` (B,) bool marks live rows so MoD
    ``batch_capacity`` routing never spends routed slots on padding.
    ``spmd`` switches that routing to the partitioned semantics (over a
    mesh: on this rank's rows, with its weight shards)."""
    _check_family(cfg)
    _check_spmd(cfg, spmd)
    with SH.model_parallel(spmd):
        if cfg.family == "ssm":
            return SL.decode_step(params, caches, cfg, token, active, spmd)
        if cfg.family == "hybrid":
            return SL.decode_step_hybrid(params, caches, cfg, token, pos, active, spmd)
        if cfg.family == "encdec":
            return ED.decode_step(params, caches, cfg, token, pos, active, spmd)
        return T.decode_step(params, caches, cfg, token, pos, active, spmd)


# ---------------------------------------------------------------------------
# Stub frontends (the reference feeds these families precomputed inputs)
# ---------------------------------------------------------------------------


def mrope_positions(segments: List[Tuple[str, Any]], device: DeviceLike = None
                    ) -> torch.Tensor:
    """Qwen2-VL's (3, S) M-RoPE position ids for one sequence laid out as
    ``segments``, in order: ``("text", n)`` is n tokens whose three streams
    all count up; ``("image", (h, w))`` is an image of h x w merged patches
    that share one ``t`` and take ``h`` and ``w`` from their row and column.
    Each segment starts at the largest position before it + 1."""
    t_, h_, w_ = [], [], []
    nxt = 0
    for kind, size in segments:
        if kind == "text":
            ar = torch.arange(nxt, nxt + int(size), dtype=torch.int32)
            t_.append(ar)
            h_.append(ar)
            w_.append(ar)
            nxt += int(size)
        elif kind == "image":
            gh, gw = (int(v) for v in size)
            rows = torch.arange(gh, dtype=torch.int32)[:, None].expand(gh, gw).flatten()
            cols = torch.arange(gw, dtype=torch.int32)[None, :].expand(gh, gw).flatten()
            t_.append(torch.full((gh * gw,), nxt, dtype=torch.int32))
            h_.append(nxt + rows)
            w_.append(nxt + cols)
            nxt += max(gh, gw)
        else:
            raise ValueError(f"unknown segment kind {kind!r}")
    pos = torch.stack([torch.cat(t_), torch.cat(h_), torch.cat(w_)])
    return pos.to(resolve_device(device) if device is not None else pos.device)


def stub_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The stub frontend's inputs of a ``vlm`` or ``encdec`` batch, drawn from
    ``seed`` with the JAX tests' ``batch_for`` distributions: ``embeds`` (B, S,
    D) ~ N(0, 0.02²) in the model's dtype and ``positions`` (3, B, S) with
    the three streams equal (``vlm``); ``enc_emb`` (B, enc_seq_len, D) ~
    N(0, 0.02²) in the model's dtype (``encdec``); {} for the others."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        pos = torch.arange(seq, dtype=torch.int32)[None, None].expand(3, batch, seq)
        emb = torch.randn((batch, seq, cfg.d_model), generator=gen) * 0.02
        return {"embeds": emb.to(dt).to(dev), "positions": pos.contiguous().to(dev)}
    if cfg.family == "encdec":
        emb = torch.randn((batch, cfg.enc_seq_len, cfg.d_model), generator=gen) * 0.02
        return {"enc_emb": emb.to(dt).to(dev)}
    return {}


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
