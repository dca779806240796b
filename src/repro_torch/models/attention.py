"""Grouped-query attention with position masking and ring KV caches.

Port of ``repro/models/attention.py`` (single device). Queries and keys
carry explicit *original positions*: MoD gathers a non-contiguous routed
sub-sequence, causality is ``kv_pos <= q_pos`` on original positions and
RoPE rotates by them, so one code path serves vanilla and routed blocks.
KV caches are fixed-capacity rings with a per-sequence cursor; empty slots
have pos = -1 and are masked out. MoD blocks size their rings at the block
capacity ``ratio·ctx`` (the paper's KV-cache saving).

Every attention core of the padded layout (training, prefill, chunked
prefill, decode) goes through the flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which runs
its plain PyTorch version for CPU tensors and carries gradients through
its ``autograd.Function``. :func:`routed_self_attention` is the
``pallas_fused`` backend's routed attention: gather, norm and attention of
the routed rows in one kernel. :func:`ragged_self_attention` (the
flat-token forward) is the JAX package's dense masked :func:`attend` in
torch ops on both devices: the JAX package runs it without a Pallas
kernel too.

M-RoPE (``pos_emb="mrope"``, the VLM backbone) takes ``(3, B, S)``
positions (t, h, w): they rotate q and k, and the ``t`` stream orders
everything else (the mask, the cache's positions; :func:`t_pos`).
:func:`cross_attention` (the enc-dec decoder) attends over every encoder
key without rotation: the kernel gets ``causal=False`` and all-zero
positions, JAX's ``kv_pos=None``.

Unlike the JAX functions, which return new caches, these functions write
the caches in place and return them.

Tensor parallelism (a rank's shards from
:func:`repro_torch.distributed.sharding.shard_params`): the projections
take their head counts from the weights, so a rank attends with its own
query heads over its kv heads, and the output projection's partial sums
(``wo`` split on its rows) are summed over the model axis
(:func:`_project_out`); under autograd the projections' input gradient
is summed over it too (``sharding.copy_model``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    RoutedAttnSpec,
    flash_attention,
    routed_attention,
)
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init

Params = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    D = cfg.d_model
    hd = cfg.head_dim
    nq, nkv = cfg.attn.n_heads, cfg.attn.n_kv_heads
    dtype = torch_dtype(cfg.dtype)
    p = {
        "wq": dense_init(gen, D, (D, nq * hd), dtype, device),
        "wk": dense_init(gen, D, (D, nkv * hd), dtype, device),
        "wv": dense_init(gen, D, (D, nkv * hd), dtype, device),
        "wo": dense_init(gen, nq * hd, (nq * hd, D), dtype, device),
    }
    if cfg.attn.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
    return p


def _project_q(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, nq, hd): every query head, or a rank's share of them."""
    B, S, _ = x.shape
    q = SH.copy_model(x, "attn/wo") @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    hd = cfg.head_dim
    return q.reshape(B, S, params["wq"].shape[1] // hd, hd)


def _project_kv(params: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    x = SH.copy_model(x, "attn/wo")
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    hd = cfg.head_dim
    nkv = params["wk"].shape[1] // hd
    return k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def _project_out(params: Params, out: torch.Tensor) -> torch.Tensor:
    """``out @ wo``; summed over the model axis when ``wo`` holds a rank's
    rows (its query heads) only."""
    return SH.reduce_model(out @ params["wo"], "attn/wo")


def _rope_qk(q, k, q_pos, kv_pos, cfg: ModelConfig):
    # padded keys (pos -1) rotate as position 0; they are masked anyway
    if cfg.attn.pos_emb == "rope":
        q = apply_rope(q, q_pos, cfg.attn.rope_theta)
        k = apply_rope(k, kv_pos.clamp_min(0), cfg.attn.rope_theta)
    elif cfg.attn.pos_emb == "mrope":
        q = apply_mrope(q, q_pos, cfg.attn.rope_theta, cfg.attn.mrope_sections)
        k = apply_mrope(k, kv_pos.clamp_min(0), cfg.attn.rope_theta, cfg.attn.mrope_sections)
    elif cfg.attn.pos_emb != "none":
        raise ValueError(f"unknown pos_emb {cfg.attn.pos_emb!r}")
    return q, k


def t_pos(pos: torch.Tensor) -> torch.Tensor:
    """The scalar ordering stream: the ``t`` stream of M-RoPE's (3, B, S)
    positions, 2-D positions as they are."""
    return pos[0] if pos.dim() == 3 else pos


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn.softmax_scale or 1.0 / cfg.head_dim**0.5


# the JAX attend_auto's dense path takes problems up to this many scores
_DENSE_LIMIT = 4 * 1024 * 1024


def attend_auto(q, k, v, q_pos, kv_pos, cfg: ModelConfig) -> torch.Tensor:
    """Position-masked attention through the flash kernel. (B, Sq, nq*hd).

    A padded query row (position -1: no valid key under causal masking)
    comes out of the kernel as 0. In an MoE model a padded row's hidden
    state takes expert capacity beside the real rows (a chunk's padded
    tail, a short segment's rows in the flat forward), so there it is set
    to what the JAX ``attend_auto`` gives it: the mean of V over every key
    slot from its dense path, 0 from its blocked path (past
    ``_DENSE_LIMIT`` scores). A decode row (Sq = 1) is never padded."""
    B, Sq, nq, hd = q.shape
    out = flash_attention(
        q, k, v, q_pos, kv_pos,
        causal=bool(cfg.attn.causal), window=int(cfg.attn.window), scale=_scale(cfg),
    ).reshape(B, Sq, nq * hd)
    Skv, nkv = k.shape[1], k.shape[2]
    if cfg.uses_moe and cfg.attn.causal and 1 < Sq and Sq * Skv <= _DENSE_LIMIT:
        mean_v = v.float().mean(dim=1).repeat_interleave(nq // nkv, dim=1)  # (B, nq, hd)
        out = torch.where((q_pos < 0)[..., None], mean_v.reshape(B, 1, nq * hd).to(out.dtype),
                          out)
    return out


def self_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Attention over a sequence without a cache (positions (B, S))."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    tp = t_pos(positions)
    return _project_out(params, attend_auto(q, k, v, tp, tp, cfg))


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: int = 0
              ) -> torch.Tensor:
    """(B, Sq, Skv) bool, True = attend (JAX ``make_mask``): keys at
    position < 0 are empty; causal keeps ``kv_pos <= q_pos``, a window
    ``q_pos - kv_pos < window``."""
    valid = kv_pos[:, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid = valid & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return valid


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Dense grouped-query attention over a (B, Sq, Skv) bool mask (JAX
    ``attend``): f32 scores, masked entries at ``NEG_INF`` (a row with no
    valid key comes out as the mean of V, as there), probabilities cast
    to V's dtype before the value product. (B, Sq, nq*hd)."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, Sq, nkv, nq // nkv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg, k).float() * _scale(cfg)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v).reshape(B, Sq, nq * hd)


def ragged_self_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                          seg_id: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Self-attention over a flat ragged ``(1, T, D)`` stream (segments
    packed back to back). Causality is segment-block-diagonal: a query
    attends within its own segment at ``kv_pos <= q_pos`` on within-segment
    positions (``-1`` = padded tail). The cross-segment entries add exact
    zero softmax terms, so each segment's rows equal the dense attention
    of that sequence alone."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    tp = t_pos(positions)
    mask = make_mask(tp, tp, bool(cfg.attn.causal), int(cfg.attn.window))
    mask &= (seg_id[:, None] == seg_id[None, :])[None]
    return _project_out(params, attend(q, k, v, mask, cfg))


def routed_self_attention(
    params: Params,
    ln1: Params,  # the block's pre-attention RMSNorm params
    x: torch.Tensor,  # (B, S, D) FULL residual stream (not a gathered sub-tensor)
    idx: torch.Tensor,  # (B, k) routed rows, sorted unique
    pos_sub: torch.Tensor,  # (B, k) original positions of the routed rows
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-dispatch routed attention ("pallas_fused" backend): the value
    of ``self_attention(params, rmsnorm(ln1, x[idx]), pos_sub, cfg)`` with
    the routed rows as both queries and keys, from the full stream. Returns
    ``(a_sub, h_sub = x_sub + a_sub)``, both (B, k, D)."""
    p = {"ln": ln1["scale"], "wq": params["wq"], "wk": params["wk"],
         "wv": params["wv"], "wo": params["wo"]}
    if "bq" in params:
        p.update(bq=params["bq"], bk=params["bk"], bv=params["bv"])
    spec = RoutedAttnSpec(
        n_heads=cfg.attn.n_heads, n_kv_heads=cfg.attn.n_kv_heads, head_dim=cfg.head_dim,
        scale=float(_scale(cfg)), causal=bool(cfg.attn.causal), window=int(cfg.attn.window),
        rope_theta=float(cfg.attn.rope_theta), pos_emb=cfg.attn.pos_emb, eps=float(cfg.norm_eps),
    )
    return routed_attention(x, idx, pos_sub, p, spec)


def cross_attention(params: Params, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross-attention: no rotation, every encoder key
    valid (JAX's ``kv_pos=None``). The flash kernel gets ``causal=False``
    and all-zero query and key positions: a position of -1 would mask a
    key (a slot's unfilled cross-KV, which JAX attends to all the same)."""
    q = _project_q(params, x, cfg)
    B, Sq = x.shape[0], x.shape[1]
    out = flash_attention(
        q, enc_k, enc_v,
        torch.zeros((B, Sq), dtype=torch.int32, device=x.device),
        torch.zeros((B, enc_k.shape[1]), dtype=torch.int32, device=x.device),
        causal=False, scale=_scale(cfg),
    )
    return _project_out(params, out.reshape(B, Sq, -1))


def encode_kv(params: Params, enc_out: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder output (the served cross-KV)."""
    return _project_kv(params, enc_out, cfg)


# ---------------------------------------------------------------------------
# KV cache (fixed-capacity ring buffer)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, capacity: int, cfg: ModelConfig, device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> Params:
    nkv, hd = cfg.attn.n_kv_heads, cfg.head_dim
    dt = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros((batch, capacity, nkv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, capacity, nkv, hd), dtype=dt, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        "cursor": torch.zeros((batch,), dtype=torch.int32, device=device),  # as JAX's
    }


def cache_write(
    cache: Params,
    k_new: torch.Tensor,  # (B, S_new, nkv, hd)
    v_new: torch.Tensor,
    pos_new: torch.Tensor,  # (B, S_new) int32; -1 entries are skipped
    write_mask: Optional[torch.Tensor] = None,  # (B, S_new) bool
) -> Params:
    """Ring-buffer write, in place. Entry j of row b goes to slot
    ``(cursor + rank) % C`` where rank counts the written entries before it;
    entries with write_mask False (or pos < 0) are dropped.

    The JAX version drops them into a scratch row appended past the ring
    and slices it off, which copies the whole cache. Here a dropped entry
    rewrites the current contents of slot ``(cursor + n_written) % C``
    onto itself: while S_new <= C, a row with a dropped entry writes fewer
    than C entries, so that slot is written by no kept entry and keeps its
    value. Duplicate targets carry identical values, so the result does not
    depend on write order."""
    B, C = cache["pos"].shape
    S_new = pos_new.shape[1]
    if S_new > C:
        raise ValueError(f"a write of {S_new} entries would wrap a ring of {C}")
    mask = pos_new >= 0
    if write_mask is not None:
        mask = mask & write_mask
    m = mask.long()
    rank = m.cumsum(dim=1) - 1
    n = m.sum(dim=1)
    spare = (cache["cursor"] + n) % C  # (B,) int64: the cursor widens for indexing
    slot = torch.where(mask, (cache["cursor"][:, None] + rank) % C, spare[:, None])
    bidx = torch.arange(B, device=slot.device)[:, None].expand(B, S_new)
    rows = torch.arange(B, device=slot.device)
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        old = buf[rows, spare][:, None]  # (B, 1, nkv, hd)
        buf[bidx, slot] = torch.where(mask[..., None, None], new.to(buf.dtype), old)
    old_pos = cache["pos"][rows, spare][:, None]
    cache["pos"][bidx, slot] = torch.where(mask, pos_new.to(torch.int32), old_pos)
    cache["cursor"] += n.to(torch.int32)
    return cache


def decode_attention(
    params: Params,
    x: torch.Tensor,  # (B, 1, D)
    positions: torch.Tensor,  # (B, 1) int32, or (3, B, 1) for M-RoPE
    cache: Params,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Params]:
    """One decode step: write this token's rotated K/V, attend over the
    cache. The cache stores rotated K, so nothing is re-rotated at read
    time. (The JAX version's decode TP constraint is a GSPMD hint; here a
    rank's heads come with its weights and its cache.)"""
    q = _project_q(params, x, cfg)
    k_new, v_new = _project_kv(params, x, cfg)
    q, k_new = _rope_qk(q, k_new, positions, positions, cfg)
    tp = t_pos(positions)
    cache = cache_write(cache, k_new, v_new, tp)
    out = attend_auto(q, cache["k"], cache["v"], tp, cache["pos"], cfg)
    return _project_out(params, out), cache


def chunk_self_attention(
    params: Params,
    x: torch.Tensor,  # (B, C, D) one prefill chunk
    positions: torch.Tensor,  # (B, C); padded tail entries are -1
    cache: Params,
    cfg: ModelConfig,
    write_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Continuation prefill: write the chunk's K/V first, then attend over
    the whole cache (earlier chunks plus this one), position-masked."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    tp = t_pos(positions)
    cache = cache_write(cache, k, v, tp, write_mask)
    out = attend_auto(q, cache["k"], cache["v"], tp, cache["pos"], cfg)
    return _project_out(params, out), cache


def prefill_self_attention(
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,  # (B, S)
    cache: Params,
    cfg: ModelConfig,
    write_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Self-attention over the prompt that also fills the KV cache."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    tp = t_pos(positions)
    out = _project_out(params, attend_auto(q, k, v, tp, tp, cfg))
    cache = cache_write(cache, k, v, tp, write_mask)
    return out, cache
