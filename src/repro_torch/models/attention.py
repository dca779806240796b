"""Grouped-query attention with position masking and ring KV caches.

Port of ``repro/models/attention.py`` (single device). Queries and keys
carry explicit *original positions*: MoD gathers a non-contiguous routed
sub-sequence, causality is ``kv_pos <= q_pos`` on original positions and
RoPE rotates by them, so one code path serves vanilla and routed blocks.
KV caches are fixed-capacity rings with a per-sequence cursor; empty slots
have pos = -1 and are masked out. MoD blocks size their rings at the block
capacity ``ratio·ctx`` (the paper's KV-cache saving).

Every attention core (training, prefill, chunked prefill, decode) goes
through the flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which runs
its plain PyTorch version for CPU tensors and carries gradients through
its ``autograd.Function``. (The JAX package's dense ``attend`` is not
ported: nothing here runs it, and the tests hold the kernel's function
against the JAX ``attend`` itself.) :func:`routed_self_attention` is the
``pallas_fused`` backend's routed attention: gather, norm and attention of
the routed rows in one kernel.

Unlike the JAX functions, which return new caches, these functions write
the caches in place and return them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels.flash_attention import RoutedAttnSpec, flash_attention, routed_attention
from repro_torch.models.layers import apply_rope, dense_init

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
    B, S, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(B, S, cfg.attn.n_heads, cfg.head_dim)


def _project_kv(params: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    nkv, hd = cfg.attn.n_kv_heads, cfg.head_dim
    return k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def _rope_qk(q, k, q_pos, kv_pos, cfg: ModelConfig):
    if cfg.attn.pos_emb == "rope":
        q = apply_rope(q, q_pos, cfg.attn.rope_theta)
        # padded keys (pos -1) rotate as position 0; they are masked anyway
        k = apply_rope(k, kv_pos.clamp_min(0), cfg.attn.rope_theta)
    elif cfg.attn.pos_emb != "none":
        raise NotImplementedError(f"pos_emb {cfg.attn.pos_emb!r} (ROADMAP Queue 1, VLM)")
    return q, k


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn.softmax_scale or 1.0 / cfg.head_dim**0.5


def attend_auto(q, k, v, q_pos, kv_pos, cfg: ModelConfig) -> torch.Tensor:
    """Position-masked attention through the flash kernel. (B, Sq, nq*hd)."""
    B, Sq, nq, hd = q.shape
    out = flash_attention(
        q, k, v, q_pos, kv_pos,
        causal=bool(cfg.attn.causal), window=int(cfg.attn.window), scale=_scale(cfg),
    )
    return out.reshape(B, Sq, nq * hd)


def self_attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Attention over a sequence without a cache (positions (B, S))."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    return attend_auto(q, k, v, positions, positions, cfg) @ params["wo"]


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
        "cursor": torch.zeros((batch,), dtype=torch.int64, device=device),
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
    spare = (cache["cursor"] + n) % C  # (B,)
    slot = torch.where(mask, (cache["cursor"][:, None] + rank) % C, spare[:, None])
    bidx = torch.arange(B, device=slot.device)[:, None].expand(B, S_new)
    rows = torch.arange(B, device=slot.device)
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        old = buf[rows, spare][:, None]  # (B, 1, nkv, hd)
        buf[bidx, slot] = torch.where(mask[..., None, None], new.to(buf.dtype), old)
    old_pos = cache["pos"][rows, spare][:, None]
    cache["pos"][bidx, slot] = torch.where(mask, pos_new.to(torch.int32), old_pos)
    cache["cursor"] += n
    return cache


def decode_attention(
    params: Params,
    x: torch.Tensor,  # (B, 1, D)
    positions: torch.Tensor,  # (B, 1) int32
    cache: Params,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Params]:
    """One decode step: write this token's rotated K/V, attend over the
    cache. The cache stores rotated K, so nothing is re-rotated at read
    time. (The JAX version's decode TP constraint is a mesh hint with no
    single-GPU counterpart.)"""
    q = _project_q(params, x, cfg)
    k_new, v_new = _project_kv(params, x, cfg)
    q, k_new = _rope_qk(q, k_new, positions, positions, cfg)
    cache = cache_write(cache, k_new, v_new, positions)
    out = attend_auto(q, cache["k"], cache["v"], positions, cache["pos"], cfg)
    return out @ params["wo"], cache


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
    cache = cache_write(cache, k, v, positions, write_mask)
    out = attend_auto(q, cache["k"], cache["v"], positions, cache["pos"], cfg)
    return out @ params["wo"], cache


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
    out = attend_auto(q, k, v, positions, positions, cfg) @ params["wo"]
    cache = cache_write(cache, k, v, positions, write_mask)
    return out, cache
