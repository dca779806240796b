"""Core layers: RMSNorm, rotary embeddings (RoPE and M-RoPE), (Swi/Ge)GLU
and plain MLPs, embeddings, cross-entropy.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors
with the JAX package's names and layouts (``x @ w`` with ``w`` of shape
(in, out)), so the JAX parameter tree converts leaf for leaf
(:mod:`repro_torch.params`). ``init_*`` draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as SH

Params = Dict[str, torch.Tensor]


def dense_init(
    gen: torch.Generator, fan_in: int, shape, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32, then cast (the JAX ``_dense_init``)."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale
    return w.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32, returned in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, S, H, hd); positions: (B, S) — *original*
    token positions, non-contiguous for MoD-gathered sub-sequences."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: three position streams (t, h, w).
    x: (B, S, H, hd); positions: (3, B, S). ``sections`` gives the number
    of frequency pairs each stream drives, in order (sum == hd/2)."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])  # (hd/2,) stream of each pair
    pos_per_freq = positions.float().index_select(0, sel)  # (hd/2, B, S)
    angles = pos_per_freq.permute(1, 2, 0) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP ((Swi/Ge)GLU or plain)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    D, Fh = cfg.d_model, cfg.d_ff
    dtype = torch_dtype(cfg.dtype)
    p = {
        "w_up": dense_init(gen, D, (D, Fh), dtype, device),
        "w_down": dense_init(gen, Fh, (Fh, D), dtype, device),
    }
    if cfg.glu:
        p["w_gate"] = dense_init(gen, D, (D, Fh), dtype, device)
    return p


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` as XLA lowers it: negate, exp, add 1, divide and
    multiply, each rounded to x's dtype (``F.silu`` rounds once, and at
    bf16 differs from it in ~40% of elements). The gradient is JAX's,
    ``g·s·(1 + x·(1 - s))`` from the saved logistic ``s``: finite where
    autograd through ``exp(-x)`` would give 0·inf."""

    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (s * (1 + x * (1 - s)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU rounded at ``jax.nn.silu``'s points: bit-equal to it at bf16,
    within a few ulps at f32."""
    return _Silu.apply(x)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A constant of ``like``'s dtype (rounded once from f32, as numpy's
    ``astype`` and a weakly typed JAX scalar are): a bf16 tensor times a
    Python float would multiply by the unrounded f32 constant."""
    return torch.tensor(value, dtype=torch.float32, device=like.device).to(like.dtype)


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)
_GELU_CUBIC = 0.044715


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu`` (its default tanh form) as XLA lowers it: the
    constant ``sqrt(2/pi)`` cast to x's dtype, then ``x**3`` (two
    multiplies), ``x + 0.044715·x**3``, the product with the constant,
    ``tanh``, ``0.5·(1 + t)`` and ``x·cdf``, each rounded to x's dtype
    (``F.gelu(approximate="tanh")`` rounds once, and at bf16 differs from
    it in ~37% of elements). The gradient follows JAX's reverse pass of the
    same ops: ``g·cdf + (1 + 3k·x²)·c·0.5·g·x·(1 - t)(1 + t)``."""

    @staticmethod
    def forward(ctx, x):
        c = _const(_SQRT_2_OVER_PI, x)
        k = _const(_GELU_CUBIC, x)
        t = torch.tanh(c * (x + k * (x * x * x)))
        cdf = _const(0.5, x) * (_const(1.0, x) + t)
        ctx.save_for_backward(x, t, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, t, cdf = ctx.saved_tensors
        c = _const(_SQRT_2_OVER_PI, x)
        k = _const(_GELU_CUBIC, x)
        a = _const(0.5, x) * (g * x) * (_const(1.0, x) - t)
        g_inner = c * (a + a * t)
        return g * cdf + (g_inner + k * g_inner * (_const(3.0, x) * (x * x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU rounded at ``jax.nn.gelu``'s points: bit-equal to it at
    bf16; at f32 within XLA's ``tanh`` (a few ulps; XLA saturates to ±1
    a little earlier)."""
    return _Gelu.apply(x)


def activation(act: str, rounded_once: bool = False):
    """The MLP activation by name: the JAX-rounded ``silu`` or ``gelu``
    (``F.silu`` / tanh ``F.gelu`` with ``rounded_once``, as the fused
    kernels compute them)."""
    if act == "silu":
        return F.silu if rounded_once else silu
    if act != "gelu":
        raise ValueError(f"unknown activation {act!r}")
    return (lambda t: F.gelu(t, approximate="tanh")) if rounded_once else gelu


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's MLP; summed over the model axis when the weights hold a
    rank's ``d_ff`` columns (``w_down``'s rows) only."""
    x = SH.copy_model(x, "mlp/w_up")
    return SH.reduce_model(mlp_act(params, x, cfg.act), "mlp/w_down")


def mlp_act(params: Params, x: torch.Tensor, act_name: str,
            rounded_once: bool = False) -> torch.Tensor:
    """The (GLU) MLP. ``rounded_once``: the activation computed in f32 and
    rounded once (``F.silu``), as the fused kernels compute it, in place of
    the rounding points of ``jax.nn.silu``."""
    act = activation(act_name, rounded_once)
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act(x @ params["w_gate"]) * up
    else:
        up = act(up)
    return up @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    p = {"tok": dense_init(gen, 1, (cfg.vocab, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["unemb"] = dense_init(gen, cfg.d_model, (cfg.d_model, cfg.vocab), dtype, device)
    return p


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows of the table; a table that holds a rank's D columns (the
    rule table's ``embed/tok``) is gathered over the model axis."""
    return SH.gather_model(params["tok"][tokens], -1, "embed/tok")


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits; a rank's vocab columns of ``unemb`` are gathered over the
    model axis. A tied table that holds a rank's D columns (JAX's ``x @
    tok.T`` on the D-sharded ``embed/tok``) multiplies the same columns of
    ``x``, and the partial logits are summed over the axis: whole logits on
    every rank."""
    if "unemb" not in params:
        tok = params["tok"]
        if not SH.is_split("embed/tok"):
            return x @ tok.T
        n, r = tok.shape[1], SH.model_rank()
        x = SH.copy_model(x, "embed/tok")[..., r * n:(r + 1) * n]
        return SH.reduce_model(x @ tok.T, "embed/tok")
    x = SH.copy_model(x, "embed/unemb")
    return SH.gather_model(x @ params["unemb"], -1, "embed/unemb")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V) in any float dtype,
    computed in f32. In a training call on a mesh the mean is the global
    batch's (the sums over the data-parallel ranks)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.take_along_dim(logits32, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return SH.batch_sum((nll * m).sum()) / SH.batch_sum(m.sum()).clamp_min(1.0)
    return SH.global_mean(nll)
