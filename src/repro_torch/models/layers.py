"""Core layers: RMSNorm, rotary embeddings, (Swi/Ge)GLU MLP, embeddings,
cross-entropy.

Port of ``repro/models/layers.py``. Parameters are plain dicts of tensors
with the JAX package's names and layouts (``x @ w`` with ``w`` of shape
(in, out)), so the JAX parameter tree converts leaf for leaf
(:mod:`repro_torch.params`). ``init_*`` draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype

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


def activation(act: str, rounded_once: bool = False):
    """The MLP activation by name: the JAX-rounded ``silu`` (``F.silu``
    with ``rounded_once``) or tanh ``gelu``."""
    if act == "silu":
        return F.silu if rounded_once else silu
    if act != "gelu":
        raise ValueError(f"unknown activation {act!r}")
    # jax.nn.gelu defaults to the tanh approximation (its rounding points
    # are not mirrored: no gelu config is ported)
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mlp_act(params, x, cfg.act)


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
    return params["tok"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "unemb" in params:
        return x @ params["unemb"]
    return x @ params["tok"].T


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V) in any float dtype,
    computed in f32."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.take_along_dim(logits32, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
