"""Mamba2 (SSD — state-space duality) blocks: the chunked train scan and the
O(1)-state decode step.

Port of ``repro/models/ssm.py``. Recurrence per head h (ngroups=1, B/C
shared across heads):

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t ⊗ B_t          S: (hd, ds)
    y_t = S_t C_t + D_h x_t

Chunked SSD (arXiv:2405.21060): within a chunk of length Q the
contribution is an attention-like quadratic form; across chunks a linear
scan carries the state. The quadratic and each chunk's state increment
run in ``kernels.ssd.ssd_intra_chunk`` (the CUDA kernel on the card);
the cross-chunk scan and the inter-chunk term stay in torch ops, as the
JAX package keeps them in ``lax``. Dtype points are JAX's: f32 inside
:func:`ssd_chunked`, ``y`` cast to x's dtype, the skip term ``D·x`` in f32.

Projections are separate tensors (w_z/w_x/w_B/w_C/w_dt) and the
depthwise conv applies to x/B/C independently, as in the JAX package.
Parameters are plain dicts with its names and layouts; ``A_log``,
``skip_D`` and ``dt_bias`` stay f32 in a bf16 model.

Tensor parallelism (a rank's shards from ``sharding.shard_params``, whole
SSD heads a rank) writes out by hand what GSPMD derives for the JAX
package: the block takes its head count and ``d_inner`` width from the
weights; the input is ``copy_model``'d once, so its gradient is summed
over the model axis; ``z``, ``x``, the conv over ``x``, ``A``, ``D`` and
``dt`` (the rank's columns of the whole ``w_dt``, so ``dt`` is contiguous
at the local head count, as the SSD kernel's tensor-core path needs) run
at the rank's heads; ``B`` and ``C`` are whole on every rank, and their
leaves' partial gradients are summed over the axis where they are used
(``sharding.whole_in_split``); the gated RMSNorm normalizes over the
whole ``d_inner``, so its per-row sum of squares is summed over the axis
in both directions (``sharding.sum_model``), and ``out_proj`` is
row-parallel (``reduce_model``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.ssd import ssd_intra_chunk
from repro_torch.models.layers import dense_init, rmsnorm, silu

Params = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    D = cfg.d_model
    d_inner = cfg.ssm.expand * D
    H = d_inner // cfg.ssm.head_dim
    return D, d_inner, H, cfg.ssm.d_state


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """Drawn from the JAX ``init_ssm_block``'s distributions (not its
    values: the generators differ)."""
    D, d_inner, H, ds = dims(cfg)
    W = cfg.ssm.d_conv
    dtype = torch_dtype(cfg.dtype)
    f32 = torch.float32
    u = torch.rand((H,), generator=gen, device=device, dtype=f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "w_z": dense_init(gen, D, (D, d_inner), dtype, device),
        "w_x": dense_init(gen, D, (D, d_inner), dtype, device),
        "w_B": dense_init(gen, D, (D, ds), dtype, device),
        "w_C": dense_init(gen, D, (D, ds), dtype, device),
        "w_dt": dense_init(gen, D, (D, H), dtype, device),
        "conv_x": dense_init(gen, W, (W, d_inner), dtype, device),
        "conv_B": dense_init(gen, W, (W, ds), dtype, device),
        "conv_C": dense_init(gen, W, (W, ds), dtype, device),
        "conv_bx": torch.zeros((d_inner,), dtype=dtype, device=device),
        "conv_bB": torch.zeros((ds,), dtype=dtype, device=device),
        "conv_bC": torch.zeros((ds,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)),
        "skip_D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": dt_bias,
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=device)},
        "out_proj": dense_init(gen, d_inner, (d_inner, D), dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C) depthwise causal conv, summed in f32 tap by
    tap (the JAX loop's order)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + pad[:, i:i + S, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """window: (B, W, C), the most recent W inputs; returns (B, C) f32."""
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return out + b.float()


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, hd)
    dt: torch.Tensor,  # (B, S, H), post-softplus, >= 0
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, ds)
    Cm: torch.Tensor,  # (B, S, ds)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, hd, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, S, H, hd) in x's dtype, final state
    (B, H, hd, ds) f32)."""
    B, S, H, hd = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} must be divisible by chunk {Q}"
    N = S // Q

    dtc = dt.reshape(B, N, Q, H).float()
    Bc = Bm.reshape(B, N, Q, ds)
    Cc = Cm.reshape(B, N, Q, ds)
    loglam = dtc * A  # (B, N, Q, H), <= 0
    l = torch.cumsum(loglam, dim=2)  # inclusive cumsum
    lQ = l[:, :, -1:, :]  # (B, N, 1, H)

    # intra-chunk quadratic + chunk-state increments: the kernel, reading
    # (B, H, N, Q, ·) views of the (B, S, H, ·) activations
    y_intra, inc = ssd_intra_chunk(
        x.reshape(B, N, Q, H, hd).permute(0, 3, 1, 2, 4),
        loglam.permute(0, 3, 1, 2), dtc.permute(0, 3, 1, 2), Bc, Cc,
    )  # (B, H, N, Q, hd), (B, H, N, hd, ds)

    # cross-chunk scan: the state entering each chunk
    chunk_decay = torch.exp(lQ[:, :, 0, :])  # (B, N, H)
    s = (torch.zeros((B, H, hd, ds), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    states_prev = []
    for n in range(N):
        states_prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + inc[:, :, n]
    prev = torch.stack(states_prev, dim=1)  # (B, N, H, hd, ds)

    # inter-chunk contribution
    y_inter = torch.einsum("bnqs,bnhds->bnqhd", Cc.float(), prev) * torch.exp(l)[..., None]
    y = (y_intra.permute(0, 2, 3, 1, 4) + y_inter).reshape(B, S, H, hd)
    return y.to(x.dtype), s


def ssd_step(
    x: torch.Tensor,  # (B, H, hd)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, ds)
    Cm: torch.Tensor,  # (B, ds)
    state: torch.Tensor,  # (B, H, hd, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the SSD recurrence."""
    x32, dt32 = x.float(), dt.float()
    lam = torch.exp(dt32 * A)  # (B, H)
    state = state * lam[..., None, None] + torch.einsum(
        "bh,bhd,bs->bhds", dt32, x32, Bm.float())
    y = torch.einsum("bhds,bs->bhd", state, Cm.float())
    return y.to(x.dtype), state


def _leaf(params: Params, name: str) -> torch.Tensor:
    """A leaf of the block as this rank uses it: a leaf the model axis
    leaves whole in a split block gets its partial gradient summed over
    the axis."""
    return SH.whole_in_split(params[name], "ssm/" + name, "ssm/w_x")


def _project(params: Params, x: torch.Tensor):
    """(z, x) at this rank's ``d_inner`` channels, (B, C) whole, ``dt`` at
    its heads."""
    x = SH.copy_model(x, "ssm/w_x")
    w_dt = _leaf(params, "w_dt")
    h = params["A_log"].shape[0]
    if w_dt.shape[1] != h:  # a rank's heads: its columns of the whole leaf
        r = SH.model_rank()
        w_dt = w_dt[:, r * h:(r + 1) * h]
    return (x @ params["w_z"], x @ params["w_x"], x @ _leaf(params, "w_B"),
            x @ _leaf(params, "w_C"), x @ w_dt)


def _gated_norm(params: Params, g: torch.Tensor, width: int, eps: float) -> torch.Tensor:
    """RMSNorm over the whole ``d_inner`` (``width``) of which a rank may
    hold a part: the per-row sum of squares is summed over the model axis
    when ``norm/scale`` is split (a local ``rmsnorm`` would normalize each
    rank's channels by their own scale)."""
    if not SH.is_split("norm/scale"):
        return rmsnorm(params, g, eps)
    x32 = g.float()
    ss = SH.sum_model(x32.square().sum(dim=-1, keepdim=True), "norm/scale")
    y = x32 * torch.rsqrt(ss / width + eps)
    return (y * params["scale"].float()).to(g.dtype)


def _post(params: Params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = y * silu(z)
    g = _gated_norm(params["norm"], g, dims(cfg)[1], cfg.norm_eps)
    return SH.reduce_model(g @ params["out_proj"], "ssm/out_proj")


def _conv_leaves(params: Params, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conv taps and bias of input ``name`` (x, B or C)."""
    return _leaf(params, "conv_" + name), _leaf(params, "conv_b" + name)


def ssm_block(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block (training). x: (B, S, D) -> (B, S, D);
    the heads and ``d_inner`` channels are the weights' (a rank's share
    under tensor parallelism)."""
    B, S, _ = x.shape
    H, d_inner = params["A_log"].shape[0], params["w_x"].shape[1]
    z, xs, Bm, Cm, dt_raw = _project(params, x)
    xs = silu(_causal_conv(xs, *_conv_leaves(params, "x")))
    Bm = silu(_causal_conv(Bm, *_conv_leaves(params, "B")))
    Cm = silu(_causal_conv(Cm, *_conv_leaves(params, "C")))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, S, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, S, H, cfg.ssm.head_dim)
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk)
    y = y.float() + params["skip_D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    return _post(params, y, z, cfg)


def init_ssm_cache(batch: int, cfg: ModelConfig, device: torch.device,
                   heads: Optional[int] = None) -> Params:
    """Decode state: the SSD state (f32) and the last W-1 conv inputs of
    x, B and C. No leaf has a context axis. ``heads``: the SSM heads a
    tensor-parallel rank holds (its state heads and ``conv_x`` channels;
    B and C stay whole), all of them by default."""
    D, d_inner, H, ds = dims(cfg)
    if heads is not None:
        H, d_inner = heads, heads * cfg.ssm.head_dim
    W = cfg.ssm.d_conv
    dt = torch_dtype(cfg.dtype)
    return {
        "state": torch.zeros((batch, H, cfg.ssm.head_dim, ds), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, W - 1, d_inner), dtype=dt, device=device),
        "conv_B": torch.zeros((batch, W - 1, ds), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, W - 1, ds), dtype=dt, device=device),
    }


def ssm_block_decode(params: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, D). Returns (out (B, 1, D), new cache);
    ``cache`` itself is not written (a rank's heads: its state and
    ``conv_x`` window)."""
    B = x.shape[0]
    H, d_inner = params["A_log"].shape[0], params["w_x"].shape[1]
    z, xs, Bm, Cm, dt_raw = _project(params, x)  # (B, 1, ·)
    win_x = torch.cat([cache["conv_x"], xs], dim=1)
    win_B = torch.cat([cache["conv_B"], Bm], dim=1)
    win_C = torch.cat([cache["conv_C"], Cm], dim=1)
    xs_t = silu(_conv_step(win_x, *_conv_leaves(params, "x"))).to(x.dtype)
    Bm_t = silu(_conv_step(win_B, *_conv_leaves(params, "B")))
    Cm_t = silu(_conv_step(win_C, *_conv_leaves(params, "C")))
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs_t.reshape(B, H, cfg.ssm.head_dim)
    y, state = ssd_step(xh, dt, A, Bm_t, Cm_t, cache["state"])
    y = y.float() + params["skip_D"][None, :, None] * xh.float()
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    out = _post(params, y, z, cfg)
    return out, {"state": state, "conv_x": win_x[:, 1:], "conv_B": win_B[:, 1:],
                 "conv_C": win_C[:, 1:]}
