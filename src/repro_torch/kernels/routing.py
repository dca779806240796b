"""MoD routed dispatch kernels: row gather and gated scatter-add (Eq. 1).

Port of ``repro/kernels/routing.py`` (the Pallas ``gather_rows`` and
``scatter_add_rows`` with their custom VJPs). Each wrapper is a
``torch.autograd.Function`` whose forward launches the CUDA kernel of
``csrc/routing.cu`` for a CUDA tensor and runs the plain PyTorch version
beside it for a CPU tensor; on a CUDA tensor it launches or raises, never
falls back. The backwards mirror the JAX VJPs and reuse the same two
kernels (the JAX package has no separate backward kernel): gather's
backward is the gated scatter-add into zeros with a unit gate; scatter's
is ``dx = g``, ``ddelta = cast(gate·gather(g))`` and
``dgate = Σ_D f32(gather(g))·f32(delta)``. Indices are int64, unique per
row (top-k selections), so both functions are exact copies/updates: the
kernels and the plain versions agree bit for bit, and both with the JAX
one-hot formulation on finite inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

GATHER_ROWS = build.counter("gather_rows")
SCATTER_ADD_ROWS = build.counter("scatter_add_rows")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_rows(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"want x (B,S,D) and idx (B,k), got {tuple(x.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if idx.device != x.device:
        raise ValueError("x and idx must be on one device")


# ---------------------------------------------------------------------------
# gather: out[b, i] = x[b, idx[b, i]]
# ---------------------------------------------------------------------------


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``take_along_dim`` over the sequence axis."""
    return torch.take_along_dim(x, idx[..., None], dim=1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, idx = x.contiguous(), idx.contiguous()
    B, S, D = x.shape
    k = idx.shape[1]
    out = torch.empty((B, k, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.bind("routing", "repro_gather_rows", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, k, D, x.element_size(),
             idx.element_size(), stream)
    build.check("routing", "repro_gather_rows", err)
    GATHER_ROWS.launches += 1
    return out


# ---------------------------------------------------------------------------
# gated scatter-add: out = x, then out[b, idx] = x[b, idx] + cast(gate * delta)
# ---------------------------------------------------------------------------


def scatter_add_rows_plain(
    x: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor, gate: torch.Tensor
) -> torch.Tensor:
    """Plain version: copy, then write the k routed rows. The gate multiply
    is f32 and the product is cast to x's type before the add."""
    upd = (gate[..., None].float() * delta.float()).to(x.dtype)
    rows = torch.take_along_dim(x, idx[..., None], dim=1) + upd
    out = x.clone()
    out.scatter_(1, idx[..., None].expand(-1, -1, x.shape[2]), rows)
    return out


def _scatter(x, idx, delta, gate) -> torch.Tensor:
    if x.device.type == "cpu":
        return scatter_add_rows_plain(x, idx, delta, gate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (delta.device == gate.device == x.device):
        raise ValueError("x, idx, delta and gate must be on one device")
    x, idx, delta = x.contiguous(), idx.contiguous(), delta.contiguous()
    gate = gate.to(torch.float32).contiguous()
    B, S, D = x.shape
    k = idx.shape[1]
    if k == 0 or x.numel() == 0:
        return x.clone()
    out = torch.empty_like(x)
    fn = build.bind(
        "routing", "repro_scatter_add_rows", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        x.data_ptr(), idx.data_ptr(), delta.data_ptr(), gate.data_ptr(), out.data_ptr(),
        B, S, k, D, _DTYPES[x.dtype], idx.element_size(), stream,
    )
    build.check("routing", "repro_scatter_add_rows", err)
    SCATTER_ADD_ROWS.launches += 1
    return out


# ---------------------------------------------------------------------------
# differentiable wrappers (the JAX custom VJPs)
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        return _gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        zeros = g.new_zeros(ctx.x_shape)
        ones = torch.ones(idx.shape, dtype=torch.float32, device=g.device)
        return _scatter(zeros, idx, g.contiguous(), ones), None


class _ScatterAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, delta, gate):
        ctx.save_for_backward(idx, delta, gate)
        return _scatter(x, idx, delta, gate)

    @staticmethod
    def backward(ctx, g):
        idx, delta, gate = ctx.saved_tensors
        g_sub = _gather(g.contiguous(), idx).float()  # (B, k, D)
        ddelta = (gate[..., None].float() * g_sub).to(delta.dtype)
        dgate = (g_sub * delta.float()).sum(dim=-1).to(gate.dtype)
        return g, None, ddelta, dgate


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, D), (B, k) int64 -> (B, k, D)."""
    _check_rows(x, idx)
    return _GatherRows.apply(x, idx)


def scatter_add_rows(
    x: torch.Tensor,  # (B, S, D)
    idx: torch.Tensor,  # (B, k) int64, unique per row
    delta: torch.Tensor,  # (B, k, D), x's dtype
    gate: torch.Tensor,  # (B, k) f32 router weights
) -> torch.Tensor:  # (B, S, D)
    _check_rows(x, idx)
    B, S, D = x.shape
    k = idx.shape[1]
    if delta.shape != (B, k, D) or delta.dtype != x.dtype:
        raise ValueError(f"delta must be {(B, k, D)} {x.dtype}, got {tuple(delta.shape)} {delta.dtype}")
    if gate.shape != (B, k):
        raise ValueError(f"gate must be {(B, k)}, got {tuple(gate.shape)}")
    return _ScatterAddRows.apply(x, idx, delta, gate)
