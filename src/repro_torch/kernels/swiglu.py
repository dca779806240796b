"""Routed (Swi/Ge)GLU MLP with the gated scatter-add of paper Eq. 1 as its
epilogue: the MLP half of the ``pallas_fused`` MoD backend.

Port of ``repro/kernels/swiglu.py::routed_mlp_scatter`` (the Pallas
``_routed_mlp_kernel``): RMSNorm(ln2) of the routed rows' post-attention
hidden ``h_sub`` -> (Swi/Ge)GLU MLP -> ``delta = a_sub + m`` ->
``out = x + cast(gate·f32(delta))`` on the routed rows, ``x`` elsewhere.
The CUDA kernel of ``csrc/routed_mlp.cu`` runs for CUDA tensors and the
plain PyTorch version beside it for CPU tensors, inside a
``torch.autograd.Function`` whose backward recomputes through the plain
version under autograd, as the JAX VJP differentiates its host mirror.
Rounding points are the mirror's: the working type after each projection,
after the activation and the GLU product, for ``m`` and for ``a + m``; the
gate product is f32 and is cast before the add.

The Pallas ``swiglu`` kernel (the unrouted MLP) is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.routing import scatter_add_rows_plain
from repro_torch.models.layers import mlp_act, rmsnorm

ROUTED_MLP_SCATTER = build.counter("routed_mlp_scatter")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
_KEYS = ("ln", "w_up", "w_down", "w_gate")
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 12 + (_I,) * 7 + (ctypes.c_float, _P)


class RoutedMlpSpec(NamedTuple):
    act: str  # "silu" | "gelu" (tanh approximation, as jax.nn.gelu)
    eps: float


def routed_mlp_scatter_plain(x, h_sub, a_sub, idx, gate, params, spec: RoutedMlpSpec):
    """Plain version (the JAX ``_routed_mlp_host``): RMSNorm -> MLP ->
    ``a + m`` -> gated scatter-add into x."""
    hn = rmsnorm({"scale": params["ln"]}, h_sub, spec.eps)
    delta = a_sub + mlp_act(params, hn, spec.act)
    return scatter_add_rows_plain(x, idx, delta, gate)


def _routed_mlp_launch(x, h_sub, a_sub, idx, gate, params, spec: RoutedMlpSpec):
    B, S, D = x.shape
    k = idx.shape[1]
    F = params["w_up"].shape[1]
    dev, dt = x.device, x.dtype
    x, h_sub, a_sub, idx = x.contiguous(), h_sub.contiguous(), a_sub.contiguous(), idx.contiguous()
    gate = gate.to(torch.float32).contiguous()
    ps = {key: params[key].contiguous() for key in _KEYS if key in params}
    hn = torch.empty((B * k, D), dtype=dt, device=dev)
    hid = torch.empty((B * k, F), dtype=dt, device=dev)
    out = torch.empty_like(x)
    if k == 0 or x.numel() == 0:
        return out.copy_(x)
    wg = ps.get("w_gate")
    fn = build.bind("routed_mlp", "repro_routed_mlp", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        x.data_ptr(), h_sub.data_ptr(), a_sub.data_ptr(), idx.data_ptr(), gate.data_ptr(),
        ps["ln"].data_ptr(), ps["w_up"].data_ptr(), ps["w_down"].data_ptr(),
        None if wg is None else wg.data_ptr(), hn.data_ptr(), hid.data_ptr(), out.data_ptr(),
        B, S, k, D, F, _DTYPES[dt], _ACTS[spec.act], float(spec.eps), stream,
    )
    build.check("routed_mlp", "repro_routed_mlp", err)
    ROUTED_MLP_SCATTER.launches += 1
    return out


class _RoutedMlpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_sub, a_sub, idx, gate, spec, keys, *tensors):
        params = dict(zip(keys, tensors))
        ctx.save_for_backward(x, h_sub, a_sub, idx, gate, *tensors)
        ctx.spec, ctx.keys = spec, keys
        if x.device.type == "cpu":
            return routed_mlp_scatter_plain(x, h_sub, a_sub, idx, gate, params, spec)
        return _routed_mlp_launch(x, h_sub, a_sub, idx, gate, params, spec)

    @staticmethod
    def backward(ctx, g):
        x, h_sub, a_sub, idx, gate, *tensors = ctx.saved_tensors
        ng = ctx.needs_input_grad
        needs = (ng[0], ng[1], ng[2], ng[4]) + tuple(ng[7:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip([x, h_sub, a_sub, gate, *tensors], needs)]
            out = routed_mlp_scatter_plain(
                leaves[0], leaves[1], leaves[2], idx, leaves[3],
                dict(zip(ctx.keys, leaves[4:])), ctx.spec)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        grads = [next(got) if n else None for n in needs]
        return (*grads[:3], None, grads[3], None, None, *grads[4:])


def routed_mlp_scatter(
    x: torch.Tensor,  # (B, S, D) full residual stream
    h_sub: torch.Tensor,  # (B, k, D) post-attention hidden of the routed rows
    a_sub: torch.Tensor,  # (B, k, D) attention contribution of the routed rows
    idx: torch.Tensor,  # (B, k) int64 routed rows, sorted unique
    gate: torch.Tensor,  # (B, k) f32 router gates
    params: Dict[str, torch.Tensor],  # ln, w_up, w_down (+ w_gate)
    spec: RoutedMlpSpec,
) -> torch.Tensor:  # (B, S, D)
    """``x + P @ (gate · (a + mlp(rmsnorm(h))))`` in one kernel: the routed
    MLP and the Eq. 1 combine, with no standalone scatter pass."""
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"want x (B,S,D) and idx (B,k); got {tuple(x.shape)}, {tuple(idx.shape)}")
    B, S, D = x.shape
    k = idx.shape[1]
    if h_sub.shape != (B, k, D) or a_sub.shape != (B, k, D) or gate.shape != (B, k):
        raise ValueError("h_sub and a_sub must be (B, k, D) and gate (B, k)")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if spec.act not in _ACTS:
        raise ValueError(f"unknown activation {spec.act!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    keys = tuple(key for key in _KEYS if key in params)
    for name, t in [("h_sub", h_sub), ("a_sub", a_sub)] + [(key, params[key]) for key in keys]:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on {x.device}")
    if idx.device != x.device or gate.device != x.device:
        raise ValueError("x, idx and gate must be on one device")
    return _RoutedMlpScatter.apply(x, h_sub, a_sub, idx, gate, spec, keys,
                                   *(params[key] for key in keys))
