"""The SwiGLU MLP, and the routed (Swi/Ge)GLU MLP with the gated
scatter-add of paper Eq. 1 as its epilogue (the MLP half of the
``pallas_fused`` MoD backend).

:func:`swiglu` is the port of ``repro/kernels/swiglu.py::swiglu`` (the
Pallas ``_swiglu_kernel``): ``y = cast(Σ_F f32(cast(silu(f32(x·Wg)) ·
f32(x·Wu)) · Wd))``, the hidden rounded once to x's dtype before the
down projection and the sum over F cast once at the end (the model's
``layers.mlp`` rounds each projection instead). The CUDA kernel of
``csrc/swiglu.cu`` runs for CUDA tensors and takes any M and F; the plain
version (three ``torch.matmul`` in f32 and ``silu``) for CPU tensors. Like
the JAX kernel, it is on no model path and has no VJP: a tensor that
requires grad raises.

:func:`routed_mlp_scatter` is the port of
``repro/kernels/swiglu.py::routed_mlp_scatter`` (the Pallas
``_routed_mlp_kernel``): RMSNorm(ln2) of the routed rows' post-attention
hidden ``h_sub`` -> (Swi/Ge)GLU MLP -> ``delta = a_sub + m`` -> ``out = x
+ cast(gate·f32(delta))`` on the routed rows, ``x`` elsewhere.
The CUDA kernel of ``csrc/routed_mlp.cu`` runs for CUDA tensors and the
plain PyTorch version beside it for CPU tensors, inside a
``torch.autograd.Function`` whose backward recomputes through the plain
version under autograd, as the JAX VJP differentiates its host mirror.
Rounding points are the mirror's: the working type after each projection,
after the activation and the GLU product, for ``m`` and for ``a + m``; the
gate product is f32 and is cast before the add.

Both kernels run their products on one of two GEMMs of ``csrc/gemm.cuh``,
chosen per call before launch by :func:`gemm_path` from the dtype, the
shape and the alignment of the bases: Hopper's TMA + wgmma GEMM for bf16
whose N and K are multiples of 8, the CUDA-core GEMM for the rest. The
wrapper passes the choice to the C entry point, which launches that GEMM
or fails; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.routing import scatter_add_rows_plain
from repro_torch.models.layers import mlp_act, rmsnorm

ROUTED_MLP_SCATTER = build.counter("routed_mlp_scatter")
SWIGLU = build.counter("swiglu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
_KEYS = ("ln", "w_up", "w_down", "w_gate")
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 12 + (_I,) * 8 + (ctypes.c_float, _P)
# the GEMMs of csrc/gemm.cuh, by the code the C entry points take
GEMM_PATHS = {"cuda_cores": 0, "wgmma": 1}
_INT_MAX = 2 ** 31 - 1


def gemm_path(dtype: torch.dtype, M: int, N: int, K: int, aligned: bool) -> str:
    """The GEMM that computes C (M, N) = A (M, K) @ B (K, N) in these
    kernels: ``"wgmma"`` (Hopper's TMA + wgmma GEMM) for bf16 whose N and K
    are multiples of 8 (TMA's 16-byte global strides) with every base
    16-byte aligned, else ``"cuda_cores"``. A pure function of its
    arguments, decided before launch; the C side refuses a wgmma call that
    does not fit. Raises for what neither GEMM takes (a dtype other than
    f32 and bf16, a negative size or one beyond a C int), before anything
    is built. A kernel's products (M, F, D) and (M, D, F) always share
    one path."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}; the GEMMs take {list(_DTYPES)}")
    if min(M, N, K) < 0 or max(M, N, K) > _INT_MAX:
        raise ValueError(f"GEMM sizes M={M} N={N} K={K} must lie in [0, {_INT_MAX}]")
    if (dtype == torch.bfloat16 and aligned and M >= 1 and N > 0 and K > 0
            and N % 8 == 0 and K % 8 == 0):
        return "wgmma"
    return "cuda_cores"


def bases_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every base a kernel reads is 16-byte aligned once the wrapper
    makes it contiguous: a contiguous tensor keeps its base, any other is
    copied to a new allocation (aligned)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t.is_contiguous())


def swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 products, the hidden rounded to x's dtype, the
    down product in f32, cast once."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h.float(), w_down.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x (M, D), w_gate / w_up (D, F), w_down (F, D), one dtype (f32 or
    bf16) and device -> (M, D)."""
    if x.dim() != 2 or w_gate.dim() != 2:
        raise ValueError(f"want x (M,D) and w_gate (D,F); got {tuple(x.shape)}, "
                         f"{tuple(w_gate.shape)}")
    M, D = x.shape
    F = w_gate.shape[1]
    if w_gate.shape != (D, F) or w_up.shape != (D, F) or w_down.shape != (F, D):
        raise ValueError(f"want w_gate/w_up {(D, F)} and w_down {(F, D)}; got "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"x and the weights must share one dtype of {list(_DTYPES)}")
    if any(t.requires_grad for t in (x, w_gate, w_up, w_down)):
        raise ValueError("the swiglu kernel has no gradient (the JAX kernel has no VJP)")
    if any(t.device != x.device for t in (w_gate, w_up, w_down)):
        raise ValueError("x and the weights must be on one device")
    if x.device.type == "cpu":
        return swiglu_plain(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _swiglu_launch(x, w_gate, w_up, w_down)


def _swiglu_launch(x, w_gate, w_up, w_down):
    M, D = x.shape
    F = w_gate.shape[1]
    path = gemm_path(x.dtype, M, F, D, bases_aligned(x, w_gate, w_up, w_down))
    x, w_gate, w_up, w_down = (t.contiguous() for t in (x, w_gate, w_up, w_down))
    y = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M == 0 or D == 0:
        return y
    if F == 0:
        return y.zero_()
    h = torch.empty((M, F), dtype=x.dtype, device=x.device)
    fn = build.bind("swiglu", "repro_swiglu", (_P,) * 6 + (_I,) * 5 + (_P,))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
             y.data_ptr(), M, D, F, _DTYPES[x.dtype], GEMM_PATHS[path], stream)
    build.check("swiglu", "repro_swiglu", err)
    SWIGLU.add((path, M, D, F))
    return y


class RoutedMlpSpec(NamedTuple):
    act: str  # "silu" | "gelu" (tanh approximation, as jax.nn.gelu)
    eps: float


def routed_mlp_scatter_plain(x, h_sub, a_sub, idx, gate, params, spec: RoutedMlpSpec):
    """Plain version (the JAX ``_routed_mlp_host``): RMSNorm -> MLP ->
    ``a + m`` -> gated scatter-add into x; the activation in f32, rounded
    once, as the kernel computes it."""
    hn = rmsnorm({"scale": params["ln"]}, h_sub, spec.eps)
    delta = a_sub + mlp_act(params, hn, spec.act, rounded_once=True)
    return scatter_add_rows_plain(x, idx, delta, gate)


def _routed_mlp_launch(x, h_sub, a_sub, idx, gate, params, spec: RoutedMlpSpec):
    B, S, D = x.shape
    k = idx.shape[1]
    F = params["w_up"].shape[1]
    dev, dt = x.device, x.dtype
    # the GEMMs read hn and hid (new buffers) and the weights
    weights = [params[key] for key in _KEYS[1:] if key in params]
    path = gemm_path(dt, B * k, F, D, bases_aligned(*weights))
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
        B, S, k, D, F, _DTYPES[dt], _ACTS[spec.act], GEMM_PATHS[path], float(spec.eps), stream,
    )
    build.check("routed_mlp", "repro_routed_mlp", err)
    ROUTED_MLP_SCATTER.add((path, B, S, k, D, F))
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
