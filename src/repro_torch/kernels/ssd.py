"""Mamba2 SSD intra-chunk kernel: the chunk-local quadratic and the chunk's
state increment.

Port of ``repro/kernels/ssd.py::ssd_intra_chunk`` (the Pallas
``_ssd_kernel``), with its signature and layouts. Per (batch, head, chunk),
with ``l = cumsum(loglam)`` inside the chunk:

    y_intra[i] = sum_{j <= i} C_i.B_j exp(l_i - l_j) dt_j x_j
    inc        = sum_j exp(l_Q - l_j) dt_j x_j B_j^T

The CUDA kernels of ``csrc/ssd.cu`` run for CUDA tensors and the plain
PyTorch version beside it for CPU tensors, inside a
``torch.autograd.Function`` whose backward recomputes through the plain
version under autograd (the JAX package has no backward kernel for it).
The pure :func:`ssd_plan` picks the path before launch: bf16 ``x/B/C``
with ``Q <= 128`` and ``Q``, ``hd``, ``ds`` multiples of 16 on 16-byte
aligned rows run on tensor cores (``mma.sync``, every f32 operand split
into three bf16 terms, so the products stay exact); everything else on
the f32 CUDA-core kernel. The launch counter records the path by call,
keyed ``(path, B, H, NC, Q, hd, ds)``.

Both differ from the JAX function in one respect, on purpose: the decay
``exp(l_i - l_j)`` is taken only for ``j <= i`` (the upper triangle is set
to ``-inf`` before the exponential), where the JAX code exponentiates the
whole tile and masks after. Above the diagonal ``l_i - l_j`` reaches
hundreds at mamba2-1.3b's ``A`` and ``dt``, the exponential overflows to
inf, and the gradient of the masking ``where`` is then 0·inf = NaN. The
selected values are the same; the port's gradient is finite.

The wrapper reads its inputs through their strides (the model passes
views of its ``(B, S, H, hd)`` activations, not transposed copies); the
outputs are new f32 tensors in the JAX layouts.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

SSD_INTRA_CHUNK = build.counter("ssd_intra_chunk")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"cuda": 0, "tensor": 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# (x, loglam, dt, Bm, Cm, y, inc, strides, B, H, NC, Q, hd, ds, G, dtype, path,
#  sched, n_tasks, smem, stream)
_ARGTYPES = (_P,) * 8 + (_I,) * 9 + (_P, _I, ctypes.c_longlong, _P)
# dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# blocks per SM the CUDA-core path's head grouping aims for (one block fits an SM)
_WAVES = 4
# the tensor-core kernel (csrc/ssd.cu, namespace tc): warps per block, the
# longest chunk, the most tasks per head its schedule holds
TC_WARPS = 16
TC_MAX_Q = 128
TC_MAX_TASKS = 128
# C.B^T, once per block, costs about a quarter of one head's work
_TC_CB_COST = 0.25
# forming one k-tile of M in registers, in mma triples
_TC_M_COST = 2


def smem_bytes(Q: int, hd: int, ds: int) -> int:
    """Shared memory of one block of the CUDA-core kernel (``csrc/ssd.cu``)."""
    r8 = lambda n: (n + 7) // 8 * 8  # noqa: E731
    Q8, hd8 = r8(Q), r8(hd)
    return 4 * (Q * Q8 + Q8 * ds + max(ds * Q8, Q * Q8 + Q * hd8) + 3 * Q8)


def tc_smem_bytes(Q: int, hd: int, ds: int) -> int:
    """Shared memory of one block of the tensor-core kernel (``csrc/ssd.cu``
    ``tc::layout``): B, the C.B^T tiles (f32), x of two heads, x∘w in three
    bf16 terms (C in its place at first), l, dt, w and the schedule."""
    row_x, row_b = 2 * hd + 16, 2 * ds + 16
    n_tiles = (Q // 16) * (Q // 16 + 1) // 2
    return (Q * row_b + 1024 * n_tiles + 2 * Q * row_x + max(3 * Q * row_x, Q * row_b)
            + 12 * Q + TC_MAX_TASKS)


def tc_tasks(Q: int, hd: int, ds: int) -> Tuple[int, ...]:
    """The cost of each task of one head on the tensor-core path, in mma
    triples: y's tasks (16 rows of the chunk x 32 columns of hd; row tile
    ``mi`` sums over ``mi + 1`` k-tiles, each also forming its M fragments,
    counted as two triples), then inc's (16 rows of hd x 64 columns of ds
    over all ``Q/16`` k-tiles), in the kernel's order."""
    QT = Q // 16
    ny, ns = -(-hd // 32), -(-ds // 64)
    y = [(mi + 1) * (min(4, hd // 8 - 4 * nc) + _TC_M_COST) for mi in range(QT)
         for nc in range(ny)]
    inc = [QT * min(8, ds // 8 - 8 * sc) for _ in range(hd // 16) for sc in range(ns)]
    return tuple(y + inc)


def tc_schedule(Q: int, hd: int, ds: int) -> Tuple[int, ...]:
    """The warp of each task (:func:`tc_tasks`): longest first, each to the
    least-loaded warp (the lowest on a tie), so the warps finish a head
    together (at mamba2's Q=128, hd=64, ds=128: 54-64 triples each)."""
    cost = tc_tasks(Q, hd, ds)
    load = [0] * TC_WARPS
    owner = [0] * len(cost)
    for t in sorted(range(len(cost)), key=lambda t: (-cost[t], t)):
        w = min(range(TC_WARPS), key=lambda w: (load[w], w))
        owner[t] = w
        load[w] += cost[t]
    return tuple(owner)


class SsdPlan(NamedTuple):
    """How one call of the SSD kernel runs."""

    path: str  # "tensor" (bf16 mma.sync) or "cuda" (f32 CUDA cores)
    G: int  # heads per block
    grid: Tuple[int, int]  # (B·NC, ceil(H / G))
    smem: int  # dynamic shared memory per block, bytes
    schedule: Tuple[int, ...]  # the warp of each task of a head (tensor path), else ()


def head_group(B: int, H: int, NC: int, sms: int) -> int:
    """Heads per block of the CUDA-core path: enough blocks for ``_WAVES``
    blocks per SM, and as many heads as that allows sharing one C.B^T
    tile."""
    return max(1, min(H, round(B * NC * H / (_WAVES * sms))))


def tc_head_group(B: int, H: int, NC: int, sms: int) -> int:
    """Heads per block of the tensor-core path (one block per SM): the G
    whose waves of blocks finish first, counting each block's C.B^T as a
    quarter head; the larger G on a tie."""
    def span(G):
        return -(-B * NC * -(-H // G) // sms) * (G + _TC_CB_COST)
    return min(range(H, 0, -1), key=span)


def tc_eligible(dtype: torch.dtype, Q: int, hd: int, ds: int, aligned: bool) -> bool:
    """Whether the tensor-core kernel takes the call."""
    return (dtype == torch.bfloat16 and aligned and Q % 16 == 0 and hd % 16 == 0
            and ds % 16 == 0 and 16 <= Q <= TC_MAX_Q and hd >= 16 and ds >= 16
            and len(tc_tasks(Q, hd, ds)) <= TC_MAX_TASKS
            and tc_smem_bytes(Q, hd, ds) <= SMEM_LIMIT)


def ssd_plan(B: int, H: int, NC: int, Q: int, hd: int, ds: int, dtype: torch.dtype, sms: int,
             aligned: bool = True, path: Optional[str] = None) -> SsdPlan:
    """The path, heads per block, grid, shared memory and (tensor path) the
    warps' schedule of one call, before launch: the tensor-core path for
    bf16 ``x/B/C`` with ``Q <= 128`` and ``Q``, ``hd``, ``ds`` multiples of
    16 whose bases and row strides are 16-byte ``aligned``; else the
    CUDA-core path. ``path`` forces one ("cuda" takes any shape it has
    shared memory for; "tensor" only what it takes). A pure function of its
    arguments. Raises for a dtype neither path takes, a forced path that
    cannot run the call, or a shape no path has shared memory for."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    if min(B, H, NC, Q, hd, ds, sms) < 1:
        raise ValueError(f"want B, H, NC, Q, hd, ds, sms >= 1; got {(B, H, NC, Q, hd, ds, sms)}")
    if path not in (None, "cuda", "tensor"):
        raise ValueError(f"unknown path {path!r}")
    tensor = tc_eligible(dtype, Q, hd, ds, aligned)
    if path == "tensor" and not tensor:
        raise ValueError(f"the tensor-core path does not take {dtype} Q={Q} hd={hd} ds={ds} "
                         f"(aligned {aligned}): it wants bf16, Q <= {TC_MAX_Q} and Q, hd, ds "
                         f"multiples of 16 on 16-byte aligned rows")
    if tensor and path != "cuda":
        G = tc_head_group(B, H, NC, sms)
        return SsdPlan("tensor", G, (B * NC, -(-H // G)), tc_smem_bytes(Q, hd, ds),
                       tc_schedule(Q, hd, ds))
    if smem_bytes(Q, hd, ds) > SMEM_LIMIT:
        raise ValueError(f"chunk {Q}, head_dim {hd}, d_state {ds} need {smem_bytes(Q, hd, ds)} "
                         f"bytes of shared memory per block on the CUDA-core path; a block "
                         f"holds at most {SMEM_LIMIT}")
    G = head_group(B, H, NC, sms)
    return SsdPlan("cuda", G, (B * NC, -(-H // G)), smem_bytes(Q, hd, ds), ())


def aligned_rows(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> bool:
    """16-byte aligned bases and row strides of x, Bm and Cm (the
    tensor-core path's cp.async loads); the last axes contiguous."""
    return all(t.stride(-1) == 1 and t.data_ptr() % 16 == 0
               and all((st * t.element_size()) % 16 == 0 for st in t.stride()[:-1])
               for t in (x, Bm, Cm))


def ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm):
    """Plain version, in f32: the JAX kernel's arithmetic, with the decay
    exponentiated below the diagonal only."""
    x32, B32, C32, dt32 = x.float(), Bm.float(), Cm.float(), dt.float()
    Q = x.shape[3]
    l = torch.cumsum(loglam.float(), dim=-1)  # (B, H, NC, Q)
    CB = torch.einsum("bcqs,bcps->bcqp", C32, B32)[:, None]  # (B, 1, NC, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = torch.where(causal, l[..., :, None] - l[..., None, :], float("-inf"))
    M = torch.where(causal, CB * torch.exp(diff), 0.0) * dt32[..., None, :]
    y = M @ x32  # (B, H, NC, Q, hd)
    w = torch.exp(l[..., -1:] - l) * dt32  # (B, H, NC, Q)
    inc = (x32 * w[..., None]).transpose(-1, -2) @ B32[:, None]  # (B, H, NC, hd, ds)
    return y, inc


def _launch(x, loglam, dt, Bm, Cm, path: Optional[str] = None):
    B, H, NC, Q, hd = x.shape
    ds = Bm.shape[-1]
    dev = x.device
    x = x if x.stride(-1) == 1 else x.contiguous()
    Bm = Bm if Bm.stride(-1) == 1 else Bm.contiguous()
    Cm = Cm if Cm.stride(-1) == 1 else Cm.contiguous()
    loglam, dt = loglam.float(), dt.float()
    y = torch.empty((B, H, NC, Q, hd), dtype=torch.float32, device=dev)
    inc = torch.empty((B, H, NC, hd, ds), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, inc.zero_()
    plan = ssd_plan(B, H, NC, Q, hd, ds, x.dtype,
                    torch.cuda.get_device_properties(dev).multi_processor_count,
                    aligned_rows(x, Bm, Cm), path)
    strides = (ctypes.c_longlong * 18)(*x.stride()[:4], *loglam.stride(), *dt.stride(),
                                       *Bm.stride()[:3], *Cm.stride()[:3])
    sched = (ctypes.c_ubyte * max(1, len(plan.schedule)))(*plan.schedule)
    fn = build.bind("ssd", "repro_ssd_intra_chunk", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), loglam.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), inc.data_ptr(), ctypes.addressof(strides), B, H, NC, Q, hd, ds,
             plan.G, _DTYPES[x.dtype], _PATHS[plan.path], ctypes.addressof(sched),
             len(plan.schedule), plan.smem, stream)
    build.check("ssd", "repro_ssd_intra_chunk", err)
    SSD_INTRA_CHUNK.add((plan.path, B, H, NC, Q, hd, ds))
    return y, inc


class _SsdIntraChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, loglam, dt, Bm, Cm):
        ctx.save_for_backward(x, loglam, dt, Bm, Cm)
        if x.device.type == "cpu":
            return ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm)
        return _launch(x, loglam, dt, Bm, Cm)

    @staticmethod
    def backward(ctx, gy, ginc):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            outs = ssd_intra_chunk_plain(*leaves)
            pairs = [(o, g) for o, g in zip(outs, (gy, ginc)) if g is not None]
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True))
        return tuple(next(got) if n else None for n in needs)


def ssd_intra_chunk(
    x: torch.Tensor,  # (B, H, NC, Q, hd) f32 or bf16
    loglam: torch.Tensor,  # (B, H, NC, Q) f32, dt * A (<= 0)
    dt: torch.Tensor,  # (B, H, NC, Q) f32
    Bm: torch.Tensor,  # (B, NC, Q, ds), x's dtype
    Cm: torch.Tensor,  # (B, NC, Q, ds), x's dtype
):
    """Returns (y_intra (B, H, NC, Q, hd) f32, inc (B, H, NC, hd, ds) f32)."""
    if x.dim() != 5 or loglam.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"want x (B,H,NC,Q,hd), loglam/dt (B,H,NC,Q), Bm/Cm (B,NC,Q,ds); got "
                         f"{tuple(x.shape)}, {tuple(loglam.shape)}, {tuple(Bm.shape)}")
    B, H, NC, Q, hd = x.shape
    ds = Bm.shape[-1]
    if loglam.shape != (B, H, NC, Q) or dt.shape != (B, H, NC, Q):
        raise ValueError(f"loglam and dt must be {(B, H, NC, Q)}")
    if Bm.shape != (B, NC, Q, ds) or Cm.shape != (B, NC, Q, ds):
        raise ValueError(f"Bm and Cm must be {(B, NC, Q, ds)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"unsupported dtypes x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if any(t.device != x.device for t in (loglam, dt, Bm, Cm)):
        raise ValueError("x, loglam, dt, Bm and Cm must be on one device")
    if x.device.type == "cuda":  # raises for a shape no path takes, before autograd
        ssd_plan(B, H, NC, Q, hd, ds, x.dtype, 1, aligned_rows(x, Bm, Cm))
    return _SsdIntraChunk.apply(x, loglam, dt, Bm, Cm)
