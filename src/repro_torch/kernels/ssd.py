"""Mamba2 SSD intra-chunk kernel: the chunk-local quadratic and the chunk's
state increment.

Port of ``repro/kernels/ssd.py::ssd_intra_chunk`` (the Pallas
``_ssd_kernel``), with its signature and layouts. Per (batch, head, chunk),
with ``l = cumsum(loglam)`` inside the chunk:

    y_intra[i] = sum_{j <= i} C_i.B_j exp(l_i - l_j) dt_j x_j
    inc        = sum_j exp(l_Q - l_j) dt_j x_j B_j^T

The CUDA kernel of ``csrc/ssd.cu`` runs for CUDA tensors and the plain
PyTorch version beside it for CPU tensors, inside a
``torch.autograd.Function`` whose backward recomputes through the plain
version under autograd (the JAX package has no backward kernel for it).

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

import torch

from repro_torch.kernels import build

SSD_INTRA_CHUNK = build.counter("ssd_intra_chunk")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 8 + (_P,)
# dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# blocks per SM the head grouping aims for (one block fits an SM)
_WAVES = 4


def smem_bytes(Q: int, hd: int, ds: int) -> int:
    """Shared memory of one block of the kernel (``csrc/ssd.cu``)."""
    r8 = lambda n: (n + 7) // 8 * 8  # noqa: E731
    Q8, hd8 = r8(Q), r8(hd)
    return 4 * (Q * Q8 + Q8 * ds + max(ds * Q8, Q * Q8 + Q * hd8) + 3 * Q8)


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


def head_group(B: int, H: int, NC: int, sms: int) -> int:
    """Heads per block: enough blocks for ``_WAVES`` blocks per SM, and
    as many heads as that allows sharing one C.B^T tile."""
    return max(1, min(H, round(B * NC * H / (_WAVES * sms))))


def _launch(x, loglam, dt, Bm, Cm):
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
    G = head_group(B, H, NC, torch.cuda.get_device_properties(dev).multi_processor_count)
    strides = (ctypes.c_longlong * 18)(*x.stride()[:4], *loglam.stride(), *dt.stride(),
                                       *Bm.stride()[:3], *Cm.stride()[:3])
    fn = build.bind("ssd", "repro_ssd_intra_chunk", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), loglam.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), inc.data_ptr(), ctypes.addressof(strides), B, H, NC, Q, hd, ds, G,
             _DTYPES[x.dtype], stream)
    build.check("ssd", "repro_ssd_intra_chunk", err)
    SSD_INTRA_CHUNK.launches += 1
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
    if x.device.type == "cuda" and smem_bytes(Q, hd, ds) > SMEM_LIMIT:
        raise ValueError(f"chunk {Q}, head_dim {hd}, d_state {ds} need "
                         f"{smem_bytes(Q, hd, ds)} bytes of shared memory per block; the "
                         f"kernel holds at most {SMEM_LIMIT}")
    return _SsdIntraChunk.apply(x, loglam, dt, Bm, Cm)
