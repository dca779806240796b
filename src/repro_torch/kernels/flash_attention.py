"""Position-masked GQA flash attention (forward).

Port of ``repro/kernels/flash_attention.py::flash_attention``: the CUDA
kernel of ``csrc/flash_attention.cu`` for CUDA tensors, and beside it a
plain PyTorch version of the same function for CPU tensors. Semantics are
the Pallas kernel's:

- masks come from positions: a (query, key) pair is valid iff both
  positions are >= 0, ``kv_pos <= q_pos`` when causal, and
  ``q_pos - kv_pos < window`` when ``window > 0``;
- query head ``h`` reads kv head ``h * nkv // nq`` (GQA);
- scores and softmax statistics are f32; ``p`` is cast to V's dtype before
  ``p @ V``;
- a query row with no valid key comes out as 0. (The JAX model's dense
  ``attend`` gives the mean of V there instead; only padded query rows hit
  this, and neither value reaches a valid row or a logit.)

The kernel takes any ``Sq``/``Skv`` (the ragged edges are masked), head
dims 32/64/128/256, f32 and bf16.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

FLASH_ATTENTION = build.counter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P)


def valid_mask(
    q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: int
) -> torch.Tensor:
    """(B, Sq, Skv) bool: which (query, key) pairs attend."""
    valid = (kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0)
    if causal:
        valid &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        valid &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return valid


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, kv_pos: torch.Tensor,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense version of the kernel's function: the whole score matrix at
    once, with the kernel's max-shift, masking and cast of ``p``."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else 1.0 / hd**0.5
    qg = q.float().reshape(B, Sq, nkv, g, hd)
    s = torch.einsum("bsngh,btnh->bngst", qg, k.float()) * scale
    valid = valid_mask(q_pos, kv_pos, causal, window)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    # p rounded to V's type, the product accumulated in f32 (the kernel's
    # preferred_element_type)
    pv = torch.einsum("bngst,btnh->bngsh", p.to(v.dtype).float(), v.float())
    out = (pv / l).to(q.dtype)  # (B, nkv, g, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, nq, hd)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, nq, hd)
    k: torch.Tensor,  # (B, Skv, nkv, hd)
    v: torch.Tensor,  # (B, Skv, nkv, hd)
    q_pos: torch.Tensor,  # (B, Sq) int32
    kv_pos: torch.Tensor,  # (B, Skv) int32
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:  # (B, Sq, nq, hd)
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"k/v must be {(B, Skv, nkv, hd)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if nq % nkv:
        raise ValueError(f"n_heads {nq} is not a multiple of n_kv_heads {nkv}")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError("q_pos must be (B, Sq) and kv_pos (B, Skv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}")
    scale = float(scale if scale is not None else 1.0 / hd**0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal, window, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if len({t.device for t in (q, k, v, q_pos, kv_pos)}) != 1:
        raise ValueError("all inputs must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        return out.zero_()
    fn = build.bind("flash_attention", "repro_flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), B, Sq, Skv, nq, nkv, hd, _DTYPES[q.dtype], scale,
        int(bool(causal)), int(window), stream,
    )
    build.check("flash_attention", "repro_flash_attention", err)
    FLASH_ATTENTION.launches += 1
    return out
