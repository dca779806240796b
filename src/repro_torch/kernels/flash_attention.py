"""Position-masked GQA flash attention, and the fused routed attention of
the ``pallas_fused`` MoD backend.

Port of ``repro/kernels/flash_attention.py``. ``flash_attention``: the
CUDA kernel of ``csrc/flash_attention.cu`` for CUDA tensors, and beside it
a plain PyTorch version of the same function for CPU tensors, both inside
a ``torch.autograd.Function``. The JAX package has no backward kernel for
it (its model trains attention through XLA); the backward here is
:func:`flash_attention_backward`, the counterpart of the JAX blocked
attention's VJP (``models/attention.py::_blocked_bwd``) in torch ops,
from the saved ``(q, k, v, out, lse)``: the kernel also writes the f32 row
log-sum-exp when a gradient is needed. Semantics are the Pallas kernel's:

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

``routed_attention`` (the Pallas ``_routed_attn_kernel``) is described at
its section below.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import apply_rope, rmsnorm, rope_freqs

NEG_INF = -1e30

FLASH_ATTENTION = build.counter("flash_attention")
ROUTED_ATTENTION = build.counter("routed_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P)
# the query block of the backward's loop (bounds its (B, nq, block, Skv) f32
# score tiles, as the JAX blocked VJP's BLOCK_Q does)
BWD_BLOCK_Q = 512


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


def _flash_plain(q, k, v, q_pos, kv_pos, causal, window, scale):
    """Dense version of the kernel's function: the whole score matrix at
    once, with the kernel's max-shift, masking and cast of ``p``. Returns
    ``(out, lse)``; lse is the f32 row log-sum-exp, (B, nq, Sq)."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
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
    lse = (m_safe + torch.log(l))[..., 0].reshape(B, nq, Sq)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, nq, hd), lse


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, kv_pos: torch.Tensor,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (differentiable by autograd)."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _flash_plain(q, k, v, q_pos, kv_pos, causal, window, scale)[0]


def _flash_launch(q, k, v, q_pos, kv_pos, causal, window, scale, want_lse):
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if len({t.device for t in (q, k, v, q_pos, kv_pos)}) != 1:
        raise ValueError("all inputs must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, nq, Sq), dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    if Skv == 0:
        if lse is not None:
            lse.fill_(math.log(1e-30))
        return out.zero_(), lse
    fn = build.bind("flash_attention", "repro_flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        B, Sq, Skv, nq, nkv, hd, _DTYPES[q.dtype], scale,
        int(bool(causal)), int(window), stream,
    )
    build.check("flash_attention", "repro_flash_attention", err)
    FLASH_ATTENTION.launches += 1
    return out, lse


def flash_attention_backward(
    q, k, v, q_pos, kv_pos, out, lse, dout, causal: bool, window: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the position-masked attention, from the forward's
    saved ``out`` and f32 ``lse`` (B, nq, Sq): the flash-attention
    backward identity ``ds = p·(dp − rowsum(dout·out))·scale`` with
    ``p = exp(s − lse)`` recomputed block by block over the queries, in
    f32 torch ops (the JAX blocked VJP, ``_blocked_bwd``). A query row with
    no valid key has p = 0 and gets no gradient, as its output is 0."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1)  # (B, Sq, nq)
    dq = torch.zeros((B, Sq, nq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, nkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, Sq, BWD_BLOCK_Q):
        i1 = min(i0 + BWD_BLOCK_Q, Sq)
        n = i1 - i0
        q_i = qf[:, i0:i1].reshape(B, n, nkv, g, hd)
        do_i = do[:, i0:i1].reshape(B, n, nkv, g, hd)
        s = torch.einsum("bqngh,btnh->bngqt", q_i, kf) * scale
        valid = valid_mask(q_pos[:, i0:i1], kv_pos, causal, window)[:, None, None]
        lse_i = lse[:, :, i0:i1].reshape(B, nkv, g, n)
        p = torch.where(valid, torch.exp(s - lse_i[..., None]), torch.zeros_like(s))
        dv += torch.einsum("bngqt,bqngh->btnh", p, do_i)
        dp = torch.einsum("bqngh,btnh->bngqt", do_i, vf)
        dl_i = delta[:, i0:i1].reshape(B, n, nkv, g).permute(0, 2, 3, 1)  # (B, nkv, g, n)
        ds = p * (dp - dl_i[..., None]) * scale
        dq[:, i0:i1] = torch.einsum("bngqt,btnh->bqngh", ds, kf).reshape(B, n, nq, hd)
        dk += torch.einsum("bngqt,bqngh->btnh", ds, q_i)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, scale):
        want_lse = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out, lse = _flash_plain(q, k, v, q_pos, kv_pos, causal, window, scale)
        else:
            out, lse = _flash_launch(q, k, v, q_pos, kv_pos, causal, window, scale, want_lse)
        if want_lse:
            ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, q_pos, kv_pos, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    scale = float(scale if scale is not None else 1.0 / hd**0.5)
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, bool(causal), int(window), scale)


# ---------------------------------------------------------------------------
# Routed attention: the MoD gather fused into the attention prologue (the
# attention half of the "pallas_fused" backend)
# ---------------------------------------------------------------------------
#
# The Pallas ``_routed_attn_kernel`` gathers the routed rows out of the full
# (B, S, D) residual stream, then RMSNorm -> QKV (+bias) -> RoPE -> masked
# softmax attention over the k routed rows -> out-projection, and returns
# ``a_sub`` and ``h_sub = x_sub + a_sub``. The kernel of
# ``csrc/routed_attention.cu`` computes the same function with the JAX
# mirror's rounding points: the working type after each projection and its
# bias add, after RoPE, for the scores (before the f32 scale), for p before
# p@V, after p@V, after @wo and for h. The mask is the model's
# ``make_mask`` (no q_pos >= 0 test) and the softmax is dense over the
# capacity axis. The backward recomputes through the plain version under
# autograd, as the JAX VJP differentiates its host mirror.


class RoutedAttnSpec(NamedTuple):
    """Static config of the routed-attention kernel."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    scale: float
    causal: bool
    window: int
    rope_theta: float
    pos_emb: str  # "rope" | "none"
    eps: float


_ATTN_KEYS = ("ln", "wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _routed_mask(qpos, kvpos, spec: RoutedAttnSpec) -> torch.Tensor:
    """(B, rows, k) bool: the model's ``make_mask`` (keys must have a
    position; no test on the query position)."""
    valid = kvpos[:, None, :] >= 0
    if spec.causal:
        valid = valid & (kvpos[:, None, :] <= qpos[:, :, None])
    if spec.window > 0:
        valid = valid & (qpos[:, :, None] - kvpos[:, None, :] < spec.window)
    return valid


def _attn_stage(hn, pos, params: Dict[str, torch.Tensor], spec: RoutedAttnSpec):
    """QKV -> RoPE -> masked dense softmax attention -> out-projection on the
    normed routed rows (the JAX ``_attn_stage``; queries and keys are the
    same k rows)."""
    B, k, _ = hn.shape
    nq, nkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dtype = hn.dtype
    q = hn @ params["wq"]
    kk = hn @ params["wk"]
    vv = hn @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        kk = kk + params["bk"]
        vv = vv + params["bv"]
    q = q.reshape(B, k, nq, hd)
    kk = kk.reshape(B, k, nkv, hd)
    vv = vv.reshape(B, k, nkv, hd)
    if spec.pos_emb == "rope":
        q = apply_rope(q, pos, spec.rope_theta)
        kk = apply_rope(kk, pos.clamp_min(0), spec.rope_theta)
    elif spec.pos_emb != "none":
        raise NotImplementedError(f"pos_emb {spec.pos_emb!r}")
    valid = _routed_mask(pos, pos, spec)[:, None, None]  # (B, 1, 1, k, k)
    g = nq // nkv
    qg = q.reshape(B, k, nkv, g, hd)
    # scores in the working type, then f32 (the JAX einsum's output type)
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), kk.float()).to(dtype).float() * spec.scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    o = torch.einsum("bngst,btnh->bsngh", p.float(), vv.float()).to(dtype)
    return o.reshape(B, k, nq * hd) @ params["wo"]


def routed_attention_plain(x, idx, pos_sub, params, spec: RoutedAttnSpec):
    """Plain version (the JAX ``_routed_attention_host``): gather ->
    RMSNorm -> :func:`_attn_stage`. Returns ``(a_sub, h_sub)``."""
    x_sub = torch.take_along_dim(x, idx[..., None], dim=1)
    hn = rmsnorm({"scale": params["ln"]}, x_sub, spec.eps)
    a = _attn_stage(hn, pos_sub, params, spec)
    return a, x_sub + a


_RA_ARGTYPES = (_P,) * 20 + (_I,) * 8 + (_F, _F, _I, _I, _I, _P)


def _routed_attention_launch(x, idx, pos_sub, params, spec: RoutedAttnSpec):
    B, S, D = x.shape
    k = idx.shape[1]
    nq, nkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    dev, dt = x.device, x.dtype
    M = B * k
    x, idx = x.contiguous(), idx.contiguous()
    pos = pos_sub.to(torch.int32).contiguous()
    ps = {key: params[key].contiguous() for key in _ATTN_KEYS if key in params}
    freqs = rope_freqs(hd, spec.rope_theta, dev).contiguous()
    scratch = {
        "xs": (M, D), "hn": (M, D), "q": (M, nq * hd), "k": (M, nkv * hd),
        "v": (M, nkv * hd), "o": (M, nq * hd),
    }
    buf = {name: torch.empty(shape, dtype=dt, device=dev) for name, shape in scratch.items()}
    a = torch.empty((B, k, D), dtype=dt, device=dev)
    h = torch.empty((B, k, D), dtype=dt, device=dev)
    if M == 0:
        return a, h
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = build.bind("routed_attention", "repro_routed_attention", _RA_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        x.data_ptr(), idx.data_ptr(), pos.data_ptr(), ps["ln"].data_ptr(), ps["wq"].data_ptr(),
        ps["wk"].data_ptr(), ps["wv"].data_ptr(), ps["wo"].data_ptr(), ptr(ps.get("bq")),
        ptr(ps.get("bk")), ptr(ps.get("bv")), freqs.data_ptr(), buf["xs"].data_ptr(),
        buf["hn"].data_ptr(), buf["q"].data_ptr(), buf["k"].data_ptr(), buf["v"].data_ptr(),
        buf["o"].data_ptr(), a.data_ptr(), h.data_ptr(),
        B, S, k, D, nq, nkv, hd, _DTYPES[dt], float(spec.eps), float(spec.scale),
        int(bool(spec.causal)), int(spec.window), int(spec.pos_emb == "rope"), stream,
    )
    build.check("routed_attention", "repro_routed_attention", err)
    ROUTED_ATTENTION.launches += 1
    return a, h


class _RoutedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, pos_sub, spec, keys, *tensors):
        params = dict(zip(keys, tensors))
        ctx.save_for_backward(x, idx, pos_sub, *tensors)
        ctx.spec, ctx.keys = spec, keys
        if x.device.type == "cpu":
            return routed_attention_plain(x, idx, pos_sub, params, spec)
        return _routed_attention_launch(x, idx, pos_sub, params, spec)

    @staticmethod
    def backward(ctx, ga, gh):
        x, idx, pos_sub, *tensors = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + tuple(ctx.needs_input_grad[5:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip([x, *tensors], needs)]
            a, h = routed_attention_plain(
                leaves[0], idx, pos_sub, dict(zip(ctx.keys, leaves[1:])), ctx.spec)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad((a, h), wrt, (ga, gh), allow_unused=True))
        grads = [next(got) if n else None for n in needs]
        return (grads[0], None, None, None, None, *grads[1:])


def _check_same(ref: torch.Tensor, named: Dict[str, torch.Tensor]) -> None:
    for name, t in named.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, x on {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {ref.dtype}")


def routed_attention(
    x: torch.Tensor,  # (B, S, D) full residual stream
    idx: torch.Tensor,  # (B, k) int64 routed rows, sorted unique
    pos_sub: torch.Tensor,  # (B, k) int32 original positions of the routed rows
    params: Dict[str, torch.Tensor],  # ln, wq, wk, wv, wo (+ bq, bk, bv)
    spec: RoutedAttnSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-dispatch routed attention. Returns ``(a_sub, h_sub)``: the
    attention contribution on the routed rows and ``x[idx] + a``, both
    (B, k, D); the gathered rows never exist outside the kernel."""
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0] or pos_sub.shape != idx.shape:
        raise ValueError(f"want x (B,S,D), idx and pos_sub (B,k); got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(pos_sub.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if spec.n_heads % spec.n_kv_heads:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    keys = tuple(key for key in _ATTN_KEYS if key in params)
    _check_same(x, {key: params[key] for key in keys})
    if idx.device != x.device or pos_sub.device != x.device:
        raise ValueError("x, idx and pos_sub must be on one device")
    return _RoutedAttention.apply(x, idx, pos_sub, spec, keys, *(params[key] for key in keys))
