"""Quantized KV-cache storage and int8 serving weights.

Port of ``repro/serve/quant.py``, its own copy of the math (the port
imports nothing of the JAX package). The paged pool can hold the
full-attention K/V pages in int8 or fp8 (e4m3) with per-page-row f32
scales beside the page tables; the paged gather widens them back
(:func:`repro_torch.kernels.paged.paged_gather_dequant`).

Scales are powers of two, ``scale = 2 ** ceil(log2(absmax / qmax))``
(qmax 127 for int8, 448 for e4m3), computed from the f32 exponent field
with integer arithmetic (no log2/exp2), so every backend produces the same
bits. Power-of-two scales make the quantize -> dequantize round trip
idempotent: requantizing a round-tripped row reproduces its values exactly.
That is what keeps chunked-prefill chunk boundaries, prefix-cache warm
restores and ragged-vs-padded streams bit-identical on the quantized path.

Granularity ``"page"`` keeps one scale per (physical page, row) over the
whole folded feature dim; ``"head"`` one per (page, row, kv head), i.e.
per trailing ``head_dim`` block of the canonical row. Scales live in
canonical ``(n_pages, page_size, G)`` f32 tensors indexed by physical page.

Every function here returns the JAX package's bits: int8 and e4m3fn bytes
and f32 values (``tests/test_torch_quant.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.params import STACKED
from repro_torch.utils import tree_map

QMAX = {"int8": 127.0, "fp8": 448.0}
KV_MODES = ("none", "int8", "fp8")
GRANULARITIES = ("page", "head")
WEIGHT_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Serving-side quantization policy.

    kv: storage dtype of the full-attention K/V pages in the paged pool:
        ``"none"`` (the model's dtype), ``"int8"`` or ``"fp8"`` (e4m3,
        clipped to +-448).
    granularity: ``"page"`` (one scale per page row) or ``"head"`` (one
        per page row per kv head).
    weights: ``"none"`` or ``"int8"`` (per-tensor pow2 scales; the engine
        keeps the narrow tree and dequantizes it at each model call).
    """

    kv: str = "none"
    granularity: str = "page"
    weights: str = "none"

    def __post_init__(self):
        if self.kv not in KV_MODES:
            raise ValueError(f"QuantConfig.kv must be one of {KV_MODES}, got {self.kv!r}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"QuantConfig.granularity must be one of {GRANULARITIES}, "
                             f"got {self.granularity!r}")
        if self.weights not in WEIGHT_MODES:
            raise ValueError(f"QuantConfig.weights must be one of {WEIGHT_MODES}, "
                             f"got {self.weights!r}")

    @property
    def enabled(self) -> bool:
        return self.kv != "none"

    @property
    def qmax(self) -> float:
        return QMAX[self.kv]

    def kv_dtype(self) -> torch.dtype:
        return torch.int8 if self.kv == "int8" else torch.float8_e4m3fn


def pow2_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Smallest normal power of two >= absmax/qmax, bit-exactly.

    The f32 exponent of ``absmax/qmax``, plus one iff its mantissa is
    nonzero (the ratio is not a power of two itself), clamped to the
    normal range [-126, 127] and reassembled; absmax == 0 gives 1.0. The
    ratio is never negative, so the sign bit is 0 and the shifts can run
    on the int32 view (torch's uint32 shifts are partial). An overflowing
    ratio (inf) clamps to 2^127, as in the JAX package. The divisor is a
    tensor on absmax's device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which is not the IEEE quotient. A
    subnormal ratio counts as 0 (scale 1.0): XLA flushes subnormals to
    zero, so that is the JAX package's scale for it."""
    r = absmax.float() / torch.full((), qmax, dtype=torch.float32, device=absmax.device)
    bits = r.view(torch.int32)
    field = (bits >> 23) & 0xFF
    frac = (bits & 0x7FFFFF) != 0
    e = (field - 127 + frac.to(torch.int32)).clamp(-126, 127)
    s = ((e + 127) << 23).view(torch.float32)
    return torch.where((r > 0) & (field > 0), s, torch.ones_like(s))


_TINY = torch.finfo(torch.float32).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with every subnormal element (|x| < the smallest normal) made
    a zero of its sign. XLA flushes subnormals before it divides, so the JAX
    package quantizes such an element to 0; every divide below that has a
    JAX counterpart flushes its numerator first."""
    return torch.where(x.abs() < _TINY, torch.copysign(torch.zeros_like(x), x), x)


def _narrow(y: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """f32 values already divided by their scale -> the narrow dtype."""
    if qc.kv == "int8":
        return torch.round(y).clamp(-qc.qmax, qc.qmax).to(torch.int8)
    return y.clamp(-qc.qmax, qc.qmax).to(torch.float8_e4m3fn)


def row_scales(x: torch.Tensor, n_groups: int, qc: QuantConfig) -> torch.Tensor:
    """Per-block scales of canonical rows: x ``(..., F)`` -> ``(..., G)``."""
    xb = x.float().abs().reshape(x.shape[:-1] + (n_groups, x.shape[-1] // n_groups))
    return pow2_scale(xb.amax(dim=-1), qc.qmax)


def quant_rows(x: torch.Tensor, scales: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """Quantize canonical rows ``(..., F)`` against ``(..., G)`` scales."""
    g = scales.shape[-1]
    y = _flush(x.float()).reshape(x.shape[:-1] + (g, -1)) / scales[..., None]
    return _narrow(y, qc).reshape(x.shape)


def quantize_rows(x: torch.Tensor, n_groups: int, qc: QuantConfig):
    """(q, scales) of canonical rows ``(..., F)``."""
    s = row_scales(x, n_groups, qc)
    return quant_rows(x, s, qc), s


def dequant_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Widen canonical rows: narrow ``(..., F)`` and ``(..., G)`` scales ->
    f32, ``f32(q) * scale`` per element (the dequant gather kernel's
    arithmetic)."""
    g = scales.shape[-1]
    y = q.float().reshape(q.shape[:-1] + (g, -1)) * scales[..., None]
    return y.reshape(q.shape)


def leaf_groups(leaf_shape, qc: QuantConfig, batch_axis: int = 0) -> int:
    """G of a KV leaf's canonical row fold: 1 per row, or one per trailing
    ``head_dim`` block (the leaf's last axis)."""
    if qc.granularity == "page":
        return 1
    f = 1
    for a, d in enumerate(leaf_shape):
        if a not in (batch_axis, batch_axis + 1):
            f *= d
    return f // leaf_shape[-1]


def roundtrip_leaf(x: torch.Tensor, batch_axis: int, qc: QuantConfig,
                   mask: torch.Tensor = None) -> torch.Tensor:
    """Quantization round trip of a KV leaf in leaf layout
    ``(B, ctx) + tail`` (``batch_axis`` 0 in the port), limited to the
    ``mask`` (B, ctx) rows where one is given. Bit-compatible with the
    pool's canonical-fold quantize: the absmax sees the same elements (max
    is exact in any order) and the rest is elementwise."""
    f32 = x.float()
    if qc.granularity == "head":
        red = (x.dim() - 1,)
    else:
        red = tuple(a for a in range(x.dim()) if a not in (batch_axis, batch_axis + 1))
    s = pow2_scale(f32.abs().amax(dim=red, keepdim=True), qc.qmax)
    rt = (_narrow(_flush(f32) / s, qc).float() * s).to(x.dtype)
    if mask is None:
        return rt
    mshape = [1] * x.dim()
    mshape[batch_axis] = x.shape[batch_axis]
    mshape[batch_axis + 1] = x.shape[batch_axis + 1]
    return torch.where(mask.reshape(mshape), rt, x)


# --- serving-param (weight) quantization -----------------------------------

_QKEY, _SKEY, _DKEY = "__q8__", "__scale__", "__dt__"


def _is_qleaf(x: Any) -> bool:
    return isinstance(x, dict) and _QKEY in x


def _qleaf(p: torch.Tensor, s: torch.Tensor) -> Dict[str, Any]:
    q = torch.round(_flush(p.float()) / s).clamp(-127, 127).to(torch.int8)
    return {_QKEY: q, _SKEY: s, _DKEY: p.dtype}


def _absmax_scale(*ts: torch.Tensor) -> torch.Tensor:
    m = torch.stack([t.float().abs().amax() for t in ts]).amax()
    return pow2_scale(m, QMAX["int8"])


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8-quantize every float leaf with a per-tensor pow2 scale; each
    becomes ``{q, scale, dtype}``, other leaves pass through.

    The JAX package stacks each group leaf over the layer groups (over the
    segments and the groups of a segment for the hybrid; each enc-dec
    encoder leaf over the encoder layers) into one tensor, and so gives it
    one scale; the port keeps a tensor per group. Such a leaf's scale is
    therefore taken over that leaf in every group of every segment, so the
    narrow values and their dequantization are the JAX package's bits."""

    def one(p, s=None):
        if not torch.is_floating_point(p):
            return p
        return _qleaf(p, _absmax_scale(p) if s is None else s)

    out = {k: tree_map(one, v) for k, v in params.items() if k not in STACKED}
    for key in STACKED:
        groups = params.get(key)
        if groups:  # (a hybrid segment is a list of groups)
            blocks = [g for t in groups for g in (t if isinstance(t, list) else [t])]
            scales = tree_map(
                lambda *ts: _absmax_scale(*ts) if torch.is_floating_point(ts[0]) else None,
                blocks[0], *blocks[1:])
            out[key] = tree_map(one, groups, [[scales] * len(t) if isinstance(t, list)
                                              else scales for t in groups])
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Invert :func:`quantize_params` (identity on unquantized trees): a
    fresh wide tree, ``(f32(q) * scale)`` cast to each leaf's dtype."""
    if isinstance(params, dict):
        if _is_qleaf(params):
            return (params[_QKEY].float() * params[_SKEY]).to(params[_DKEY])
        return {k: dequantize_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_params(v) for v in params]
    return params

