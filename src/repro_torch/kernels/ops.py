"""The port's op entry point: one function per op of the JAX package's
``repro/kernels/ops.py``, under the JAX name and in JAX's argument order
(without ``interpret``, which has no counterpart: every op runs where its
tensors lie, the hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors, and raises rather than fall back).

Where the port's own function already has the JAX op's signature, the op
*is* that function (``flash_attention_op``, ``ssd_intra_chunk_op``,
``swiglu_op``, ``ragged_attention_op``, ``ragged_gather_rows_op``,
``ragged_scatter_add_rows_op``). The others are thin adapters onto the
port's functions, which hold the arithmetic: they widen JAX's int32 row
indices to the port's int64, build the port's spec tuples from JAX's
keywords, and move a cache leaf's page axis.

The paged ops take JAX's leaf layout, ``lead + (N, p) + tail`` with the
page axis at ``page_axis``, and fold it as JAX does (page axes first, then
the lead dims, then the tail) into the port's canonical ``(N, p, F)``.
Like the JAX ops they return new tensors and leave their inputs as they
were; the port's engine calls the in-place versions in
:mod:`repro_torch.kernels.paged` and :mod:`repro_torch.kernels.ragged`
directly. ``backend`` (``"xla"`` | ``"pallas"``) is accepted for the
signature and checked; both names launch the same kernel. The tiling
knobs of the Pallas kernels (``block_k``, ``block_s``) change no result
and are accepted and unused.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged as _pg
from repro_torch.kernels import ragged as _rg
from repro_torch.kernels import routing as _rt
from repro_torch.kernels.flash_attention import RoutedAttnSpec, flash_attention, routed_attention
from repro_torch.kernels.ragged import (
    ragged_gather_rows,
    ragged_paged_flash_attention,
    ragged_scatter_add_rows,
)
from repro_torch.kernels.ssd import ssd_intra_chunk
from repro_torch.kernels.swiglu import RoutedMlpSpec, routed_mlp_scatter, swiglu

_BACKENDS = ("xla", "pallas")

flash_attention_op = flash_attention
ssd_intra_chunk_op = ssd_intra_chunk
swiglu_op = swiglu
ragged_attention_op = ragged_paged_flash_attention
ragged_gather_rows_op = ragged_gather_rows
ragged_scatter_add_rows_op = ragged_scatter_add_rows


def on_cpu() -> bool:
    """Whether the ops run their plain versions by default: the port's entry
    points default to CUDA (:func:`repro_torch.device.resolve_device`), so
    this is False wherever a card is present."""
    return not torch.cuda.is_available()


def gather_rows_op(x, idx):
    """MoD row gather (the ``pallas`` backend's dispatch)."""
    return _rt.gather_rows(x, idx.long())


def scatter_add_rows_op(x, idx, delta, gate):
    """MoD gated scatter-add (the ``pallas`` backend's combine)."""
    return _rt.scatter_add_rows(x, idx.long(), delta, gate)


def routed_attention_op(
    x, idx, pos_sub, params, *,
    n_heads, n_kv_heads, head_dim, scale, causal=True, window=0,
    rope_theta=10000.0, pos_emb="rope", eps=1e-5, block_k=None,
):
    """Fused-dispatch routed attention; returns ``(a_sub, h_sub)``."""
    spec = RoutedAttnSpec(n_heads, n_kv_heads, head_dim, float(scale), bool(causal),
                          int(window), float(rope_theta), pos_emb, float(eps))
    return routed_attention(x, idx.long(), pos_sub.to(torch.int32), params, spec)


def routed_mlp_scatter_op(x, h_sub, a_sub, idx, gate, params, *, act="silu", eps=1e-5,
                          block_s=256):
    """Fused-dispatch routed MLP with the gated Eq. 1 scatter-add epilogue."""
    return routed_mlp_scatter(x, h_sub, a_sub, idx.long(), gate, params,
                              RoutedMlpSpec(act, float(eps)))


# ---------------------------------------------------------------------------
# Paged KV-pool ops: JAX leaf layout in, JAX leaf layout out
# ---------------------------------------------------------------------------


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")


def _to_canon(pages: torch.Tensor, page_axis: int) -> torch.Tensor:
    """lead + (N, p) + tail -> a fresh contiguous (N, p) + lead + tail."""
    return pages.movedim((page_axis, page_axis + 1), (0, 1)).clone(
        memory_format=torch.contiguous_format)


def _from_canon(t: torch.Tensor, page_axis: int) -> torch.Tensor:
    """(X, Y) + lead + tail -> lead + (X, Y) + tail."""
    return t.movedim((0, 1), (page_axis, page_axis + 1))


def _canon_rows(rows: torch.Tensor, page_axis: int, dtype=None) -> torch.Tensor:
    """lead + (W,) + tail -> (W, F) in the fold order of the pages."""
    return rows.movedim(page_axis, 0).reshape(rows.shape[page_axis], -1).to(dtype or rows.dtype)


def paged_gather_op(pages, table, *, page_axis=0, backend="xla", scales=None,
                    out_dtype=None):
    """Logical ``lead + (B, P·p) + tail`` view of a paged leaf. With
    ``scales`` (canonical ``(N, p, G)`` f32) the narrow leaf is widened, to
    f32 or ``out_dtype``."""
    _check_backend(backend)
    canon = pages.movedim((page_axis, page_axis + 1), (0, 1)).contiguous()
    table = table.to(torch.int32)
    if scales is None:
        out = _pg.paged_gather_op(canon, table)
    else:
        out = _pg.paged_gather_op(canon, table, scales=scales,
                                  out_dtype=out_dtype or torch.float32)
    return _from_canon(out, page_axis)


def paged_scatter_rows_op(pages, table, rows, pos, *, page_axis=0, backend="xla",
                          scales=None, quant=None):
    """One decode row per slot into its tail page; returns the new pages,
    or ``(new_pages, new_scales)`` with ``scales``/``quant`` (the rows
    quantized against fresh per-row pow2 scales)."""
    _check_backend(backend)
    canon = _to_canon(pages, page_axis)
    table, pos = table.to(torch.int32), pos.to(torch.int32)
    if scales is None:
        _pg.paged_scatter_rows_op(canon, table, _canon_rows(rows, page_axis, canon.dtype), pos)
        return _from_canon(canon, page_axis)
    new_s = scales.clone()
    _pg.paged_scatter_rows_op([canon], table, [_canon_rows(rows, page_axis)], pos,
                              scales=new_s, quant=quant)
    return _from_canon(canon, page_axis), new_s


def ragged_paged_scatter_rows_op(pages, table, rows, slot, pos, valid, *, page_axis=0,
                                 backend="xla", dump_page=1, scales=None, quant=None):
    """Mixed-step write-back of W token rows into their slots' pages;
    invalid rows land on ``dump_page``. Returns the new pages, or
    ``(new_pages, new_scales)`` with ``scales``/``quant``."""
    _check_backend(backend)
    canon = _to_canon(pages, page_axis)
    pid, off = _rg.ragged_page_targets(table.to(torch.int32), slot, pos, valid.bool(),
                                       canon.shape[1], dump_page)
    if scales is None:
        _rg.ragged_paged_scatter_rows_op(canon, pid, off,
                                         _canon_rows(rows, page_axis, canon.dtype))
        return _from_canon(canon, page_axis)
    new_s = scales.clone()
    _rg.ragged_paged_scatter_rows_op([canon], pid, off,
                                     [_canon_rows(rows, page_axis)],
                                     scales=new_s, quant=quant)
    return _from_canon(canon, page_axis), new_s


__all__ = [
    "flash_attention_op", "ssd_intra_chunk_op", "swiglu_op", "gather_rows_op",
    "scatter_add_rows_op", "routed_attention_op", "paged_gather_op", "paged_scatter_rows_op",
    "ragged_attention_op", "ragged_gather_rows_op", "ragged_scatter_add_rows_op",
    "ragged_paged_scatter_rows_op", "routed_mlp_scatter_op", "on_cpu",
]
