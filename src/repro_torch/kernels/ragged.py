"""Ragged flat-token kernels: the MoD dispatch of the flat-token forward,
and the paged write-back of the mixed prefill+decode step.

Port of ``repro/kernels/ragged.py`` (``flat_segment_ids``,
``ragged_gather_rows``, ``ragged_scatter_add_rows``,
``ragged_page_targets``, ``ragged_paged_scatter_rows_pallas``) and of the
matching wrappers in ``repro/kernels/ops.py``. The flat-query paged
attention of that module (``ragged_paged_flash_attention``) is not on any
path of the JAX package's engine or models and is not ported yet.

**MoD dispatch over a flat stream** (``model_forward_ragged``): segments of
several requests are packed on one ``(T, D)`` stream and each selects its
routed rows; ``idx`` is ``(n_seg, k)`` int32 flat row ids, ``-1`` where a
segment is shorter than its capacity.

- :func:`ragged_gather_rows`: ``(n_seg, k, D)`` rows, exact zeros at ``-1``
  (never a clamped neighbour).
- :func:`ragged_scatter_add_rows`: a fresh ``(T, D)`` stream, ``x`` with
  each selected row replaced by ``x + cast(gate · f32(delta))``; ``-1``
  selections are dropped. A fresh tensor, not in place: the forward reads
  the pre-scatter stream again for the routing aux losses.

On CUDA tensors each launches the kernel of ``csrc/routing.cu`` that the
padded dispatch uses, with int32 indices, on the stream as one row of
``T`` tokens with ``n_seg·k`` selections (an index outside ``[0, T)`` gives a zero row there
and is dropped by the scatter); on CPU tensors each runs its plain version,
bit for bit the same.

**Write-back**: :func:`ragged_page_targets` turns (slot, position, valid)
per row into a (physical page, in-page offset) pair, in torch ops; invalid
rows go to the dump (scratch) page at offset 0.
:func:`ragged_paged_scatter_rows` then writes ``pages[pid[w], off[w]] =
rows[w]`` **in place**: the CUDA kernel of ``csrc/paged.cu`` for CUDA
tensors, the plain PyTorch version for CPU tensors, bit for bit the same
(valid targets are unique by contract; rows that collide on the dump page
are garbage by contract). The quantizing form of
:func:`ragged_paged_scatter_rows_op` quantizes the rows first and writes
the narrow rows and their scales with the same kernel.

None of these has autograd (the JAX kernels have no VJP): a tensor that
requires grad raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged import (
    quant_fold,
    canon_pages,
    canon_rows,
    check_device,
    check_no_grad,
)

RAGGED_PAGED_SCATTER_ROWS = build.counter("ragged_paged_scatter_rows")
RAGGED_GATHER_ROWS = build.counter("ragged_gather_rows")
RAGGED_SCATTER_ADD_ROWS = build.counter("ragged_scatter_add_rows")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


# ---------------------------------------------------------------------------
# MoD dispatch over the flat stream
# ---------------------------------------------------------------------------


def flat_segment_ids(row_offsets: torch.Tensor, total: int) -> torch.Tensor:
    """seg_id[t] of every flat row: the segment owning token t (rows past
    ``row_offsets[-1]`` map to the last segment; callers mask them)."""
    offs = row_offsets.to(torch.int32)
    t = torch.arange(total, dtype=torch.int32, device=offs.device)
    n_seg = offs.shape[0] - 1
    ids = torch.searchsorted(offs, t, right=True) - 1
    return ids.clamp(0, n_seg - 1).to(torch.int32)


def _check_dispatch(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"want x (T,D) and idx (n_seg,k), got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")


def _selected(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Which selections address a row of the stream."""
    return (idx >= 0) & (idx < x.shape[0])


def ragged_gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: take from the stream with one zero row appended, every
    selection outside [0, T) pointing at it."""
    T = x.shape[0]
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return xp[torch.where(_selected(x, idx), idx.long(), T)]


def ragged_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (T, D) f32/bf16, idx (n_seg, k) int32 -> (n_seg, k, D)."""
    _check_dispatch(x, idx)
    check_no_grad(x)
    if check_device(x, idx) == "cpu":
        return ragged_gather_rows_plain(x, idx)
    x, idx = x.contiguous(), idx.contiguous()
    T, D = x.shape
    out = torch.empty(tuple(idx.shape) + (D,), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.bind("routing", "repro_gather_rows", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), 1, T, idx.numel(), D,
             x.element_size(), 4, stream)
    build.check("routing", "repro_gather_rows", err)
    RAGGED_GATHER_ROWS.launches += 1
    return out


def ragged_scatter_add_rows_plain(x: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor,
                                  gate: torch.Tensor) -> torch.Tensor:
    """Plain version: copy, then write the selected rows; the gate product
    is f32, cast to x's type, then added in x's type."""
    sel = _selected(x, idx)
    rows = idx[sel].long()
    upd = (gate.float()[sel][:, None] * delta[sel].float()).to(x.dtype)
    out = x.clone()
    out[rows] = x[rows] + upd
    return out


def ragged_scatter_add_rows(x: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor,
                            gate: torch.Tensor) -> torch.Tensor:
    """x (T, D), idx (n_seg, k) int32 (unique where in range), delta
    (n_seg, k, D) x's dtype, gate (n_seg, k) f32 -> a fresh (T, D)."""
    _check_dispatch(x, idx)
    n_seg, k = idx.shape
    D = x.shape[1]
    if delta.shape != (n_seg, k, D) or delta.dtype != x.dtype:
        raise ValueError(f"delta must be {(n_seg, k, D)} {x.dtype}, got {tuple(delta.shape)} "
                         f"{delta.dtype}")
    if gate.shape != (n_seg, k):
        raise ValueError(f"gate must be {(n_seg, k)}, got {tuple(gate.shape)}")
    check_no_grad(x, delta, gate)
    if check_device(x, idx, delta, gate) == "cpu":
        return ragged_scatter_add_rows_plain(x, idx, delta, gate)
    x, idx, delta = x.contiguous(), idx.contiguous(), delta.contiguous()
    gate = gate.to(torch.float32).contiguous()
    if idx.numel() == 0 or x.numel() == 0:
        return x.clone()
    out = torch.empty_like(x)
    fn = build.bind("routing", "repro_scatter_add_rows",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), idx.data_ptr(), delta.data_ptr(), gate.data_ptr(), out.data_ptr(),
             1, x.shape[0], idx.numel(), D, _DTYPES[x.dtype], 4, stream)
    build.check("routing", "repro_scatter_add_rows", err)
    RAGGED_SCATTER_ADD_ROWS.launches += 1
    return out


# ---------------------------------------------------------------------------
# paged write-back of the mixed step
# ---------------------------------------------------------------------------


def ragged_page_targets(table: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor,
                        valid: torch.Tensor, page_size: int, dump_page: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page id, in-page offset) per write row, both (W,) int32;
    invalid rows are routed to ``dump_page`` at offset 0."""
    B, P = table.shape
    pos = pos.long()
    lpage = (pos // page_size).clamp(0, P - 1)
    pid = table[slot.long().clamp(0, B - 1), lpage]
    pid = torch.where(valid, pid, torch.full_like(pid, dump_page)).to(torch.int32)
    off = torch.where(valid, pos % page_size, torch.zeros_like(pos)).to(torch.int32)
    return pid, off


def ragged_paged_scatter_rows_plain(pages: torch.Tensor, pid: torch.Tensor, off: torch.Tensor,
                                    rows: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_put_`` on the ``(N·p, F)`` view. Returns
    ``pages``, updated in place."""
    N, p, F = pages.shape
    fi = pid.long().clamp(0, N - 1) * p + off.long().clamp(0, p - 1)
    pages.view(N * p, F).index_put_((fi,), rows)
    return pages


def ragged_paged_scatter_rows(pages: torch.Tensor, pid: torch.Tensor, off: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """pages (N, p, F), pid/off (W,) int32, rows (W, F); in place."""
    W = pid.shape[0]
    if pages.dim() != 3 or rows.shape != (W, pages.shape[2]) or off.shape != (W,):
        raise ValueError(f"want pages (N,p,F), pid/off (W,), rows (W,F); got "
                         f"{tuple(pages.shape)}, {tuple(pid.shape)}, {tuple(off.shape)}, "
                         f"{tuple(rows.shape)}")
    if pid.dtype != torch.int32 or off.dtype != torch.int32:
        raise TypeError("pid and off must be int32")
    if not pages.is_contiguous():
        raise ValueError("the page tensor is written in place and must be contiguous")
    if rows.dtype != pages.dtype:
        raise TypeError(f"rows must be {pages.dtype}, got {rows.dtype}")
    check_no_grad(pages, rows)
    if check_device(pages, pid, off, rows) == "cpu":
        return ragged_paged_scatter_rows_plain(pages, pid, off, rows)
    pid, off, rows = pid.contiguous(), off.contiguous(), rows.contiguous()
    N, p, F = pages.shape
    if W == 0 or F == 0:
        return pages
    fn = build.bind("paged", "repro_ragged_paged_scatter_rows",
                    (_P, _P, _P, _P, _I, _I, _I, _L, _P))
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = fn(pages.data_ptr(), pid.data_ptr(), off.data_ptr(), rows.data_ptr(), N, W, p,
             F * pages.element_size(), stream)
    build.check("paged", "repro_ragged_paged_scatter_rows", err)
    RAGGED_PAGED_SCATTER_ROWS.launches += 1
    return pages


def ragged_paged_scatter_rows_op(pages, pid: torch.Tensor, off: torch.Tensor, rows,
                                 scales: torch.Tensor = None, quant=None):
    """Cache-leaf wrapper: rows ``(W,) + tail`` into a paged leaf
    ``(N, p) + tail`` at precomputed targets (one target computation serves
    every leaf of a step), in place. With ``scales``/``quant``, ``pages``
    and ``rows`` are lists, the layers of one stacked leaf sharing
    ``scales``: the rows are quantized against fresh per-row pow2 scales
    and the narrow rows and their ``(W, G)`` scales are written to the same
    targets (:func:`repro_torch.kernels.paged.paged_scatter_rows_op`)."""
    if scales is None:
        ragged_paged_scatter_rows(canon_pages(pages), pid, off, canon_rows(rows))
        return pages
    qrows, rscales = quant_fold(rows, scales, quant)
    ragged_paged_scatter_rows(scales, pid, off, rscales)
    for pg, q in zip(pages, qrows):
        ragged_paged_scatter_rows(canon_pages(pg), pid, off, q.contiguous())
    return pages
