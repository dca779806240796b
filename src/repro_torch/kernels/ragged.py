"""Ragged paged write-back: the W token rows of a mixed prefill+decode step
into their slots' pages in one pass.

Port of the write-back part of ``repro/kernels/ragged.py``
(``ragged_page_targets``, ``ragged_paged_scatter_rows_pallas``) and of
``repro/kernels/ops.py::ragged_paged_scatter_rows_op``. The flat-stream
attention and MoD dispatch kernels of that module are not on the engine's
path and are not ported yet.

:func:`ragged_page_targets` turns (slot, position, valid) per row into a
(physical page, in-page offset) pair, in torch ops; invalid rows go to the
dump (scratch) page at offset 0. :func:`ragged_paged_scatter_rows` then
writes ``pages[pid[w], off[w]] = rows[w]`` **in place**: the CUDA kernel of
``csrc/paged.cu`` for CUDA tensors, the plain PyTorch version for CPU
tensors, bit for bit the same (valid targets are unique by contract; rows
that collide on the dump page are garbage by contract). No autograd.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged import (
    canon_pages,
    canon_rows,
    check_device,
    check_no_grad,
)

RAGGED_PAGED_SCATTER_ROWS = build.counter("ragged_paged_scatter_rows")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


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


def ragged_paged_scatter_rows_op(pages: torch.Tensor, pid: torch.Tensor, off: torch.Tensor,
                                 rows: torch.Tensor) -> torch.Tensor:
    """Cache-leaf wrapper: rows ``(W,) + tail`` into a paged leaf
    ``(N, p) + tail`` at precomputed targets (one target computation serves
    every leaf of a step), in place."""
    ragged_paged_scatter_rows(canon_pages(pages), pid, off, canon_rows(rows))
    return pages
