"""Block-paged KV pool kernels: the page gather (plain and dequantizing)
and the decode-row scatter.

Port of ``repro/kernels/paged.py`` (the Pallas ``paged_gather_pallas``,
``paged_gather_dequant_pallas`` and ``paged_scatter_rows_pallas``) and of
their leaf-shape wrappers in ``repro/kernels/ops.py``. A paged cache leaf
stores its position axis as ``(n_pages, page_size)`` physical blocks; a
per-slot page table ``(B, P = ctx // page_size)`` int32 maps logical pages
to physical ones.

- :func:`paged_gather`: ``out[b, i·p + r] = pages[table[b, i], r]``, a
  fresh ``(B, P·p, F)`` tensor (the logical view the decode step reads).
  The kernel runs one flat grid over the output's vectors; the pure
  :func:`gather_plan` picks their width (16, 4 or 1 bytes), the index width
  and the grid before launch, and the launch counter records the plan by
  call, keyed ``(vec, B, P, page_bytes)``.
- :func:`paged_gather_dequant`: the same gather of narrow (int8 / e4m3)
  pages, widened on the way out: ``f32(q) · scale`` with the row's
  ``(N, p, G)`` scale of each ``F/G``-element block, rounded once to the
  output dtype (the JAX f32 result followed by ``astype``).
- :func:`paged_scatter_rows`: ``pages[table[b, pos[b]//p], pos[b]%p] =
  rows[b]``, written **in place** into ``pages`` (the JAX version returns a
  new pool; here only the B rows are written). The kernel runs the ragged
  write-back's flat grid over the rows' vectors, planned by the pure
  :func:`scatter_rows_plan` and counted by call, keyed ``(vec, B,
  row_bytes)``. The quantizing variant of
  :func:`paged_scatter_rows_op` quantizes the rows in torch ops and
  scatters the narrow rows and their scales with this same byte copy.

Each wrapper launches the CUDA kernel of ``csrc/paged.cu`` for CUDA tensors
and runs the plain PyTorch version beside it for CPU tensors; on a CUDA
tensor it launches or raises. Both are copies, so kernel and plain version
agree bit for bit, in any dtype (the kernels copy bytes). Indices are
clamped into range in both. The dequantizing gather is a widen and one
multiply, the same IEEE product in kernel and plain version, so they agree
bit for bit too. There is no autograd: serving never
differentiates (the JAX ops have no VJP), and a wrapper given a tensor that
requires grad raises.

In the port every cache leaf has the slot on axis 0, so a paged leaf is
``(N, p) + tail`` and canonicalising is a reshape to ``(N, p, F)``. The
JAX backend names ``"xla"`` and ``"pallas"`` both launch the kernels on the
card and both run the plain versions on the CPU, so the wrappers take no
backend name (``EngineConfig`` checks it).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

PAGED_GATHER = build.counter("paged_gather")
PAGED_GATHER_DEQUANT = build.counter("paged_gather_dequant")
PAGED_SCATTER_ROWS = build.counter("paged_scatter_rows")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def check_no_grad(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise ValueError("the paged kernels have no gradient: serving never differentiates")


def check_device(*tensors: torch.Tensor) -> str:
    """The device type the tensors share ("cpu" or "cuda")."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all tensors of a paged kernel must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_table(table: torch.Tensor, name: str = "table") -> None:
    if table.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {table.dtype}")


# ---------------------------------------------------------------------------
# gather: out[b, i*p + r] = pages[table[b, i], r]
# ---------------------------------------------------------------------------


def paged_gather_plain(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing of the page axis."""
    N, p, F = pages.shape
    B, P = table.shape
    return pages[table.long().clamp(0, N - 1)].reshape(B, P * p, F)


# the gather kernel's block (csrc/paged.cu has the same constants and
# refuses any other unroll): 256 threads, each with one vector, or with 4
# (all loaded before any is stored) once the output has more vectors than
# the card holds resident threads (H100: 132 SMs x 2048). On an H100 at the
# 1b paged shapes, 4 a thread is fastest for a decode step's (8, 62) table
# of 57 KB pages (1.78M vectors), 1 a thread for a chunked prefill's
# (1, 62) (222K) and for the 64-byte position pages.
GATHER_THREADS = 256
GATHER_UNROLL = 4
CARD_THREADS = 132 * 2048
_INT_MAX = 2 ** 31 - 1
_UINT_MAX = 2 ** 32 - 1


class FlatPlan(NamedTuple):
    """How a flat-grid kernel (the page gather, the ragged write-back) runs
    one call."""

    vec: int  # bytes per vector: 16, 4 or 1
    unroll: int  # vectors per thread: 1 or GATHER_UNROLL
    wide: bool  # 64-bit vector indices (the grid covers more than 2^32 - 1 vectors)
    blocks: int  # blocks of GATHER_THREADS * unroll vectors


def flat_plan(units: int, unit_bytes: int, bases: Tuple[int, ...], what: str) -> FlatPlan:
    """One flat grid over ``units`` pages or rows of ``unit_bytes``: the
    widest of 16, 4 and 1 bytes that divides ``unit_bytes`` and every
    tensor base, one vector a thread or ``GATHER_UNROLL`` once there are
    more vectors than ``CARD_THREADS``, one block per ``GATHER_THREADS ·
    unroll`` vectors. Raises for a grid beyond CUDA's."""
    vec = next(v for v in (16, 4, 1) if all(b % v == 0 for b in (unit_bytes, *bases)))
    n_vec = units * (unit_bytes // vec)
    unroll = GATHER_UNROLL if n_vec > CARD_THREADS else 1
    per_block = GATHER_THREADS * unroll
    blocks = -(-n_vec // per_block)
    if blocks > _INT_MAX:
        raise ValueError(f"{what} of {units * unit_bytes} bytes needs {blocks} blocks, more "
                         f"than CUDA's {_INT_MAX}")
    return FlatPlan(vec, unroll, blocks * per_block > _UINT_MAX, blocks)


def gather_plan(N: int, B: int, P: int, page_bytes: int, base: int) -> FlatPlan:
    """The gather kernel's vector width, block shape, index width and grid
    for ``B·P`` logical pages of ``page_bytes`` out of ``N`` physical ones
    whose tensor starts at address ``base`` (the output is a new
    allocation, 16-byte aligned): the widest of 16, 4 and 1 bytes that
    divides both ``page_bytes`` and ``base``, one vector a thread, or
    ``GATHER_UNROLL`` once the output has more vectors than
    ``CARD_THREADS``, and one block per ``GATHER_THREADS · unroll`` vectors
    of the output. A pure function of its arguments,
    decided before launch. Raises for what the kernel does not take: no
    page to gather from, an empty page, a negative count, a grid beyond
    CUDA's."""
    if min(B, P) < 0 or N < 1 or page_bytes < 1:
        raise ValueError(f"gather of B={B} x P={P} pages of {page_bytes} bytes out of N={N}: "
                         "want N >= 1, page_bytes >= 1 and no negative count")
    return flat_plan(B * P, page_bytes, (base,), "a gather")


def paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pages (N, p, F) any dtype, table (B, P) int32 -> (B, P*p, F)."""
    if pages.dim() != 3 or table.dim() != 2:
        raise ValueError(f"want pages (N,p,F), table (B,P); got {tuple(pages.shape)}, "
                         f"{tuple(table.shape)}")
    _check_table(table)
    check_no_grad(pages)
    if check_device(pages, table) == "cpu":
        return paged_gather_plain(pages, table)
    return _gather_launch(pages.contiguous(), table.contiguous())


# (pages, table, out, N, B, P, page_bytes, vec, unroll, wide, blocks, stream)
_GATHER_ARGTYPES = (_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _L, _P)


def _gather_launch(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    N, p, F = pages.shape
    B, P = table.shape
    out = torch.empty((B, P * p, F), dtype=pages.dtype, device=pages.device)
    if out.numel() == 0:
        return out
    page_bytes = p * F * pages.element_size()
    plan = gather_plan(N, B, P, page_bytes, pages.data_ptr())
    fn = build.bind("paged", "repro_paged_gather", _GATHER_ARGTYPES)
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = fn(pages.data_ptr(), table.data_ptr(), out.data_ptr(), N, B, P, page_bytes, plan.vec,
             plan.unroll, int(plan.wide), plan.blocks, stream)
    build.check("paged", "repro_paged_gather", err)
    PAGED_GATHER.add((plan.vec, B, P, page_bytes))
    return out


# ---------------------------------------------------------------------------
# dequantizing gather: out[b, i*p + r, f] = f32(pages[t, r, f]) * scales[t, r, f // (F/G)]
# ---------------------------------------------------------------------------

NARROW = {torch.int8: 0, torch.float8_e4m3fn: 1}
_OUT = {torch.float32: 0, torch.bfloat16: 1}


def paged_gather_dequant_plain(pages: torch.Tensor, scales: torch.Tensor, table: torch.Tensor,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: gather the narrow pages and their scales, widen with
    :func:`repro_torch.serve.quant.dequant_rows`, cast once."""
    from repro_torch.serve.quant import dequant_rows  # serve imports this module

    return dequant_rows(paged_gather_plain(pages, table),
                        paged_gather_plain(scales, table)).to(out_dtype)


def paged_gather_dequant(pages: torch.Tensor, scales: torch.Tensor, table: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """pages (N, p, F) int8 | float8_e4m3fn, scales (N, p, G) f32, table
    (B, P) int32 -> (B, P*p, F) ``out_dtype`` (f32 or bf16). ``scales`` may
    be a column slice of a wider scale tensor (one layer's heads of a scale
    tensor several layers share): the kernel reads it with its row stride."""
    if pages.dim() != 3 or scales.dim() != 3 or table.dim() != 2 \
            or scales.shape[:2] != pages.shape[:2] or pages.shape[2] % scales.shape[2]:
        raise ValueError(f"want pages (N,p,F), scales (N,p,G) with G | F, table (B,P); got "
                         f"{tuple(pages.shape)}, {tuple(scales.shape)}, {tuple(table.shape)}")
    if pages.dtype not in NARROW:
        raise TypeError(f"pages must be int8 or float8_e4m3fn, got {pages.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _check_table(table)
    check_no_grad(pages, scales)
    if check_device(pages, scales, table) == "cpu":
        return paged_gather_dequant_plain(pages, scales, table, out_dtype)
    pages, table = pages.contiguous(), table.contiguous()
    N, p, F = pages.shape
    G = scales.shape[2]
    if scales.stride(2) != 1 or scales.stride(0) != p * scales.stride(1):
        scales = scales.contiguous()
    B, P = table.shape
    out = torch.empty((B, P * p, F), dtype=out_dtype, device=pages.device)
    if out.numel() == 0:
        return out
    fn = build.bind("paged", "repro_paged_gather_dequant",
                    (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _P))
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = fn(pages.data_ptr(), scales.data_ptr(), table.data_ptr(), out.data_ptr(), N, B, P, p,
             F, G, scales.stride(1), NARROW[pages.dtype], _OUT[out_dtype], stream)
    build.check("paged", "repro_paged_gather_dequant", err)
    PAGED_GATHER_DEQUANT.launches += 1
    return out


# ---------------------------------------------------------------------------
# decode-row scatter, in place: pages[table[b, pos[b]//p], pos[b]%p] = rows[b]
# ---------------------------------------------------------------------------


def _check_scatter(pages: torch.Tensor, rows: torch.Tensor) -> None:
    if not pages.is_contiguous():
        raise ValueError("the page tensor is written in place and must be contiguous")
    if rows.dtype != pages.dtype:
        raise TypeError(f"rows must be {pages.dtype}, got {rows.dtype}")
    check_no_grad(pages, rows)


def paged_scatter_rows_plain(pages: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_put_`` on the ``(N·p, F)`` view. Returns
    ``pages``, updated in place."""
    N, p, F = pages.shape
    B, P = table.shape
    t = pos.long().clamp(0, P * p - 1)
    pid = table.long()[torch.arange(B, device=table.device), t // p].clamp(0, N - 1)
    pages.view(N * p, F).index_put_((pid * p + t % p,), rows)
    return pages


def scatter_rows_plan(N: int, B: int, P: int, p: int, row_bytes: int, pages_base: int,
                      rows_base: int) -> FlatPlan:
    """The decode-row scatter's vector width, block shape, index width and
    grid for ``B`` rows of ``row_bytes`` into ``N`` pages of ``p`` rows
    through ``(B, P)`` page tables, the page tensor at address
    ``pages_base`` and the rows at ``rows_base``: the widest of 16, 4 and 1
    bytes that divides the row and both bases, one flat grid over the rows'
    vectors (:func:`flat_plan`), as the ragged write-back's
    (``kernels/ragged.py::scatter_plan``). A pure function of its
    arguments, decided before launch. Raises for what the kernel does not
    take: no page, an empty page, table or row, a negative count."""
    if N < 1 or P < 1 or p < 1 or row_bytes < 1 or B < 0:
        raise ValueError(f"scatter of B={B} rows of {row_bytes} bytes into N={N} pages of {p} "
                         f"through tables of P={P}: want N, P, p, row_bytes >= 1 and B >= 0")
    return flat_plan(B, row_bytes, (pages_base, rows_base), "a decode-row scatter")


# (pages, table, rows, pos, N, B, P, p, row_bytes, vec, unroll, wide, blocks, stream)
_SCATTER_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _L, _P)


def paged_scatter_rows(pages: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """pages (N, p, F), table (B, P) int32, rows (B, F), pos (B,) int32;
    writes the B rows into ``pages`` in place and returns it."""
    if pages.dim() != 3 or rows.dim() != 2 or rows.shape != (table.shape[0], pages.shape[2]) \
            or pos.shape != (table.shape[0],):
        raise ValueError(f"want pages (N,p,F), table (B,P), rows (B,F), pos (B,); got "
                         f"{tuple(pages.shape)}, {tuple(table.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(pos.shape)}")
    _check_table(table)
    _check_table(pos, "pos")
    _check_scatter(pages, rows)
    if check_device(pages, table, rows, pos) == "cpu":
        return paged_scatter_rows_plain(pages, table, rows, pos)
    return _scatter_rows_launch(pages, table.contiguous(), rows.contiguous(), pos.contiguous())


def _scatter_rows_launch(pages: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    N, p, F = pages.shape
    B, P = table.shape
    if B == 0 or F == 0:
        return pages
    row_bytes = F * pages.element_size()
    plan = scatter_rows_plan(N, B, P, p, row_bytes, pages.data_ptr(), rows.data_ptr())
    fn = build.bind("paged", "repro_paged_scatter_rows", _SCATTER_ARGTYPES)
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = fn(pages.data_ptr(), table.data_ptr(), rows.data_ptr(), pos.data_ptr(), N, B, P, p,
             row_bytes, plan.vec, plan.unroll, int(plan.wide), plan.blocks, stream)
    build.check("paged", "repro_paged_scatter_rows", err)
    PAGED_SCATTER_ROWS.add((plan.vec, B, row_bytes))
    return pages


# ---------------------------------------------------------------------------
# cache-leaf wrappers (repro/kernels/ops.py): the slot/page axis is axis 0
# ---------------------------------------------------------------------------


def canon_pages(pages: torch.Tensor) -> torch.Tensor:
    """(N, p) + tail -> (N, p, F): a view of the contiguous page tensor."""
    return pages.view(pages.shape[0], pages.shape[1], -1)


def canon_rows(rows: torch.Tensor) -> torch.Tensor:
    """(W,) + tail -> (W, F)."""
    return rows.reshape(rows.shape[0], -1)


def paged_gather_op(pages: torch.Tensor, table: torch.Tensor, scales: torch.Tensor = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Logical ``(B, P·p) + tail`` view of a paged leaf ``(N, p) + tail``;
    with ``scales`` (canonical ``(N, p, G)`` f32, a quantized leaf) the
    narrow pages are widened to ``out_dtype`` by the dequantizing gather."""
    B, P = table.shape
    if scales is None:
        out = paged_gather(canon_pages(pages), table)
    else:
        out = paged_gather_dequant(canon_pages(pages), scales, table, out_dtype)
    return out.view((B, P * pages.shape[1]) + tuple(pages.shape[2:]))


def quant_fold(rows, scales, quant):
    """Quantize the canonical rows of one leaf, or of the layers of one
    stacked leaf (a list, folded layer-major into one row as the JAX
    package folds a leaf's lead dims), against fresh per-row pow2 scales.
    Returns (narrow rows per layer, (W, G) scales)."""
    from repro_torch.serve.quant import quantize_rows  # serve imports this module

    rows = [canon_rows(r) for r in rows]
    q, s = quantize_rows(torch.cat(rows, dim=-1), scales.shape[-1], quant)
    return list(q.split([r.shape[-1] for r in rows], dim=-1)), s


def paged_scatter_rows_op(pages, table: torch.Tensor, rows, pos: torch.Tensor,
                          scales: torch.Tensor = None, quant=None):
    """One decode row per slot (``(B,) + tail``) into its tail page, in
    place. With ``scales``/``quant``, ``pages`` and ``rows`` are lists: the
    layers of one stacked leaf, sharing ``scales``. Their rows are quantized
    against fresh per-row pow2 scales, and the narrow rows and their
    ``(B, G)`` scales go to the same targets (the scales tensor is one more
    canonical page tensor, with F = G), both in place."""
    if scales is None:
        paged_scatter_rows(canon_pages(pages), table, canon_rows(rows), pos)
        return pages
    qrows, rscales = quant_fold(rows, scales, quant)
    paged_scatter_rows(scales, table, rscales, pos)
    for pg, q in zip(pages, qrows):
        paged_scatter_rows(canon_pages(pg), table, q.contiguous(), pos)
    return pages
