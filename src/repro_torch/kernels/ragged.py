"""Ragged flat-token kernels: the MoD dispatch of the flat-token forward,
the paged write-back of the mixed prefill+decode step, and flash attention
of a flat query stream over the paged pool.

Port of ``repro/kernels/ragged.py`` (``flat_segment_ids``,
``ragged_gather_rows``, ``ragged_scatter_add_rows``,
``ragged_page_targets``, ``ragged_paged_scatter_rows_pallas``,
``ragged_paged_flash_attention``) and of the matching wrappers in
``repro/kernels/ops.py``. The flat-query paged attention is on no path of
the JAX package's engine or models (their steps gather each slot's context
and run flash attention on it); the port, like JAX, reaches it through its
op entry point (:mod:`repro_torch.kernels.ops`).

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
padded dispatch uses (``routing.gather_launch`` / ``routing.scatter_launch``:
one flat grid over the output's vectors, the scatter in one pass), with
int32 indices, on the stream as one row of ``T`` tokens with ``n_seg·k``
selections (an index outside ``[0, T)`` gives a zero row there and is
dropped by the scatter); the counters record the plan by call, keyed as
``routing``'s. On CPU tensors each runs its plain version, bit for bit the
same.

**Write-back**: :func:`ragged_page_targets` turns (slot, position, valid)
per row into a (physical page, in-page offset) pair, in torch ops; invalid
rows go to the dump (scratch) page at offset 0.
:func:`ragged_paged_scatter_rows` then writes ``pages[pid[w], off[w]] =
rows[w]`` **in place**: the CUDA kernel of ``csrc/paged.cu`` for CUDA
tensors (one flat grid over the rows' vectors, planned by the pure
:func:`scatter_plan`), the plain PyTorch version for CPU tensors, bit for
bit the same
(valid targets are unique by contract; rows that collide on the dump page
are garbage by contract). The quantizing form of
:func:`ragged_paged_scatter_rows_op` quantizes the rows first and writes
the narrow rows and their scales with the same kernel.

**Ragged paged flash attention** (:func:`ragged_paged_flash_attention`):
segment ``s`` owns flat rows ``[row_offsets[s], row_offsets[s+1])`` of the
query stream ``q`` (T, nq, hd) and reads the K/V of slot ``seg_slot[s]``
straight from the pages ``(N, p, nkv, hd)`` through its row of the page
table: no per-slot context is materialized. Masks, GQA, the softmax guards
and the rounding are the Pallas kernel's (``csrc/ragged_attention.cu``
says them in full): wide pages round ``p`` to their dtype before ``p@V``;
int8 / e4m3 pages with ``(N, p, nkv)`` f32 scales are widened and keep
``p`` in f32; a row with no valid key, and every row outside
``[row_offsets[0], row_offsets[-1])``, is 0. The CUDA kernel runs for CUDA
tensors, the plain version (a dense masked softmax per segment) for CPU
tensors; they agree up to f32 summation order and, in bf16, the rounding
of ``p`` against another running maximum. :func:`ragged_attention_plan`
(pure) decides how the kernel runs a call: bf16 queries on tensor cores
(``"mma"``: tiles of (query row, query head) pairs of one kv head, the
slot's context split into fixed key chunks over blocks and merged by a
second launch past one chunk), f32 queries on CUDA cores (``"f32"``).

None of these has autograd (the JAX kernels have no VJP): a tensor that
requires grad raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import aligned16
from repro_torch.kernels.paged import (
    NARROW,
    FlatPlan,
    quant_fold,
    canon_pages,
    canon_rows,
    check_device,
    check_no_grad,
    flat_plan,
)
from repro_torch.kernels.routing import gather_launch, scatter_launch

RAGGED_PAGED_FLASH_ATTENTION = build.counter("ragged_paged_flash_attention")
RAGGED_PAGED_SCATTER_ROWS = build.counter("ragged_paged_scatter_rows")
RAGGED_GATHER_ROWS = build.counter("ragged_gather_rows")
RAGGED_SCATTER_ADD_ROWS = build.counter("ragged_scatter_add_rows")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
NEG_INF = -1e30  # the Pallas kernel's masked score
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_KV_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8",
             torch.float8_e4m3fn: "e4m3"}
_ATTN_HEAD_DIMS = (32, 64, 128, 256)
# (q, k, v, k_scales, v_scales, pos_pages, table, row_offsets, seg_slot,
# q_pos, out, part_m, part_l, part_acc, n_rows, nq, nkv, hd, N, p, B, P,
# n_seg, seg_cap, q_dtype, kv_kind, path, rows, key_tile, chunk, n_chunks,
# grid x, y, z, smem, scale, causal, window, stream)
_ATTN_ARGTYPES = (_P,) * 14 + (_I,) * 21 + (_F, _I, _I, _P)
# the kernel's path codes (csrc/ragged_attention.cu refuses a plan that is
# not its own)
_ATTN_PATHS = {"f32": 0, "mma": 1}
ATTN_SPLIT_ROWS = 16  # one m16 tile: a tile this short splits its chunk's keys over 4 warps
ATTN_TALL_ROWS = 64  # 16 rows a warp
ATTN_F32_KEYS = 32  # keys per warp step of the f32 kernel: one a lane
ATTN_MERGE_WARPS = 4  # (row, head) pairs a block of the merge kernel: a warp each
_GRID_X = 2 ** 31 - 1  # CUDA's limits on gridDim.x and on gridDim.y, z
_GRID_YZ = 65535


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
    out = gather_launch(x[None], idx.view(1, -1), RAGGED_GATHER_ROWS)
    return out.view(tuple(idx.shape) + (x.shape[1],))


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
    n = idx.numel()
    return scatter_launch(x[None], idx.view(1, n), delta.view(1, n, D), gate.view(1, n),
                          RAGGED_SCATTER_ADD_ROWS)[0]


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


def scatter_plan(N: int, W: int, p: int, row_bytes: int, pages_base: int,
                 rows_base: int) -> FlatPlan:
    """The write-back kernel's vector width, block shape, index width and
    grid for ``W`` rows of ``row_bytes`` into ``N`` pages of ``p`` rows,
    the page tensor at address ``pages_base`` and the rows at
    ``rows_base``: the widest of 16, 4 and 1 bytes that divides the row and
    both bases, one vector a thread (``GATHER_UNROLL`` past a card of
    threads), one block per ``GATHER_THREADS · unroll`` of the rows'
    vectors: one flat grid, so a leaf of narrow rows (4-byte positions)
    fills whole blocks instead of one block per row. A pure function of its
    arguments, decided before launch. Raises for what the kernel does not
    take: no page, an empty page or row, a negative count, a grid beyond
    CUDA's."""
    if N < 1 or p < 1 or row_bytes < 1 or W < 0:
        raise ValueError(f"write-back of W={W} rows of {row_bytes} bytes into N={N} pages of "
                         f"{p}: want N, p, row_bytes >= 1 and W >= 0")
    return flat_plan(W, row_bytes, (pages_base, rows_base), "a write-back")


# (pages, pid, off, rows, N, W, p, row_bytes, vec, unroll, wide, blocks, stream)
_SCATTER_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _L, _P)


def ragged_paged_scatter_rows(pages: torch.Tensor, pid: torch.Tensor, off: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """pages (N, p, F), pid/off (W,) int32, rows (W, F); in place. On the
    card one flat grid over the rows' vectors (:func:`scatter_plan`); the
    launch counter records the plan by call, keyed ``(vec, W, row_bytes)``."""
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
    return _scatter_launch(pages, pid.contiguous(), off.contiguous(), rows.contiguous())


def _scatter_launch(pages: torch.Tensor, pid: torch.Tensor, off: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    N, p, F = pages.shape
    W = pid.shape[0]
    if W == 0 or F == 0:
        return pages
    row_bytes = F * pages.element_size()
    plan = scatter_plan(N, W, p, row_bytes, pages.data_ptr(), rows.data_ptr())
    fn = build.bind("paged", "repro_ragged_paged_scatter_rows", _SCATTER_ARGTYPES)
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = fn(pages.data_ptr(), pid.data_ptr(), off.data_ptr(), rows.data_ptr(), N, W, p,
             row_bytes, plan.vec, plan.unroll, int(plan.wide), plan.blocks, stream)
    build.check("paged", "repro_ragged_paged_scatter_rows", err)
    RAGGED_PAGED_SCATTER_ROWS.add((plan.vec, W, row_bytes))
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


# ---------------------------------------------------------------------------
# ragged paged flash attention
# ---------------------------------------------------------------------------


class RaggedAttentionPlan(NamedTuple):
    """How the CUDA kernel runs one call."""

    path: str  # "mma" (bf16 queries, tensor cores) | "f32" (f32 queries, CUDA cores)
    rows: int  # a block's rows: (query row, query head) pairs of one kv head (mma), query rows (f32)
    key_tile: int  # keys per staged K/V tile (mma); per warp step (f32)
    chunk: int  # keys per split of the slot's context, two key tiles (mma); 0 for f32
    n_chunks: int  # ceil(P*p / chunk) (mma); 0 for f32
    grid: Tuple[int, int, int]
    smem: int  # dynamic shared memory of a block, bytes
    scratch: Tuple[Tuple[int, ...], ...]  # f32 partial m, l, acc when the chunks merge, else ()

    @property
    def merge(self) -> bool:
        """A second launch merges the chunks' partial states."""
        return self.n_chunks > 1

    @property
    def kernels(self) -> int:
        """Kernel launches of the call."""
        return 2 if self.merge else 1


def ragged_attention_plan(T: int, nq: int, nkv: int, hd: int, N: int, p: int, B: int, P: int,
                          n_seg: int, seg_cap: int, q_dtype: torch.dtype,
                          kv_dtype: torch.dtype) -> RaggedAttentionPlan:
    """The kernel's path, tiling, key chunks, grid, shared memory and merge
    scratch for ``T`` flat rows of ``nq`` query heads over ``N`` pages of
    ``p`` rows of ``nkv`` kv heads (head dim ``hd``), ``B`` slots of ``P``
    pages, ``n_seg`` segments of at most ``seg_cap`` rows; a pure function
    of these. bf16 queries take the tensor cores (``"mma"``) on bf16, int8
    or e4m3 pages: rows per tile 16 when ``seg_cap`` times the group
    ``nq/nkv`` fits one m16 tile (a decode step), else 64; chunks of two key
    tiles (128 keys, 64 at head dim 256), set by the head dim alone, so the
    chunk boundaries fall at the same key indices whatever the grid; a
    grid of (tile-list entries × chunks, kv heads), the list holding each
    segment's row tiles in order (the kernel finds its entry from the row
    offsets), so a decode segment of a call whose seg_cap is a prefill
    chunk costs one tile, not seg_cap's; one launch when ``P*p`` fits one
    chunk (plus a plane of blocks writing the zero rows), else a merge
    launch and its f32 scratch ``(n_chunks, T, nq)`` twice and
    ``(n_chunks, T, nq, hd)``. f32 queries take the CUDA-core kernel
    (``"f32"``). Raises for what the kernel does not take."""
    if hd not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_ATTN_HEAD_DIMS}")
    if nkv <= 0 or nq % nkv:
        raise ValueError(f"n_heads {nq} is not a multiple of n_kv_heads {nkv}")
    if min(T, N, p, B, P, n_seg, seg_cap) < 1:
        raise ValueError(f"want T, N, p, B, P, n_seg, seg_cap >= 1; got {T}, {N}, {p}, {B}, {P}, "
                         f"{n_seg}, {seg_cap}")
    if max(N * p, P * p, seg_cap * (nq // nkv), T * (nq // nkv)) > _GRID_X:
        raise ValueError(f"N*p={N * p}, P*p={P * p}, seg_cap*group and T*group must fit an "
                         f"int32")
    wide = {torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}
    if q_dtype not in wide:
        raise TypeError(f"q must be float32 or bfloat16, got {q_dtype}")
    if kv_dtype != wide[q_dtype] and kv_dtype not in NARROW:
        raise TypeError(f"{q_dtype} queries take {wide[q_dtype]}, int8 or float8_e4m3fn pages, "
                        f"got {kv_dtype}")
    if q_dtype == torch.float32:
        rows = 8 if hd >= 256 else 16
        grid = (-(-seg_cap // rows), nq, n_seg + 1)
        plan = RaggedAttentionPlan("f32", rows, ATTN_F32_KEYS, 0, 0, grid, 5 * rows * hd * 4, ())
    else:
        key_tile = 32 if hd == 256 else 64  # keys per staged K/V tile
        chunk = 2 * key_tile
        pairs = seg_cap * (nq // nkv)
        rows = ATTN_SPLIT_ROWS if pairs <= ATTN_SPLIT_ROWS else ATTN_TALL_ROWS
        n_chunks = -(-(P * p) // chunk)
        merge = n_chunks > 1
        # entries of the flat tile list (segment s: ceil(min(len_s, seg_cap)·group / rows)
        # tiles): at most seg_cap's tiles a segment, and at most one partial tile a
        # segment past T rows' worth; one launch adds the plane of zero rows
        tiles = min(n_seg * -(-pairs // rows), (T * (nq // nkv) + n_seg * (rows - 1)) // rows)
        grid = (tiles * n_chunks, nkv, 1 if merge else 2)
        ld = hd + 8  # shared bf16 row stride
        smem = (2 * 2 * key_tile * ld * 2 + (2 * chunk + rows) * 4
                + (2 * chunk * 4 if kv_dtype in NARROW else 0))
        part = (n_chunks, T, nq)
        plan = RaggedAttentionPlan("mma", rows, key_tile, chunk, n_chunks, grid, smem,
                                   (part, part, part + (hd,)) if merge else ())
        if merge and -(-(T * nq) // ATTN_MERGE_WARPS) > _GRID_X:
            raise ValueError(f"T={T} rows x {nq} heads exceed the merge kernel's grid")
    x, y, z = plan.grid
    if x > _GRID_X or max(y, z) > _GRID_YZ:
        raise ValueError(f"grid {plan.grid} exceeds CUDA's ({_GRID_X}, {_GRID_YZ}, {_GRID_YZ})")
    return plan


def _check_attention(q, k_pages, v_pages, pos_pages, table, row_offsets, seg_slot, q_pos,
                     seg_cap, k_scales, v_scales) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"want q (T,nq,hd) and k_pages (N,p,nkv,hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    T, nq, hd = q.shape
    N, p, nkv, _ = k_pages.shape
    if k_pages.shape[3] != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages and v_pages must be {(N, p, nkv, hd)}, got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if nkv == 0 or nq % nkv:
        raise ValueError(f"n_heads {nq} is not a multiple of n_kv_heads {nkv}")
    if pos_pages.shape != (N, p) or table.dim() != 2 or row_offsets.dim() != 1 \
            or seg_slot.shape != (row_offsets.shape[0] - 1,) or q_pos.shape != (T,):
        raise ValueError(f"want pos_pages {(N, p)}, table (B,P), row_offsets (n_seg+1,), "
                         f"seg_slot (n_seg,), q_pos {(T,)}; got {tuple(pos_pages.shape)}, "
                         f"{tuple(table.shape)}, {tuple(row_offsets.shape)}, "
                         f"{tuple(seg_slot.shape)}, {tuple(q_pos.shape)}")
    for name, t in (("pos_pages", pos_pages), ("table", table), ("row_offsets", row_offsets),
                    ("seg_slot", seg_slot), ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if seg_cap < 1:
        raise ValueError(f"seg_cap must be >= 1, got {seg_cap}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is None:
        if not k_pages.dtype == v_pages.dtype == q.dtype:
            raise TypeError(f"wide pages must be q's dtype {q.dtype}, got {k_pages.dtype}, "
                            f"{v_pages.dtype}")
    else:
        if k_pages.dtype not in NARROW or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"pages with scales must be int8 or float8_e4m3fn, got "
                            f"{k_pages.dtype}, {v_pages.dtype}")
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.shape != (N, p, nkv) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be {(N, p, nkv)} float32, got {tuple(t.shape)} "
                                 f"{t.dtype}")


def ragged_paged_flash_attention_plain(q, k_pages, v_pages, pos_pages, table, row_offsets,
                                       seg_slot, q_pos, *, seg_cap, causal=True, window=0,
                                       scale=None, k_scales=None, v_scales=None):
    """Plain version: each segment's ``seg_cap`` rows of the stream (the
    Pallas kernel's slice of the zero-padded stream) against its slot's
    whole context gathered through the table, one dense masked softmax
    with the kernel's guards, then every row takes its segment's row (the
    JAX wrapper's clipped gather) and rows outside the segments are 0."""
    T, nq, hd = q.shape
    N, p, nkv, _ = k_pages.shape
    B, P = table.shape
    n_seg, C, dev = seg_slot.shape[0], int(seg_cap), q.device
    scale = float(scale if scale is not None else 1.0 / hd ** 0.5)
    out = torch.zeros_like(q)
    if n_seg == 0 or T == 0:
        return out
    offs = row_offsets.long().clamp(0, T)
    start, seg_len = offs[:-1], offs[1:] - offs[:-1]
    q_f = torch.cat([q.float(), q.new_zeros((C, nq, hd), dtype=torch.float32)])
    qp_f = torch.cat([q_pos, q_pos.new_full((C,), -1)])
    rows = start[:, None] + torch.arange(C, device=dev)  # (n_seg, C)
    qs, qp = q_f[rows], qp_f[rows]  # (n_seg, C, nq, hd), (n_seg, C)
    in_seg = torch.arange(C, device=dev)[None] < seg_len[:, None]
    pid = table.long().clamp(0, N - 1)[seg_slot.long().clamp(0, B - 1)]  # (n_seg, P)
    heads = torch.arange(nq, device=dev) * nkv // nq  # the kv head of each query head

    def context(pages, scales):  # (n_seg, P*p, nq, hd) f32, and the dtype p rounds to
        kv = pages[pid].reshape(n_seg, P * p, nkv, hd).float()
        if scales is not None:
            kv = kv * scales[pid].reshape(n_seg, P * p, nkv)[..., None]
        return kv[:, :, heads]

    k, v = context(k_pages, k_scales), context(v_pages, v_scales)
    kp = pos_pages[pid].reshape(n_seg, P * p)
    s = torch.einsum("schd,skhd->shck", qs, k) * scale  # (n_seg, nq, C, ctx)
    qv, kv = qp[:, None, :, None], kp[:, None, None, :]
    valid = in_seg[:, None, :, None] & (kv >= 0) & (qv >= 0)
    if causal:
        valid = valid & (kv <= qv)
    if window > 0:
        valid = valid & (qv - kv < window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    pr = torch.where(valid, torch.exp(s - m_safe), torch.zeros_like(s))
    l = pr.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if k_scales is None:  # wide pages: p in the page dtype before p@V
        pr = pr.to(v_pages.dtype).float()
    o = (torch.einsum("shck,skhd->shcd", pr, v) / l).to(q.dtype)  # (n_seg, nq, C, hd)
    t = torch.arange(T, device=dev)
    seg = flat_segment_ids(row_offsets, T).long()
    local = (t - offs[seg]).clamp(0, C - 1)
    live = (t >= offs[0]) & (t < offs[-1])
    flat = o[seg, :, local]  # (T, nq, hd)
    return torch.where(live[:, None, None], flat, out)


def ragged_paged_flash_attention(
    q: torch.Tensor,  # (T, nq, hd) flat query stream, f32 or bf16
    k_pages: torch.Tensor,  # (N, p, nkv, hd)
    v_pages: torch.Tensor,  # (N, p, nkv, hd)
    pos_pages: torch.Tensor,  # (N, p) int32 absolute positions; -1 = empty
    table: torch.Tensor,  # (B, P) int32 per-slot page table
    row_offsets: torch.Tensor,  # (n_seg+1,) int32, non-decreasing, starts at 0
    seg_slot: torch.Tensor,  # (n_seg,) int32: the slot whose pages segment s reads
    q_pos: torch.Tensor,  # (T,) int32 absolute positions; -1 = invalid row
    *,
    seg_cap: int,  # every segment has <= seg_cap rows
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (N, p, nkv) f32: narrow pages
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # (T, nq, hd) in q's dtype
    """Flash attention of the flat ragged stream over the paged pool. Wide
    pages are q's dtype; with ``k_scales``/``v_scales`` they are int8 or
    float8_e4m3fn and are widened in the kernel."""
    _check_attention(q, k_pages, v_pages, pos_pages, table, row_offsets, seg_slot, q_pos,
                     seg_cap, k_scales, v_scales)
    scales = [t for t in (k_scales, v_scales) if t is not None]
    tensors = (q, k_pages, v_pages, pos_pages, table, row_offsets, seg_slot, q_pos, *scales)
    check_no_grad(*tensors)
    kw = dict(seg_cap=seg_cap, causal=causal, window=window, scale=scale, k_scales=k_scales,
              v_scales=v_scales)
    if check_device(*tensors) == "cpu":
        return ragged_paged_flash_attention_plain(q, k_pages, v_pages, pos_pages, table,
                                                  row_offsets, seg_slot, q_pos, **kw)
    if q.shape[2] not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[2]} not in {_ATTN_HEAD_DIMS}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    if seg_slot.shape[0] == 0 or table.numel() == 0:
        return out.zero_()
    return _attention_launch(q, k_pages, v_pages, pos_pages, table, row_offsets, seg_slot, q_pos,
                             k_scales, v_scales, out, int(seg_cap), bool(causal), int(window),
                             float(scale if scale is not None else 1.0 / q.shape[2] ** 0.5))


def _attention_launch(q, k_pages, v_pages, pos_pages, table, row_offsets, seg_slot, q_pos,
                      k_scales, v_scales, out, seg_cap, causal, window, scale):
    """The kernel on :func:`ragged_attention_plan`'s plan, which C refuses if
    it is not its own; the merge scratch comes from ``torch.empty``. The
    launch counter records each call keyed (path, T, n_seg, seg_cap, nq,
    nkv, hd, kv kind, chunks, kernel launches of the call)."""
    T, nq, hd = q.shape
    N, p, nkv, _ = k_pages.shape
    B, P = table.shape
    n_seg = seg_slot.shape[0]
    plan = ragged_attention_plan(T, nq, nkv, hd, N, p, B, P, n_seg, seg_cap, q.dtype,
                                 k_pages.dtype)
    q, k_pages, v_pages = aligned16(q), aligned16(k_pages), aligned16(v_pages)
    ints = [t.contiguous() for t in (pos_pages, table, row_offsets, seg_slot, q_pos)]
    scales = [None if t is None else t.contiguous() for t in (k_scales, v_scales)]
    part = [torch.empty(shape, dtype=torch.float32, device=q.device) for shape in plan.scratch]
    fn = build.bind("ragged_attention", "repro_ragged_paged_attention", _ATTN_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             *(None if t is None else t.data_ptr() for t in scales),
             *(t.data_ptr() for t in ints), out.data_ptr(),
             *([t.data_ptr() for t in part] or [None] * 3),
             T, nq, nkv, hd, N, p, B, P, n_seg, seg_cap, _DTYPES[q.dtype],
             _KV_KINDS[k_pages.dtype], _ATTN_PATHS[plan.path], plan.rows, plan.key_tile,
             plan.chunk, plan.n_chunks, *plan.grid, plan.smem, scale, int(causal), window,
             stream)
    build.check("ragged_attention", "repro_ragged_paged_attention", err)
    RAGGED_PAGED_FLASH_ATTENTION.add((plan.path, T, n_seg, seg_cap, nq, nkv, hd,
                                      _KV_NAMES[k_pages.dtype], plan.n_chunks, plan.kernels))
    return out
