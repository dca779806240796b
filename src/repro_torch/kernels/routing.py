"""MoD routed dispatch kernels: row gather and gated scatter-add (Eq. 1).

Port of ``repro/kernels/routing.py`` (the Pallas ``gather_rows`` and
``scatter_add_rows`` with their custom VJPs). Each wrapper is a
``torch.autograd.Function`` whose forward launches the CUDA kernel of
``csrc/routing.cu`` for a CUDA tensor and runs the plain PyTorch version
beside it for a CPU tensor; on a CUDA tensor it launches or raises, never
falls back. The backwards mirror the JAX VJPs and reuse the same two
kernels (the JAX package has no separate backward kernel): gather's
backward (:func:`gather_rows_vjp`) is the gated scatter-add into zeros with
a unit gate, which on the card is the scatter kernel's zero target (one
launch, no zero tensor); scatter's is ``dx = g``, ``ddelta =
cast(gate·gather(g))`` and ``dgate = Σ_D f32(gather(g))·f32(delta)``.
Indices are int64, unique per row (top-k selections), so both functions
are exact copies/updates: the kernels and the plain versions agree bit for
bit, and both with the JAX one-hot formulation on finite inputs.

The gather runs one block per output row, the scatter one flat grid over
the output's vectors, both planned before launch by the pure
:func:`dispatch_plan` (vector width, threads and vectors a thread, index
width, grid); the launch counters record the plan by call, keyed
``(kind, vec, unroll, B, S, k, row_bytes)``. The ragged dispatch of
``kernels/ragged.py`` launches the same kernels through
:func:`gather_launch` and :func:`scatter_launch` with int32 indices.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged import CARD_THREADS, GATHER_THREADS

GATHER_ROWS = build.counter("gather_rows")
SCATTER_ADD_ROWS = build.counter("scatter_add_rows")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _check_rows(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"want x (B,S,D) and idx (B,k), got {tuple(x.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if idx.device != x.device:
        raise ValueError("x and idx must be on one device")


# ---------------------------------------------------------------------------
# the launch plan: the gather's row grid, the scatter's flat grid
# ---------------------------------------------------------------------------

# vectors a thread (csrc/routing.cu has the same and refuses other plans):
# the gather's, and the zero target's once its output has more vectors
# than the card holds threads (the scatter with x takes one). Every
# scatter block reads its batch rows' k indices once (L2 hits) to build
# its slot map; on an H100 small blocks are faster all the same
# (csrc/routing.cu's header has the readings)
GATHER_UNROLL = 2
SCATTER_UNROLL = 2
_GRID_YZ_MAX = 65535
_INT_MAX = 2 ** 31 - 1
_UINT_MAX = 2 ** 32 - 1
_KINDS = ("gather", "scatter", "scatter_zero")


class DispatchPlan(NamedTuple):
    """How one call of a dispatch kernel runs."""

    kind: str  # "gather", "scatter" (out = x + update) or "scatter_zero" (no x)
    vec: int  # bytes per vector: 16, 4 or 1 (gather); 16, 4 or 2 (bf16 scatter)
    threads: int  # a block's threads
    unroll: int  # vectors a thread, all loaded before any is stored
    idx_bytes: int  # 8 (int64, padded dispatch) or 4 (int32, flat stream)
    wide: bool  # 64-bit vector indices (a scatter over more than 2^32 - 1 vectors)
    grid: Tuple[int, int, int]  # gather: (k, chunks of a row, B); scatter: (blocks, 1, 1)


def dispatch_plan(kind: str, B: int, S: int, k: int, row_bytes: int, elem_bytes: int,
                  idx_bytes: int, bases: Tuple[int, ...]) -> DispatchPlan:
    """The vector width, threads, vectors a thread, index width and grid of
    one dispatch kernel call: ``B`` batch rows of ``S`` rows of ``row_bytes``
    (elements of ``elem_bytes``), ``k`` selections each, with indices of
    ``idx_bytes``, the tensors the kernel reads and writes at addresses
    ``bases``.

    - ``"gather"`` (``B·k`` output rows): the widest of 16, 4 and 1 bytes
      that divides the row and every base (a byte copy); one block per
      output row and chunk of it, its threads the fewest multiple of 32
      that covers the row in :data:`GATHER_UNROLL` vectors a thread, at
      most ``GATHER_THREADS``.
    - ``"scatter"`` / ``"scatter_zero"`` (``B·S`` output rows, with or
      without x): the widest of 16, 4 and ``elem_bytes`` (a vector holds
      whole elements); one flat grid of ``GATHER_THREADS``-thread blocks,
      one vector a thread, or :data:`SCATTER_UNROLL` for the zero target
      once the output has more vectors than ``CARD_THREADS``.

    A pure function of its arguments, decided before launch. Raises for
    what the kernels do not take: an unknown kind or index width, an empty
    row, a negative count, a grid beyond CUDA's."""
    if kind not in _KINDS:
        raise ValueError(f"unknown dispatch kind {kind!r} (want one of {_KINDS})")
    if idx_bytes not in (4, 8):
        raise ValueError(f"indices of {idx_bytes} bytes: want 4 (int32) or 8 (int64)")
    if min(B, S, k) < 0 or row_bytes < 1 or elem_bytes not in (1, 2, 4, 8) \
            or row_bytes % elem_bytes:
        raise ValueError(f"dispatch of B={B} x S={S} rows of {row_bytes} bytes, k={k}: want "
                         "no negative count and a row of whole elements of at least one byte")
    widths = (16, 4, 1) if kind == "gather" else (16, 4, elem_bytes)
    vec = next(v for v in widths if all(b % v == 0 for b in (row_bytes, *bases)))
    vpr = row_bytes // vec
    if kind == "gather":
        threads = min(GATHER_THREADS, 32 * -(-vpr // (32 * GATHER_UNROLL)))
        grid = (k, -(-vpr // (GATHER_UNROLL * threads)), B)
        if k > _INT_MAX or max(grid[1:]) > _GRID_YZ_MAX or vpr > _UINT_MAX:
            raise ValueError(f"a gather of B={B} x k={k} rows of {vpr} vectors needs the grid "
                             f"{grid}, beyond CUDA's")
        return DispatchPlan(kind, vec, threads, GATHER_UNROLL, idx_bytes, False, grid)
    n_vec = B * S * vpr
    unroll = SCATTER_UNROLL if kind == "scatter_zero" and n_vec > CARD_THREADS else 1
    blocks = -(-n_vec // (GATHER_THREADS * unroll))
    if blocks > _INT_MAX or vpr > _UINT_MAX:
        raise ValueError(f"a scatter of {n_vec * vec} bytes in rows of {vpr} vectors needs "
                         f"{blocks} blocks: more than CUDA's {_INT_MAX}")
    return DispatchPlan(kind, vec, GATHER_THREADS, unroll, idx_bytes,
                        blocks * GATHER_THREADS * unroll > _UINT_MAX, (blocks, 1, 1))


# ---------------------------------------------------------------------------
# gather: out[b, i] = x[b, idx[b, i]]
# ---------------------------------------------------------------------------


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``take_along_dim`` over the sequence axis."""
    return torch.take_along_dim(x, idx[..., None], dim=1)


# (x, idx, out, B, S, k, row_bytes, idx_bytes, vec, threads, chunks, stream)
_GATHER_ARGTYPES = (_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _I, _P)


def gather_launch(x: torch.Tensor, idx: torch.Tensor, counter: build.LaunchCounter
                  ) -> torch.Tensor:
    """The gather kernel on contiguous CUDA tensors x (B, S, D), idx (B, k)
    int64 or int32 (an index outside [0, S) gives a zero row): (B, k, D)."""
    B, S, D = x.shape
    k = idx.shape[1]
    out = torch.empty((B, k, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = D * x.element_size()
    plan = dispatch_plan("gather", B, S, k, row_bytes, x.element_size(), idx.element_size(),
                         (x.data_ptr(), out.data_ptr()))
    fn = build.bind("routing", "repro_gather_rows", _GATHER_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, k, row_bytes, plan.idx_bytes,
             plan.vec, plan.threads, plan.grid[1], stream)
    build.check("routing", "repro_gather_rows", err)
    counter.add((plan.kind, plan.vec, plan.unroll, B, S, k, row_bytes))
    return out


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return gather_launch(x.contiguous(), idx.contiguous(), GATHER_ROWS)


# ---------------------------------------------------------------------------
# gated scatter-add: out = x, then out[b, idx] = x[b, idx] + cast(gate * delta)
# ---------------------------------------------------------------------------


def scatter_add_rows_plain(
    x: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor, gate: torch.Tensor
) -> torch.Tensor:
    """Plain version: copy, then write the k routed rows. The gate multiply
    is f32 and the product is cast to x's type before the add."""
    upd = (gate[..., None].float() * delta.float()).to(x.dtype)
    rows = torch.take_along_dim(x, idx[..., None], dim=1) + upd
    out = x.clone()
    out.scatter_(1, idx[..., None].expand(-1, -1, x.shape[2]), rows)
    return out


# (x, idx, delta, gate, out, B, S, k, D, dtype, idx_bytes, vec, unroll, wide, blocks, stream)
_SCATTER_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P)


def scatter_launch(x: Optional[torch.Tensor], idx: torch.Tensor, delta: torch.Tensor,
                   gate: Optional[torch.Tensor], counter: build.LaunchCounter,
                   shape: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The scatter kernel, one launch, on contiguous CUDA tensors: a fresh
    (B, S, D) that is ``x`` with row ``idx[b, i]`` of each batch row ``b``
    replaced by ``x + cast(gate · f32(delta[b, i]))`` (an index outside
    [0, S) is dropped). ``x=None``: the zero target of ``shape``, x read as
    +0; ``gate=None``: a unit gate. idx (B, k) int64 or int32, delta (B, k,
    D) of the output's dtype, gate (B, k) f32."""
    B, S, D = x.shape if x is not None else shape
    k = idx.shape[1]
    out = torch.empty((B, S, D), dtype=delta.dtype, device=delta.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.copy_(x) if x is not None else out.zero_()
    es = out.element_size()
    kind = "scatter" if x is not None else "scatter_zero"
    bases = tuple(t.data_ptr() for t in (x, delta, out) if t is not None)
    plan = dispatch_plan(kind, B, S, k, D * es, es, idx.element_size(), bases)
    fn = build.bind("routing", "repro_scatter_add_rows", _SCATTER_ARGTYPES)
    stream = torch.cuda.current_stream(delta.device).cuda_stream
    err = fn(None if x is None else x.data_ptr(), idx.data_ptr(), delta.data_ptr(),
             None if gate is None else gate.data_ptr(), out.data_ptr(), B, S, k, D,
             _DTYPES[out.dtype], plan.idx_bytes, plan.vec, plan.unroll, int(plan.wide),
             plan.grid[0], stream)
    build.check("routing", "repro_scatter_add_rows", err)
    counter.add((plan.kind, plan.vec, plan.unroll, B, S, k, D * es))
    return out


def _scatter(x, idx, delta, gate) -> torch.Tensor:
    if x.device.type == "cpu":
        return scatter_add_rows_plain(x, idx, delta, gate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (delta.device == gate.device == x.device):
        raise ValueError("x, idx, delta and gate must be on one device")
    return scatter_launch(x.contiguous(), idx.contiguous(), delta.contiguous(),
                          gate.to(torch.float32).contiguous(), SCATTER_ADD_ROWS)


def gather_rows_vjp(idx: torch.Tensor, g: torch.Tensor, x_shape) -> torch.Tensor:
    """Gather's VJP: ``dx`` of ``x_shape``, zeros with ``dx[b, idx[b, i]] =
    0 + cast(1 · g[b, i])``. On the card one launch of the scatter kernel's
    zero target (no zero tensor is made); on the CPU the plain scatter into
    zeros with a unit gate, as the JAX VJP computes it."""
    if g.device.type == "cpu":
        ones = torch.ones(idx.shape, dtype=torch.float32)
        return scatter_add_rows_plain(g.new_zeros(x_shape), idx, g, ones)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return scatter_launch(None, idx.contiguous(), g.contiguous(), None, SCATTER_ADD_ROWS,
                          tuple(x_shape))


# ---------------------------------------------------------------------------
# differentiable wrappers (the JAX custom VJPs)
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        return _gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_vjp(idx, g, ctx.x_shape), None


class _ScatterAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, delta, gate):
        ctx.save_for_backward(idx, delta, gate)
        return _scatter(x, idx, delta, gate)

    @staticmethod
    def backward(ctx, g):
        idx, delta, gate = ctx.saved_tensors
        g_sub = _gather(g.contiguous(), idx).float()  # (B, k, D)
        ddelta = (gate[..., None].float() * g_sub).to(delta.dtype)
        dgate = (g_sub * delta.float()).sum(dim=-1).to(gate.dtype)
        return g, None, ddelta, dgate


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, D), (B, k) int64 -> (B, k, D)."""
    _check_rows(x, idx)
    return _GatherRows.apply(x, idx)


def scatter_add_rows(
    x: torch.Tensor,  # (B, S, D)
    idx: torch.Tensor,  # (B, k) int64, unique per row
    delta: torch.Tensor,  # (B, k, D), x's dtype
    gate: torch.Tensor,  # (B, k) f32 router weights
) -> torch.Tensor:  # (B, S, D)
    _check_rows(x, idx)
    B, S, D = x.shape
    k = idx.shape[1]
    if delta.shape != (B, k, D) or delta.dtype != x.dtype:
        raise ValueError(f"delta must be {(B, k, D)} {x.dtype}, got {tuple(delta.shape)} {delta.dtype}")
    if gate.shape != (B, k):
        raise ValueError(f"gate must be {(B, k)}, got {tuple(gate.shape)}")
    return _ScatterAddRows.apply(x, idx, delta, gate)
