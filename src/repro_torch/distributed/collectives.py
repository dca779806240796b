"""The collectives of the mesh engine and the mesh trainer, over
``torch.distributed`` groups.

NCCL takes CUDA tensors for every collective; gloo takes CPU tensors for
every collective but CUDA tensors only for broadcast and a floating-point
sum all-reduce. Every other collective of a CUDA tensor over a gloo group
(two ranks sharing one card, where NCCL refuses to run) is staged through
the host here: the tensor is copied to the CPU, reduced, gathered or sent
there, and copied back. Gloo has no reduce-scatter the port relies on, so
:func:`reduce_scatter` over gloo is a sum all-reduce and the rank's slice.

Results are the same on every rank of a group (a ring all-reduce hands
each rank the same reduced chunks), which the multi-controller engine and
trainer rely on: every rank runs the same routing decisions on the same
values.

Training through a collective needs its adjoint. The autograd functions
come in the conjugate pairs of tensor parallelism and FSDP:

- :func:`copy_to`: identity forward, sum all-reduce backward (before a
  column-parallel product, whose input gradient is partial on each rank);
- :func:`reduce_from`: sum all-reduce forward, identity backward (after a
  row-parallel product, whose output is partial);
- :func:`gather_from`: all-gather forward, the rank's own slice backward
  (D-sharded embedding rows, vocab-sharded logits);
- :func:`gather_params`: all-gather forward, reduce-scatter backward
  (FSDP: a parameter cut over the data axis, gathered for use);
- :func:`sum_over`: the sum over groups in both directions (a global batch
  statistic: every rank's upstream gradient is the same, so the backward
  sum hands each rank ``d`` times its share, and the data-axis mean of the
  ranks' gradients is the gradient of the global statistic).

``torch.distributed.nn.functional.all_reduce`` is none of these: its
backward all-reduces, which multiplies a replicated gradient by the group
size after a row-parallel product.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MAX = dist.ReduceOp.MAX


def _staged(t: torch.Tensor, group: Any) -> bool:
    """Whether a collective other than broadcast and a floating-point sum
    all-reduce on ``t`` has to go through the host: a CUDA tensor over a
    gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group: Any, op: Any = SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (and returned). A CUDA tensor
    over gloo goes through the host unless the op is a floating-point sum."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(t, group) and not (op == SUM and t.is_floating_point()):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in group
    rank order. A CUDA tensor over a gloo group is gathered on the host and
    copied back to its device."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src, group):
        host = src.cpu()
        parts: List[torch.Tensor] = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, and of it this rank's
    chunk along ``dim`` (``t.shape[dim]`` divided by the group size)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    r = dist.get_rank(group)
    size = t.shape[dim] // n
    if dist.get_backend(group) == "gloo":
        full = all_reduce(t.detach().contiguous().clone(), group)
        return full.narrow(dim, r * size, size).contiguous()
    x = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, src: int, group: Any) -> torch.Tensor:
    """``t`` from group rank ``src`` to every rank of ``group``, in place."""
    if dist.get_world_size(group) > 1:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def exchange(t: torch.Tensor, dst: int, src: int, group: Any) -> torch.Tensor:
    """Send ``t`` to group rank ``dst`` and receive a tensor of its shape
    and dtype from group rank ``src`` (a ring shift when every rank calls
    it); the received tensor on ``t``'s device."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    send = t.detach().contiguous()
    if _staged(send, group):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


# ---------------------------------------------------------------------------
# Autograd-aware forms
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.contiguous().clone()
        for group in groups:
            all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            all_reduce(g, group)
        return g, None


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity; the gradient summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over ``group``; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``; the gradient's own slice back."""
    return _GatherFrom.apply(x, dim, group)


def gather_params(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``; the gradient reduce-scattered."""
    return _GatherParams.apply(x, dim, group)


def sum_over(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """The sum of ``x`` over every group in ``groups`` in turn, with the
    same sums in the backward."""
    groups = tuple(g for g in groups if dist.get_world_size(g) > 1)
    if not groups:
        return x
    return _SumOver.apply(x, groups)
