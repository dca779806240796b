"""KV-cache pools of the serving engine: contiguous and block-paged.

Port of ``repro/serve/cache.py``. Every cache leaf of the port has the slot
on axis 0 (:func:`repro_torch.models.api.make_caches`), so slot operations
are row copies and a paged leaf is ``(N, p) + tail``.

:class:`CachePool`: one cache tree of fixed shape, ``B`` slots by ``ctx``
positions. MoD-block caches inside it are capacity-sized (``ratio·ctx``),
so the pool's footprint already holds the paper's KV saving
(:meth:`CachePool.cache_bytes`). :meth:`reset` returns a slot to the empty
state (cursors 0, positions -1); :meth:`write_slot` copies a prefilled
batch-1 cache into it. Under a mesh (``spmd`` over a ``DeviceMesh``) the
pool is batch-sharded: a rank holds the ``B/d`` slots of its data group
(:meth:`CachePool.owns`), with its kv heads on the model axis
(:func:`repro_torch.distributed.sharding.cache_placement`).

:class:`PagedCachePool`: the same logical pool with the full-attention KV
rings (``k``/``v``/``pos`` leaves with a ``cursor`` sibling, at full ``ctx``
capacity, not under ``mod``) stored as refcounted ``(n_pages, page_size)``
blocks behind per-slot page tables, with lazy page growth, scrub on
recycle, a sha1-chained prompt-prefix cache with LRU eviction, and
per-leaf-kind accounting. MoD rings and cursors stay slot-contiguous in a
*residual* pool, as do all leaves of the ssm family (the SSD state and the
conv windows have no context axis), so a paged ssm pool maps pages that
hold nothing and serves exactly as the contiguous one (the JAX pool's
behaviour); the hybrid pages its shared block's one full-context ring per
site and keeps its SSM states residual. The decode step reads the logical ``(B, ctx)`` caches
through the paged gather kernel (:func:`paged_materialize`) and writes its
one new row per slot back with the paged scatter kernel
(:func:`paged_writeback`); the ragged mixed step writes its token rows with
the ragged scatter kernel (:func:`paged_writeback_tokens`), and the
speculative round writes its whole window's rows, collected after each
in-window step (:func:`paged_collect_rows`), with the same kernel
(:func:`paged_scatter_rows_q`). :meth:`PagedCachePool.truncate` rolls a
slot's mapping back to the accepted stream.

**Quantized KV** (``quant``, :mod:`repro_torch.serve.quant`): the float
``k``/``v`` page tensors are int8 or e4m3, with f32 scales indexed by
physical page beside them, so prefix sharing and refcounts carry the
scales; positions stay int32 and the MoD rings stay full precision. The
JAX package stacks each leaf over the layer groups and quantizes the
stacked leaf: one scale per page row across all of its layers (``page``)
or one per layer and kv head (``head``). The port keeps a page tensor per
layer but one ``(N, p, G)`` scale tensor per stacked leaf
(:class:`QuantLeaf`), folds the layers' rows into one canonical row in the
same layer-major order before it quantizes, and hands each layer its
columns of the scales to widen with, so pages, scales and streams are the
JAX package's. Reads widen through the dequantizing gather kernel; writes
quantize in torch ops and copy the narrow rows and scales with the
scatter kernels; :func:`quant_roundtrip` puts rows written outside the
pool (chunked-prefill chunks) through the same round trip.

The JAX pool is immutable; this one is updated in place. Where JAX copies
implicitly, the port copies explicitly: residual snapshots (prefix entries,
ragged segments) and the residual rows of :meth:`PagedCachePool.read_slot`
are clones, and restoring a snapshot copies it into the working cache, so
no later write can reach a stored entry.

:meth:`PagedCachePool.hold_pages` takes pages out of circulation and
:meth:`PagedCachePool.release_held` returns them (the ``page_exhaustion``
fault of :mod:`repro_torch.serve.faults`); held pages count in
``page_stats()`` and in :meth:`PagedCachePool.check_invariants`, the
recount of every book that the fault soaks run after each step.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.paged import canon_pages, paged_gather_op, paged_scatter_rows_op
from repro_torch.kernels.ragged import ragged_page_targets, ragged_paged_scatter_rows_op
from repro_torch.models import api
from repro_torch.serve.quant import QuantConfig, leaf_groups, quantize_rows, roundtrip_leaf

Params = Dict[str, Any]
Keys = Tuple[Any, ...]


def _leaves(tree: Any, keys: Keys = ()) -> Iterator[Tuple[Keys, torch.Tensor]]:
    """(key path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for name, v in tree.items():
            yield from _leaves(v, keys + (name,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (i,))
    else:
        yield keys, tree


def flatten(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in _leaves(tree)]


def unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in :func:`flatten` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte tensor as uint8 (PyTorch's index_copy_ has no float8
    kernel; a copy of the bytes is the same copy)."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


class CachePool:
    """Fixed-shape (B, ctx) cache pool with per-slot reset/write; over a
    mesh, this rank's (B/d, ctx) share of it."""

    def __init__(self, cfg: ModelConfig, batch_size: int, ctx: int, device: torch.device,
                 spmd: Optional[SH.ShardCtx] = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.ctx = ctx
        self.device = device
        self.spmd = spmd if spmd is not None and spmd.spmd else None
        # the slots this rank holds: [row0, row0 + rows) of the global batch
        self.rows = batch_size // self.spmd.data_shards if self.spmd else batch_size
        self.row0 = self.spmd.data_rank * self.rows if self.spmd else 0
        self._cache_cfg = SH.local_cache_config(cfg, self.spmd)
        self._ssm_heads = SH.local_ssm_heads(cfg, self.spmd)
        self.caches = self.fresh(self.rows)
        self._template = self.fresh()

    def owns(self, slot: int) -> bool:
        """Whether this rank holds the slot's rows (always, off a mesh)."""
        return self.row0 <= slot < self.row0 + self.rows

    def owner(self, slot: int) -> int:
        """The data rank that holds the slot."""
        return slot // self.rows

    def fresh(self, rows: int = 1) -> Params:
        """An empty cache tree of ``rows`` rows at this rank's heads
        (prefill writes a batch-1 tree in place)."""
        return api.make_caches(self._cache_cfg, rows, self.ctx, self.device,
                               ssm_heads=self._ssm_heads)

    def reset(self, slot: int) -> None:
        """Return the slot's cache rows to their initial (empty) state (a
        slot another rank holds: nothing to do here)."""
        if self.owns(slot):
            self.write_slot(slot, self._template)

    def write_slot(self, slot: int, sub_caches: Params) -> None:
        """Copy a batch-1 cache tree (same structure) into a slot's rows."""
        if not self.owns(slot):
            raise ValueError(f"slot {slot} is held by data rank {self.owner(slot)}, not this "
                             f"rank (slots {self.row0}..{self.row0 + self.rows - 1})")
        for dst, src in zip(flatten(self.caches), flatten(sub_caches)):
            dst[slot - self.row0].copy_(src[0])

    def cache_bytes(self) -> Dict[str, float]:
        """Pool footprint, split by routed ("mod") vs full-capacity leaves,
        and into ``kv_bytes`` (the leaves a paged pool would page) and
        ``resid_bytes`` (the rest), as the paged pool reports them."""
        sizes = {"total": 0.0, "mod": 0.0, "full": 0.0, "kv_bytes": 0.0, "resid_bytes": 0.0}
        pageable = set(paged_leaf_ids(self._template, self.ctx))
        for i, (keys, leaf) in enumerate(_leaves(self.caches)):
            b = float(leaf.numel() * leaf.element_size())
            sizes["total"] += b
            sizes["mod" if "mod" in keys else "full"] += b
            sizes["kv_bytes" if i in pageable else "resid_bytes"] += b
        sizes["mod_vs_full_ratio"] = sizes["mod"] / sizes["full"] if sizes["full"] else 0.0
        return sizes


# ---------------------------------------------------------------------------
# Block-paged pool
# ---------------------------------------------------------------------------

# Reserved physical pages. NULL backs every *unmapped* logical page of an
# active slot: its content is the pristine template (positions -1, so
# attention masks it out) and it is never written — active slots only write
# at their own positions, which always land in mapped pages. SCRATCH backs
# the page tables of FREE slots: the shared decode step still "writes"
# their (inactive, pos=0) rows somewhere, and scratch absorbs that garbage
# without ever being read by a live request.
NULL_PAGE = 0
SCRATCH_PAGE = 1
_RESERVED = 2
# each prefix entry pins a batch-1 residual snapshot in device memory, so
# the registry is capacity-bounded, not only pressure-evicted
PREFIX_MAX_ENTRIES = 64


def paged_leaf_ids(template: Params, ctx: int) -> List[int]:
    """Flat-leaf indices of the *pageable* leaves of a cache tree: the
    position-addressed ring leaves ("k"/"v"/"pos" with a "cursor" sibling)
    at full ``ctx`` capacity — the full-attention rings, whose write cursor
    equals the absolute position. MoD routed rings (capacity-sized, under
    "mod") and the cursors stay in the residual pool."""
    entries = list(_leaves(template))
    paths = {keys for keys, _ in entries}
    ids = []
    for i, (keys, leaf) in enumerate(entries):
        if "mod" in keys or keys[-1] not in ("k", "v", "pos"):
            continue
        if keys[:-1] + ("cursor",) not in paths:
            continue
        if leaf.dim() < 2 or leaf.shape[1] != ctx:
            continue
        ids.append(i)
    return ids


@dataclasses.dataclass(frozen=True)
class QuantLeaf:
    """One leaf of the JAX package's cache tree stored narrow: the
    positions (in paged-leaf order, layer-major) of its per-layer leaves in
    the port, the scale groups ``G`` of its scale tensor, and the wide
    dtype it widens back to."""

    js: Tuple[int, ...]
    groups: int
    dtype: torch.dtype

    def columns(self, layer: int, granularity: str) -> slice:
        """The scale columns of one of its layers: the one shared column
        (``page``), or that layer's kv heads (``head``)."""
        if granularity == "page":
            return slice(0, self.groups)
        per = self.groups // len(self.js)
        return slice(layer * per, (layer + 1) * per)


def quant_leaf_plan(template: Params, paged_ids: List[int], quant: Optional[QuantConfig]
                    ) -> Tuple[QuantLeaf, ...]:
    """The pool's narrow leaves (JAX ``_quant_leaf_plan``): only the float
    ``k``/``v`` rings quantize; ``pos`` is int32 and stays exact (the
    attention mask reads it), and the MoD rings are not paged. Per-layer
    leaves that are one JAX leaf (the same path in every layer group) form
    one :class:`QuantLeaf`; ``G`` is the JAX leaf's, folded over its layer
    lead dim."""
    if quant is None or not quant.enabled:
        return ()
    entries = list(_leaves(template))
    stacks: "OrderedDict[Keys, List[int]]" = OrderedDict()
    for j, i in enumerate(paged_ids):
        keys, leaf = entries[i]
        if keys[-1] not in ("k", "v") or not leaf.is_floating_point():
            continue
        stacks.setdefault(tuple(k for k in keys if not isinstance(k, int)), []).append(j)
    plan = []
    for js in stacks.values():
        shape = tuple(entries[paged_ids[js[0]]][1].shape)  # (1, ctx) + tail
        stacked = (len(js),) + shape  # the JAX leaf: lead + (B, ctx) + tail
        plan.append(QuantLeaf(tuple(js), leaf_groups(stacked, quant, 1),
                              entries[paged_ids[js[0]]][1].dtype))
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Static leaf layout of a paged pool: which flat leaves are paged and
    which residual, the page size, and the narrow leaves of a quantized
    pool (one scale tensor per :class:`QuantLeaf`, in order)."""

    paged_ids: Tuple[int, ...]
    resid_ids: Tuple[int, ...]
    page_size: int
    quant: Optional[QuantConfig] = None
    qleaves: Tuple[QuantLeaf, ...] = ()

    def scale_views(self, scales: List[torch.Tensor]) -> Dict[int, Tuple[torch.Tensor, Any]]:
        """{paged position j -> (its columns of its scale tensor, wide dtype)}."""
        out = {}
        for m, ql in enumerate(self.qleaves):
            for layer, j in enumerate(ql.js):
                out[j] = (scales[m][:, :, ql.columns(layer, self.quant.granularity)], ql.dtype)
        return out

    def plain_ids(self) -> List[int]:
        """Paged positions stored in their own dtype."""
        q = {j for ql in self.qleaves for j in ql.js}
        return [j for j in range(len(self.paged_ids)) if j not in q]


def paged_materialize(spec: PoolSpec, like: Params, pages: List[torch.Tensor],
                      scales: List[torch.Tensor], resid: List[torch.Tensor],
                      table: torch.Tensor) -> Params:
    """Logical (B, ctx) cache tree from paged + residual storage: paged
    leaves are fresh gathers (paged gather kernel; narrow leaves widen
    through the dequantizing gather), residual leaves are the pool's own
    tensors, so in-place cache writes update the residual pool."""
    views = spec.scale_views(scales)
    leaves: List[Any] = [None] * (len(spec.paged_ids) + len(spec.resid_ids))
    for j, i in enumerate(spec.paged_ids):
        if j in views:
            sc, dt = views[j]
            leaves[i] = paged_gather_op(pages[j], table, scales=sc, out_dtype=dt)
        else:
            leaves[i] = paged_gather_op(pages[j], table)
    for j, i in enumerate(spec.resid_ids):
        leaves[i] = resid[j]
    return unflatten(like, leaves)


def paged_writeback(spec: PoolSpec, caches: Params, pages: List[torch.Tensor],
                    scales: List[torch.Tensor], table: torch.Tensor, pos: torch.Tensor) -> None:
    """Write the decode step's new rows into the pages, in place. The step
    writes each paged leaf at exactly one logical position per slot, its
    absolute ``pos`` (full-capacity rings write at their cursor, and
    cursor == pos for them), so only that row is scattered (paged scatter
    kernel); narrow leaves scatter quantized rows and their fresh scales.
    The residual leaves were updated in place already."""
    leaves = flatten(caches)
    rows_b = torch.arange(pos.shape[0], device=pos.device)

    def rows(j):
        return leaves[spec.paged_ids[j]][rows_b, pos.long()]

    for j in spec.plain_ids():
        paged_scatter_rows_op(pages[j], table, rows(j), pos)
    for m, ql in enumerate(spec.qleaves):
        paged_scatter_rows_op([pages[j] for j in ql.js], table, [rows(j) for j in ql.js], pos,
                              scales=scales[m], quant=spec.quant)


def _scatter_rows(spec: PoolSpec, row_of, pages: List[torch.Tensor],
                  scales: List[torch.Tensor], table: torch.Tensor, slot: torch.Tensor,
                  pos: torch.Tensor, valid: torch.Tensor) -> None:
    """One ragged scatter per paged leaf j of ``row_of(j)`` (W,) + tail to
    logical (``slot``, ``pos``), at targets computed once (narrow leaves:
    quantized rows, and their scales once per scale tensor); invalid rows
    land on SCRATCH_PAGE. ``row_of`` makes each leaf's rows as they are
    scattered, so only one leaf's rows live at a time."""
    pid, off = ragged_page_targets(table, slot, pos, valid, spec.page_size, SCRATCH_PAGE)
    for j in spec.plain_ids():
        ragged_paged_scatter_rows_op(pages[j], pid, off, row_of(j))
    for m, ql in enumerate(spec.qleaves):
        ragged_paged_scatter_rows_op([pages[j] for j in ql.js], pid, off,
                                     [row_of(j) for j in ql.js], scales=scales[m],
                                     quant=spec.quant)


def paged_scatter_rows_q(spec: PoolSpec, rows: List[torch.Tensor], pages: List[torch.Tensor],
                        scales: List[torch.Tensor], table: torch.Tensor, slot: torch.Tensor,
                        pos: torch.Tensor, valid: torch.Tensor) -> None:
    """Scatter row stacks into the pages, in place: ``rows[j]`` (W,) + tail
    of paged leaf j goes to logical (``slot``, ``pos``); invalid rows land
    on SCRATCH_PAGE. The speculative round calls it with the rows it
    collected step by step (:func:`paged_collect_rows`)."""
    _scatter_rows(spec, rows.__getitem__, pages, scales, table, slot, pos, valid)


def paged_writeback_tokens(spec: PoolSpec, caches: Params, pages: List[torch.Tensor],
                           scales: List[torch.Tensor], table: torch.Tensor, slot: torch.Tensor,
                           pos: torch.Tensor, valid: torch.Tensor) -> None:
    """Ragged-step write-back: an arbitrary flat list of (slot, pos) token
    rows — the step's decode rows plus every prefill-segment token — goes
    from the updated logical caches into the pages."""
    leaves = flatten(caches)
    ctx = table.shape[1] * spec.page_size
    pos_c = pos.long().clamp(0, ctx - 1)
    slot_c = slot.long().clamp(0, table.shape[0] - 1)

    def rows(j):
        return leaves[spec.paged_ids[j]][slot_c, pos_c]

    _scatter_rows(spec, rows, pages, scales, table, slot, pos, valid)


def paged_collect_rows(spec: PoolSpec, caches: Params, pos: torch.Tensor) -> List[torch.Tensor]:
    """Each slot's row at ``pos[b]`` of every paged leaf of a logical cache
    tree: a list of (B,) + tail tensors (copies). The speculative round
    calls it after every in-window step, because a later step at ``pos + j
    >= ctx`` wraps the ring and would overwrite the row before a collection
    after the window could read it. Positions out of range clip to the
    last row; the caller masks them out of the scatter."""
    leaves = flatten(caches)
    b = torch.arange(pos.shape[0], device=pos.device)
    out = []
    for i in spec.paged_ids:
        ctx = leaves[i].shape[1]
        out.append(leaves[i][b, pos.long().clamp(0, ctx - 1)])
    return out


def quant_roundtrip(spec: PoolSpec, caches: Params, mask: torch.Tensor) -> None:
    """Round-trip the narrow leaves of a logical cache tree through the
    pool's narrow dtype, in place, limited to the ``mask`` (B, ctx)
    positions; nothing to do on an unquantized pool. The engine calls it at
    every quantization boundary that is not a pool write (the end of each
    chunked-prefill chunk), so the working cache holds exactly what a
    write and a read of those rows would give; pow2 idempotency then makes
    the eventual write reproduce these values. Each stacked leaf's layers
    go through together (the JAX leaf's round trip, batch axis 1)."""
    if not spec.qleaves:
        return
    leaves = flatten(caches)
    for ql in spec.qleaves:
        layers = [leaves[spec.paged_ids[j]] for j in ql.js]
        rt = roundtrip_leaf(torch.stack(layers), 1, spec.quant, mask=mask)
        for leaf, new in zip(layers, rt):
            leaf.copy_(new)


def slot_slice(caches: Params, slot: int) -> Params:
    """Batch-1 view of one slot of a cache tree. The port's cache writes are
    in place, so work on the view *is* the JAX ``slot_update`` of its
    result: no copy either way."""
    return unflatten(caches, [leaf[slot:slot + 1] for leaf in flatten(caches)])


@dataclasses.dataclass
class PrefixEntry:
    """One memoized chunk-aligned prompt prefix: the shared physical pages
    holding its full-attention KV, and a batch-1 clone of the residual
    state at the boundary (MoD rings + cursors), so a restore reproduces the
    exact chunked-prefill state — reuse is bit-identical to recomputing."""

    n_tokens: int
    pages: Tuple[int, ...]
    resid: Dict[int, torch.Tensor]  # flat-leaf index -> batch-1 leaf value


class PagedCachePool:
    """Block-paged KV pool: page tables + free list + prefix cache.

    Full-attention KV leaves are stored as ``(n_pages, page_size) + tail``
    physical blocks shared by all slots; each slot owns a logical page-table
    row of ``P = ctx // page_size`` entries, kept on the host (``table_np``)
    and uploaded as int32 each step (:meth:`device_table`). Everything else
    stays in the slot-contiguous residual pool."""

    def __init__(self, cfg: ModelConfig, batch_size: int, ctx: int, page_size: int,
                 device: torch.device, n_pages: Optional[int] = None,
                 prefix_chunk: Optional[int] = None, quant: Optional[QuantConfig] = None):
        if page_size < 1 or ctx % page_size:
            raise ValueError(f"page_size {page_size} must divide ctx {ctx}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.ctx = ctx
        self.page_size = page_size
        self.device = device
        self.pages_per_slot = P = ctx // page_size
        self.n_pages = int(n_pages) if n_pages else batch_size * P + _RESERVED
        if self.n_pages < _RESERVED + 1:
            raise ValueError(f"n_pages {self.n_pages} leaves no allocatable page")
        # prefix-cache hashing granularity (the engine's prefill_chunk);
        # page-aligned so cached boundaries cover only *full* pages
        self.prefix_chunk = prefix_chunk
        if prefix_chunk is not None and prefix_chunk % page_size:
            raise ValueError(f"prefix_chunk {prefix_chunk} must be a multiple of "
                             f"page_size {page_size}")

        self._template = api.make_caches(cfg, 1, ctx, device)  # batch-1 initial values
        tmpl = flatten(self._template)
        self._paged_ids = paged_leaf_ids(self._template, ctx)
        self._resid_ids = [i for i in range(len(tmpl)) if i not in self._paged_ids]
        # KV quantization: which paged leaves are stored narrow
        self.quant = quant if (quant is not None and quant.enabled) else None
        qleaves = quant_leaf_plan(self._template, self._paged_ids, self.quant)
        narrow = {j for ql in qleaves for j in ql.js}
        # the template is position-uniform (zeros, pos -1): one page of it
        # per paged leaf, broadcast to every physical page. Narrow leaves
        # hold narrow zeros with scale 1.0 (template zeros quantize exactly),
        # so NULL and scrubbed pages widen back to the pristine template.
        self._tmpl_pages = [
            tmpl[i][0, :page_size].to(self.quant.kv_dtype() if j in narrow else tmpl[i].dtype)
            for j, i in enumerate(self._paged_ids)
        ]
        self.pages: List[torch.Tensor] = [
            t.expand((self.n_pages,) + tuple(t.shape)).clone() for t in self._tmpl_pages
        ]
        # one canonical (n_pages, page_size, G) f32 scale tensor per narrow
        # JAX leaf, indexed by physical page id
        self.scales: List[torch.Tensor] = [
            torch.ones((self.n_pages, page_size, ql.groups), dtype=torch.float32, device=device)
            for ql in qleaves
        ]
        self._tmpl_resid = [tmpl[i] for i in self._resid_ids]
        self.resid: List[torch.Tensor] = [
            t.expand((batch_size,) + tuple(t.shape[1:])).clone() for t in self._tmpl_resid
        ]
        self.spec = PoolSpec(tuple(self._paged_ids), tuple(self._resid_ids), page_size,
                             self.quant, qleaves)

        # host-side page accounting
        self.table_np = np.full((batch_size, P), SCRATCH_PAGE, np.int32)
        self.n_mapped = np.zeros((batch_size,), np.int64)
        self.ref = np.zeros((self.n_pages,), np.int64)
        self.cache_cnt = np.zeros((self.n_pages,), np.int64)  # prefix entries per page
        self.free: deque = deque(range(_RESERVED, self.n_pages))
        self.held: List[int] = []  # pages out of circulation (hold_pages)
        self.prefix: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        # telemetry
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefix_evictions = 0
        self.peak_pages_in_use = 0

    # -- cache movement -------------------------------------------------

    def device_table(self) -> torch.Tensor:
        return torch.as_tensor(self.table_np, device=self.device)

    def materialize(self, table: torch.Tensor) -> Params:
        return paged_materialize(self.spec, self._template, self.pages, self.scales, self.resid,
                                 table)

    def writeback(self, caches: Params, table: torch.Tensor, pos: torch.Tensor) -> None:
        paged_writeback(self.spec, caches, self.pages, self.scales, table, pos)

    def writeback_tokens(self, caches: Params, table: torch.Tensor, slot: torch.Tensor,
                         pos: torch.Tensor, valid: torch.Tensor) -> None:
        paged_writeback_tokens(self.spec, caches, self.pages, self.scales, table, slot, pos,
                               valid)

    def collect_rows(self, caches: Params, pos: torch.Tensor) -> List[torch.Tensor]:
        return paged_collect_rows(self.spec, caches, pos)

    def scatter_rows(self, rows: List[torch.Tensor], table: torch.Tensor, slot: torch.Tensor,
                     pos: torch.Tensor, valid: torch.Tensor) -> None:
        paged_scatter_rows_q(self.spec, rows, self.pages, self.scales, table, slot, pos, valid)

    def quant_roundtrip(self, work: Params, mask: torch.Tensor) -> None:
        quant_roundtrip(self.spec, work, mask)

    def snapshot_resid(self, work: Params) -> Dict[int, torch.Tensor]:
        """Clone of the residual leaves of a batch-1 (view of a) working
        cache: the non-paged prefix-dependent state a PrefixEntry stores."""
        leaves = flatten(work)
        return {i: leaves[i].clone() for i in self._resid_ids}

    def overlay_resid(self, work: Params, resid: Dict[int, torch.Tensor]) -> None:
        """Copy a snapshot into a batch-1 working cache's residual leaves
        (prefix restore); the snapshot itself is never aliased."""
        leaves = flatten(work)
        for i, v in resid.items():
            leaves[i].copy_(v)

    def overlay_resid_slot(self, slot: int, resid: Dict[int, torch.Tensor]) -> None:
        """Copy a snapshot into one pool slot's residual rows (ragged-mode
        prefix restore: the chunk resumes against the pool itself)."""
        for j, i in enumerate(self._resid_ids):
            if i in resid:
                self.resid[j][slot].copy_(resid[i][0])

    def read_slot(self, slot: int) -> Params:
        """Batch-1 logical cache of one slot: its pages gathered, its
        residual rows cloned (chunked prefill works on this copy, then
        :meth:`write_slot` puts it back)."""
        table_row = torch.as_tensor(self.table_np[slot:slot + 1], device=self.device)
        resid = [r[slot:slot + 1].clone() for r in self.resid]
        return paged_materialize(self.spec, self._template, self.pages, self.scales, resid,
                                 table_row)

    def write_slot(self, slot: int, sub: Params, start_page: int = 0) -> None:
        """Copy a batch-1 cache tree into the slot: residual rows wholesale,
        paged leaves page by page into the slot's *owned* pages (logical
        pages below ``start_page`` — a restored shared prefix — are skipped,
        so shared pages are never rewritten). Narrow leaves quantize each
        written page's rows with fresh pow2 scales, exact on rows already
        round-tripped at a chunk boundary (quantization is idempotent), and
        write the narrow pages and their scales to the same pages."""
        n = int(self.n_mapped[slot])
        ids = torch.as_tensor(self.table_np[slot, start_page:n].astype(np.int64),
                              device=self.device)
        P, p = self.pages_per_slot, self.page_size
        leaves = flatten(sub)

        def written(j):  # the slot's owned logical pages of paged leaf j
            i = self._paged_ids[j]
            return leaves[i][0].reshape((P, p) + tuple(self.pages[j].shape[2:]))[start_page:n]

        for j in self.spec.plain_ids():
            self.pages[j].index_copy_(0, ids, written(j).to(self.pages[j].dtype))
        # (an enc-dec admission writes its cross-KV before any page is mapped)
        for m, ql in enumerate(self.spec.qleaves if n > start_page else ()):
            src = [canon_pages(written(j)) for j in ql.js]  # (n', p, F) each
            q, sc = quantize_rows(torch.cat(src, dim=-1), ql.groups, self.quant)
            for j, qj in zip(ql.js, q.split([t.shape[-1] for t in src], dim=-1)):
                _bytes(self.pages[j]).index_copy_(
                    0, ids, _bytes(qj.reshape((-1, p) + tuple(self.pages[j].shape[2:]))))
            self.scales[m].index_copy_(0, ids, sc)
        for j, i in enumerate(self._resid_ids):
            self.resid[j][slot].copy_(leaves[i][0])

    def _scrub(self, ids: List[int]) -> None:
        """Rewrite physical pages ``ids`` to template content (and their
        scales to 1.0), so a recycled page can't leak a previous request's
        KV (or stale valid-looking positions) into a new slot."""
        idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        for pages, t in zip(self.pages, self._tmpl_pages):
            _bytes(pages).index_copy_(0, idx, _bytes(t).expand((len(ids),) + tuple(t.shape)))
        for s in self.scales:
            s.index_fill_(0, idx, 1.0)

    # -- slot lifecycle (host-side accounting) --------------------------

    def acquire(self, slot: int) -> None:
        """Claim a slot for a new request: residual rows back to template,
        page table to all-NULL (pristine reads until pages are mapped)."""
        self.release(slot)
        self.table_np[slot, :] = NULL_PAGE
        for r, t in zip(self.resid, self._tmpl_resid):
            r[slot].copy_(t[0])

    def release(self, slot: int) -> None:
        """Drop the slot's page references; pages go back to the free list
        unless a prefix-cache entry still pins them."""
        for j in range(int(self.n_mapped[slot])):
            pid = int(self.table_np[slot, j])
            if pid < _RESERVED:
                continue
            self.ref[pid] -= 1
            if self.ref[pid] == 0 and self.cache_cnt[pid] == 0:
                self.free.append(pid)
        self.table_np[slot, :] = SCRATCH_PAGE
        self.n_mapped[slot] = 0

    def truncate(self, slot: int, upto_tokens: int) -> int:
        """Speculative rollback: shrink the slot's mapping to the pages that
        cover ``upto_tokens`` logical positions and release the tail pages
        (decref: a page another slot or a prefix entry pins survives). Tail
        table entries go back to NULL, so reads past the cut see the
        pristine NULL page as if they had never been mapped. Stale rows
        inside the last kept page (positions >= ``upto_tokens``) stay: the
        causal mask hides them until the accepted stream overwrites them in
        position order. Returns the number of pages released."""
        keep = min(int(self.n_mapped[slot]), self.pages_needed(upto_tokens))
        dropped = 0
        for j in range(keep, int(self.n_mapped[slot])):
            pid = int(self.table_np[slot, j])
            self.table_np[slot, j] = NULL_PAGE
            if pid < _RESERVED:
                continue
            self.ref[pid] -= 1
            if self.ref[pid] == 0 and self.cache_cnt[pid] == 0:
                self.free.append(pid)
            dropped += 1
        self.n_mapped[slot] = keep
        return dropped

    def _evict_entry(self, key: bytes) -> None:
        entry = self.prefix.pop(key)
        self.prefix_evictions += 1
        for pid in entry.pages:
            self.cache_cnt[pid] -= 1
            if self.cache_cnt[pid] == 0 and self.ref[pid] == 0:
                self.free.append(pid)

    def _pop_free(self) -> Optional[int]:
        """Pop a free page, evicting prefix entries under pressure: only an
        entry whose eviction actually frees a page (a page no slot holds and
        this entry is the last registry pin of), oldest first (LRU)."""
        while not self.free:
            victim = None
            for h, e in self.prefix.items():
                if any(self.ref[pid] == 0 and self.cache_cnt[pid] == 1 for pid in e.pages):
                    victim = h
                    break
            if victim is None:
                return None
            self._evict_entry(victim)
        return self.free.popleft()

    @property
    def allocatable_pages(self) -> int:
        """Hard capacity: every page that can ever hold request KV."""
        return self.n_pages - _RESERVED

    def available_pages(self) -> int:
        """Pages obtainable right now: free list + evictable prefix pages."""
        evictable = int(np.sum((self.ref[_RESERVED:] == 0) & (self.cache_cnt[_RESERVED:] > 0)))
        return len(self.free) + evictable

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def hold_pages(self, n: int) -> int:
        """Take up to ``n`` allocatable pages out of circulation (fault
        injection): popped off the free list, evicting prefix entries under
        pressure like any allocation, into ``held``, where neither slots nor
        the prefix cache reach them until :meth:`release_held`. Returns how
        many were taken. ``allocatable_pages`` (the submit-time capacity
        check) is unchanged while ``available_pages`` shrinks: the admission
        gate closes and lazy growth reaches the preemption path."""
        taken = 0
        while taken < n:
            pid = self._pop_free()
            if pid is None:
                break
            self.held.append(pid)
            taken += 1
        return taken

    def release_held(self) -> int:
        """Return every held page to the free list; returns the count."""
        n = len(self.held)
        self.free.extend(self.held)
        self.held.clear()
        return n

    def _note_peak(self) -> None:
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     int(np.sum(self.ref[_RESERVED:] > 0)))

    def alloc_pages(self, slot: int, upto_tokens: int) -> bool:
        """Map (and scrub) owned pages so the slot covers ``upto_tokens``
        logical positions. False = pool exhausted (the caller preempts)."""
        need = self.pages_needed(upto_tokens)
        new_ids: List[int] = []
        ok = True
        while int(self.n_mapped[slot]) < need:
            pid = self._pop_free()
            if pid is None:
                ok = False
                break
            self.table_np[slot, int(self.n_mapped[slot])] = pid
            self.ref[pid] += 1
            self.n_mapped[slot] += 1
            new_ids.append(pid)
        if new_ids:
            self._scrub(new_ids)
        self._note_peak()  # partial maps raise pages in use too
        return ok

    # -- prefix cache ---------------------------------------------------

    def _chain_hashes(self, tokens: np.ndarray) -> List[Tuple[int, bytes]]:
        """(boundary n_tokens, chain hash) per full prefill chunk. Tokens
        hash as int32 whatever integer array the caller passes, so one
        prompt always has one chain."""
        if self.prefix_chunk is None:
            return []
        c = self.prefix_chunk
        toks = np.asarray(tokens).astype(np.int32)
        out, h = [], b"paged-prefix"
        for end in range(c, len(toks) + 1, c):
            h = hashlib.sha1(h + np.ascontiguousarray(toks[end - c:end]).tobytes()).digest()
            out.append((end, h))
        return out

    def prefix_probe_pages(self, tokens: np.ndarray) -> int:
        """Pages a prefix hit would cover for this prompt — admission-gate
        probe only: touches neither the LRU order nor the hit telemetry."""
        best = 0
        for end, h in self._chain_hashes(tokens):
            if end >= len(tokens) or h not in self.prefix:
                break
            best = len(self.prefix[h].pages)
        return best

    def prefix_match(self, tokens: np.ndarray) -> Optional[Tuple[bytes, PrefixEntry]]:
        """Longest cached chunk-aligned *proper* prefix of ``tokens``
        (strictly shorter than the prompt: at least one token must still
        run through prefill to produce first-token logits)."""
        best = None
        for end, h in self._chain_hashes(tokens):
            if end >= len(tokens):
                break
            e = self.prefix.get(h)
            if e is None:
                break
            best = (h, e)
        self.prefix_lookup_tokens += len(tokens)
        return best

    def prefix_attach(self, slot: int, key: bytes) -> Dict[int, torch.Tensor]:
        """Map a cached prefix's shared pages into the slot (incref) and
        return the residual snapshot to resume prefill from."""
        entry = self.prefix[key]
        self.prefix.move_to_end(key)
        for j, pid in enumerate(entry.pages):
            self.table_np[slot, j] = pid
            self.ref[pid] += 1
        self.n_mapped[slot] = len(entry.pages)
        self.prefix_hit_tokens += entry.n_tokens
        self._note_peak()
        return entry.resid

    def prefix_register(self, slot: int, tokens: np.ndarray,
                        boundary_resids: Dict[int, Dict[int, torch.Tensor]]) -> None:
        """Insert entries for every chunk boundary prefilled this admission
        (``boundary_resids``: n_tokens -> residual snapshot at boundary)."""
        for end, h in self._chain_hashes(tokens):
            if h in self.prefix:
                self.prefix.move_to_end(h)
                continue
            if end not in boundary_resids:
                continue
            pages = tuple(int(x) for x in self.table_np[slot, :end // self.page_size])
            for pid in pages:
                self.cache_cnt[pid] += 1
            self.prefix[h] = PrefixEntry(n_tokens=end, pages=pages, resid=boundary_resids[end])
        # capacity bound on entries (their snapshots are device memory):
        # evict the oldest regardless of page freeability
        while len(self.prefix) > PREFIX_MAX_ENTRIES:
            self._evict_entry(next(iter(self.prefix)))

    # -- telemetry ------------------------------------------------------

    def page_stats(self) -> Dict[str, float]:
        alloc = self.n_pages - _RESERVED
        in_use = int(np.sum(self.ref[_RESERVED:] > 0))
        cached_only = int(np.sum((self.ref[_RESERVED:] == 0) & (self.cache_cnt[_RESERVED:] > 0)))
        return {
            "n_pages": float(alloc),
            "pages_in_use": float(in_use),
            "pages_cached_only": float(cached_only),
            "pages_free": float(len(self.free)),
            "pages_held": float(len(self.held)),
            "page_utilization": in_use / alloc if alloc else 0.0,
            "page_utilization_peak": self.peak_pages_in_use / alloc if alloc else 0.0,
            "peak_pages_in_use": float(self.peak_pages_in_use),
            "prefix_entries": float(len(self.prefix)),
            "prefix_resid_bytes": self._prefix_resid_bytes(),
            "prefix_hit_rate": (self.prefix_hit_tokens / self.prefix_lookup_tokens
                                if self.prefix_lookup_tokens else 0.0),
            "prefix_evictions": float(self.prefix_evictions),
        }

    def check_invariants(self) -> None:
        """Recount every book from the raw structures and raise
        ``AssertionError`` where they disagree: reserved pages are never
        owned, cached, free or held; the slot tables give the refcounts and
        the prefix entries the cache counts; every allocatable page is
        free, held, or referenced or cached, exactly one of them."""
        def need(ok: bool, what: str) -> None:
            if not ok:
                raise AssertionError(what)

        need(self.ref[:_RESERVED].sum() == 0, "NULL/SCRATCH page refcounted")
        need(self.cache_cnt[:_RESERVED].sum() == 0, "NULL/SCRATCH page cached")
        free, held = list(self.free), list(self.held)
        need(all(p >= _RESERVED for p in free + held), "reserved page free or held")
        need(len(free) == len(set(free)), "free-list duplicate (double free)")
        need(len(held) == len(set(held)), "page held twice")
        ref = np.zeros_like(self.ref)
        for s in range(self.batch_size):
            n, row = int(self.n_mapped[s]), self.table_np[s]
            need(bool((row[:n] >= _RESERVED).all()), f"slot {s}: mapped entry is NULL/SCRATCH")
            need(len(set(row[:n].tolist())) == n, f"slot {s}: page mapped twice")
            need(bool(np.isin(row[n:], (NULL_PAGE, SCRATCH_PAGE)).all()),
                 f"slot {s}: unmapped table entry points at a real page")
            np.add.at(ref, row[:n], 1)
        need(bool((ref == self.ref).all()), "refcounts differ from the slot tables")
        cnt = np.zeros_like(self.cache_cnt)
        for e in self.prefix.values():
            for pid in e.pages:
                cnt[pid] += 1
        need(bool((cnt == self.cache_cnt).all()), "cache counts differ from the prefix entries")
        need(len(self.prefix) <= PREFIX_MAX_ENTRIES, "prefix entries past their bound")
        need(not (set(held) & set(free)), "held page still on the free list")
        need(all(self.ref[p] == 0 and self.cache_cnt[p] == 0 for p in held),
             "held page is referenced or cached")
        idle = {p for p in range(_RESERVED, self.n_pages)
                if self.ref[p] == 0 and self.cache_cnt[p] == 0}
        need(set(free) | set(held) == idle, "free + held != idle pages (leak or early free)")
        stats = self.page_stats()
        need(0.0 <= stats["page_utilization"] <= 1.0, "page utilization outside [0, 1]")
        need(stats["page_utilization_peak"] >= stats["page_utilization"] - 1e-9,
             "peak utilization below the current one")
        need(stats["pages_held"] == float(len(held)), "pages_held differs from held")

    def _prefix_resid_bytes(self) -> float:
        """Device bytes pinned by the prefix entries' residual snapshots."""
        return float(sum(t.numel() * t.element_size()
                         for e in self.prefix.values() for t in e.resid.values()))

    def unquantized_kv_bytes(self) -> float:
        """``kv_bytes`` of the same pool without quantization: every page
        tensor in its wide dtype, no scales."""
        wide = {j: ql.dtype for ql in self.spec.qleaves for j in ql.js}
        return float(sum(
            pages.numel() * (torch.empty((), dtype=wide[j]).element_size() if j in wide
                             else pages.element_size())
            for j, pages in enumerate(self.pages)))

    def cache_bytes(self) -> Dict[str, float]:
        """Physical footprint (pages + scales + residual + prefix snapshots),
        with the contiguous pool's mod/full split: paged leaves and their
        scales are full-attention rings ("full"); the residual pool carries
        the MoD rings ("mod"). ``kv_bytes`` is everything page-addressed
        (narrow pages, scales, the int32 position pages), ``resid_bytes``
        the slot-contiguous rest."""
        sizes = {"total": 0.0, "mod": 0.0, "full": 0.0, "paged": 0.0, "resid": 0.0,
                 "prefix_resid": self._prefix_resid_bytes()}
        sizes["total"] += sizes["prefix_resid"]
        for pages in self.pages + self.scales:
            b = float(pages.numel() * pages.element_size())
            sizes["total"] += b
            sizes["full"] += b
            sizes["paged"] += b
        keys = [k for k, _ in _leaves(self._template)]
        for j, i in enumerate(self._resid_ids):
            b = float(self.resid[j].numel() * self.resid[j].element_size())
            sizes["total"] += b
            sizes["mod" if "mod" in keys[i] else "full"] += b
            sizes["resid"] += b
        sizes["kv_bytes"] = sizes["paged"]
        sizes["resid_bytes"] = sizes["resid"]
        sizes["mod_vs_full_ratio"] = sizes["mod"] / sizes["full"] if sizes["full"] else 0.0
        return sizes
