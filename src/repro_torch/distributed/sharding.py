"""Sharding rules, the SPMD routed-execution context and the mesh's
collective placement, for serving and for training.

Port of ``repro/distributed/sharding.py``. The JAX package places global
arrays with ``NamedSharding`` and lets GSPMD insert the collectives; here
every rank holds **plain local tensors** (its own shards) and the layer
code makes the collective that each placement implies (:func:`copy_model`
before a column-parallel product, :func:`reduce_model` after ``wo``,
``w_down`` and the expert combine; :func:`gather_model` of the D-sharded
embedding rows and the vocab-sharded logits). Under autograd these are the
conjugate pairs of :mod:`repro_torch.distributed.collectives`; under
``no_grad`` (serving) the in-place forms. The hand-written kernels take
these ordinary tensors, so they stay on the path. Which leaves are cut is
decided once, by :func:`shard_params`, and recorded on the
:class:`ShardCtx` (``split`` over "model", ``data_split`` over "data");
the layers ask :func:`is_split` instead of comparing shapes.

- :data:`_RULES` is the JAX rule table, copied: a path regex and the mesh
  axis of each trailing dim; "F" is the data axis under FSDP (JAX's
  ``param_pspec(..., fsdp)``) and unsharded otherwise.
  :func:`param_placement` gives a leaf's spec (a tuple of axis names or
  None per dim); a dim that does not divide its axis falls back to
  replication, as in JAX's ``_validated``. :func:`state_placement` and
  :func:`batch_placement` are JAX's ``state_shardings`` and
  ``batch_shardings`` (the batch over ``("pod", "data")``, M-RoPE
  positions on dim 1).
- :func:`cache_placement` follows JAX's ``cache_shardings``: the slot dim
  over ``("pod", "data")``; on the model axis the port splits **kv heads**,
  not ``head_dim`` as JAX does, because the flash and paged kernels take
  whole heads (a split head_dim would need a reduction inside every
  score), and keeps the SSM's ``conv_B`` / ``conv_C`` windows whole (every
  rank's heads read the whole B and C).
- :func:`shard_params` cuts one rank's shards out of a full parameter tree
  by the rules. Attention leaves are cut on head boundaries only: GSPMD
  may cut a head in two, the port's kernels may not, so tensor parallelism
  needs whole query heads per rank (:func:`check_tensor_parallel`; whole
  SSM heads for the Mamba2 blocks, whose ``d_inner`` leaves the rules cut
  on head boundaries then), and K/V whose heads do not divide the model
  axis keep, on each rank, the kv heads its query heads read (all of them
  under MQA; :func:`kv_copies` ranks hold each head, and the trainer sums
  a head's gradient over them: ``train.loop.MeshLayout``).
- A leaf the rules leave whole inside a block whose other leaves are cut
  (the SSM's ``w_B``, ``w_C``, ``w_dt`` and their conv taps) gets a
  partial gradient on each rank, from that rank's heads only:
  :func:`whole_in_split` passes it through :func:`copy_model`, so the
  gradient that comes out is the sum over the model axis and the leaf
  stays replicated.
- FSDP (``ShardCtx.fsdp``): a rank keeps its "data" shard of each leaf the
  rule cuts (and of its AdamW moments); :func:`gather_data` all-gathers
  them where they are used (the gradient comes back reduce-scattered):
  the leaves outside the layer groups at the start of a model call, each
  group's inside its remat boundary (``models.transformer.run_groups``),
  as JAX's scan gathers one layer group at a time. Under ``remat="full"``
  the recomputation gathers again, so a rank holds one group's gathered
  weights at a time; without remat autograd keeps every group's gathered
  weights for the backward.
- :class:`ShardCtx` / :func:`shard_ctx` are JAX's: ``data_shards`` is the
  partitioned ``batch_capacity`` semantics (each of ``d`` contiguous batch
  groups routes its own top ``round(ratio·B/d)`` rows), ``mesh`` (a
  ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
  "model")``, or ``("pod", "data", "model")``) the execution. With a mesh
  the model code receives this rank's rows only, so a routing decision is
  local to the shard; a training call's batch statistics (the loss, the
  MoE load balance, the router losses) are summed over the data axes
  (:func:`batch_sum`), so every rank computes the global batch's values.
  ``ShardCtx(data_shards=d)`` with no mesh runs the same partitioned
  semantics over the whole batch on one device (the reference).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Any, Dict, FrozenSet, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as C

Spec = Tuple[Optional[str], ...]

# trailing-dim templates; "F" is replaced by "data" under fsdp else None
_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    # tok: shard D over model (gather over a vocab-sharded table forces
    # involuntary replication in SPMD); unemb: V over model so logits and
    # the CE logsumexp stay vocab-sharded.
    (r"embed/tok$", (None, "model")),
    (r"embed/unemb$", ("F", "model")),
    (r"x?attn/w[qkv]$", ("F", "model")),
    (r"x?attn/b[qkv]$", ("model",)),
    (r"x?attn/wo$", ("model", "F")),
    (r"moe/w_(up|gate)$", ("model", "F", None)),
    (r"moe/w_down$", ("model", None, "F")),
    (r"moe/router_w$", (None, None)),
    (r"mlp/w_(up|gate)$", ("F", "model")),
    (r"mlp/w_down$", ("model", "F")),
    (r"ssm/w_[zx]$", ("F", "model")),
    (r"ssm/w_(B|C|dt)$", ("F", None)),
    (r"ssm/conv_x$", (None, "model")),
    (r"ssm/conv_(B|C)$", (None, None)),
    (r"ssm/conv_bx$", ("model",)),
    (r"ssm/conv_b[BC]$", (None,)),
    (r"ssm/(A_log|skip_D|dt_bias)$", ("model",)),
    (r"ssm/norm/scale$", ("model",)),
    (r"ssm/out_proj$", ("model", "F")),
    (r"(router|predictor)/", (None,)),  # routers: tiny, replicated
)

_ATTN_KV = re.compile(r"x?attn/(w[kv]|b[kv])$")


# ---------------------------------------------------------------------------
# Meshes as axis sizes
# ---------------------------------------------------------------------------


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping (a mesh shape
    alone: the rules need no processes)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"not a mesh: {type(mesh).__name__}")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


def _axis_size(sizes: Dict[str, int], name: Any) -> int:
    """The size of an axis, or of a tuple of axes (their product)."""
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(math.prod(sizes.get(a, 1) for a in name))
    return sizes.get(name, 1)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh axes the batch is cut over: ``("pod", "data")`` where
    present (JAX's ``batch_axes``)."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _validated(spec: Sequence[Any], shape: Sequence[int], sizes: Dict[str, int]) -> Spec:
    """Each dim's axis, or None where the dim does not divide it
    (replication), one entry a dim."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % _axis_size(sizes, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out)


# ---------------------------------------------------------------------------
# Placement rules
# ---------------------------------------------------------------------------


def param_placement(path: str, shape: Sequence[int], mesh: Any, fsdp: bool = False) -> Spec:
    """The mesh axis of each dim of the parameter leaf at ``path`` (its
    "/"-joined dict keys), JAX's ``param_pspec``: the first matching rule's
    trailing dims (leading stack dims unsharded), "F" the data axis under
    ``fsdp``, a dim that does not divide its axis replicated."""
    sizes = mesh_sizes(mesh)
    for pat, trailing in _RULES:
        if re.search(pat, path):
            t = tuple(("data" if fsdp else None) if a == "F" else a for a in trailing)
            full = (None,) * max(0, len(shape) - len(t)) + t[: len(shape)]
            return _validated(full, shape, sizes)
    return (None,) * len(shape)


def state_placement(state: Any, mesh: Any, fsdp: bool = False) -> Any:
    """The spec of every leaf of a train state ``{"params", "opt": {"m",
    "v", "count"}, "step"}`` (JAX's ``state_shardings``): the moments
    mirror the parameters, ``count`` and ``step`` are replicated. The
    parameter tree may be the port's (lists of groups) or JAX's (stacked
    groups)."""
    ps = _rebuild(state["params"],
                  lambda keys, leaf: param_placement(_path(keys), leaf.shape, mesh, fsdp))
    return {"params": ps, "opt": {"m": ps, "v": ps, "count": ()}, "step": ()}


def batch_placement(batch: Any, mesh: Any) -> Any:
    """The spec of every leaf of a batch (JAX's ``batch_shardings``): the
    leading batch dim over ``batch_axes(mesh)`` when it divides their
    degree; M-RoPE positions ``(3, B, S)`` cut on dim 1."""
    sizes = mesh_sizes(mesh)
    bd = batch_axes(mesh)
    n = _axis_size(sizes, bd)
    bd = bd[0] if len(bd) == 1 else bd  # one axis by its name, as a PartitionSpec has it

    def one(keys, v):
        if str(keys[-1]).endswith("positions") and v.ndim == 3 and v.shape[0] == 3:
            return (None, bd, None) if v.shape[1] % n == 0 else (None, None, None)
        return (bd if v.shape[0] % n == 0 else None,) + (None,) * (v.ndim - 1)

    return _rebuild(batch, one)


def cache_placement(path: str, shape: Sequence[int], mesh: Any, batch: int) -> Spec:
    """The mesh axis of each dim of a decode-cache leaf (slot on axis
    ``ndim - 4`` of ``k``/``v``, as the port's and JAX's leaves have it).
    Batched serving (``batch`` divisible by the data degree): slots over
    ``batch_axes(mesh)``, ``("pod", "data")``; otherwise the sequence dim
    of K/V over "data" (JAX's sequence-parallel case; the port's engine
    always divides the batch). On "model": kv heads of ``k``/``v`` (JAX:
    ``head_dim``), SSM state heads, ``conv_x`` channels (JAX cuts
    ``conv_B`` / ``conv_C`` too; see the module docstring)."""
    sizes = mesh_sizes(mesh)
    bd = batch_axes(sizes)
    b_ok = batch % _axis_size(sizes, bd) == 0
    bd = (bd[0] if len(bd) == 1 else bd) if bd else None  # one axis by its name
    m = _axis_size(sizes, "model")
    leaf = path.rsplit("/", 1)[-1]
    nd = len(shape)
    spec: list = [None] * nd
    if leaf in ("k", "v"):  # (..., B, C, nkv, hd)
        if b_ok:
            spec[nd - 4] = bd
        else:
            spec[nd - 3] = "data"
        if shape[nd - 2] % m == 0:
            spec[nd - 2] = "model"
    elif leaf == "pos":  # (..., B, C)
        if b_ok:
            spec[nd - 2] = bd
        else:
            spec[nd - 1] = "data"
    elif leaf == "cursor":  # (..., B)
        if b_ok:
            spec[nd - 1] = bd
    elif leaf == "state":  # (..., B, H, hd, ds)
        if b_ok:
            spec[nd - 4] = bd
        if shape[nd - 3] % m == 0:
            spec[nd - 3] = "model"
    elif leaf.startswith("conv_"):  # (..., B, W-1, C)
        if b_ok:
            spec[nd - 3] = bd
        if leaf == "conv_x" and shape[nd - 1] % m == 0:
            spec[nd - 1] = "model"
    return _validated(spec, shape, sizes)


# ---------------------------------------------------------------------------
# Tensor parallelism: whole heads, and one rank's shards
# ---------------------------------------------------------------------------


def check_tensor_parallel(cfg: ModelConfig, model_shards: int) -> None:
    """Raise unless ``cfg`` can run with its model axis split
    ``model_shards`` ways: whole SSM heads per rank (the ssm and hybrid
    families: the rules then cut ``d_inner`` on head boundaries), whole
    query heads per rank (every family with attention: the hybrid's
    shared block, the enc-dec's three attentions; the ssm family's
    ``cfg.attn`` is unused), and kv heads that either divide the axis or
    serve each rank's query heads uniformly (:func:`kv_head_range`)."""
    m = int(model_shards)
    if m <= 1:
        return
    if cfg.family in ("ssm", "hybrid"):
        h = cfg.ssm.n_heads(cfg.d_model)
        if h % m:
            raise NotImplementedError(
                f"tensor parallelism needs whole SSM heads per rank: {h} heads over a model "
                f"axis of {m}")
    if cfg.family == "ssm":
        return
    nq, nkv = cfg.attn.n_heads, cfg.attn.n_kv_heads
    if nq % m:
        raise NotImplementedError(
            f"tensor parallelism needs whole query heads per rank: {nq} heads over a model "
            f"axis of {m}")
    if nkv % m:
        g, nql = nq // nkv, nq // m
        if nql % g and g % nql:
            raise NotImplementedError(
                f"{nq} query heads over {nkv} kv heads do not split evenly over a model axis "
                f"of {m}")


def kv_head_range(cfg: ModelConfig, model_shards: int, model_rank: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that model rank ``model_rank`` holds: its share
    when the kv heads divide the axis, else the heads its query heads read."""
    m, r = int(model_shards), int(model_rank)
    nq, nkv = cfg.attn.n_heads, cfg.attn.n_kv_heads
    if m <= 1:
        return 0, nkv
    if nkv % m == 0:
        return r * nkv // m, (r + 1) * nkv // m
    g, nql = nq // nkv, nq // m
    return (r * nql) // g, ((r + 1) * nql - 1) // g + 1


def kv_copies(cfg: ModelConfig, model_shards: int) -> int:
    """How many model ranks hold each kv head: 1 when the kv heads divide
    the axis, else ``m / nkv`` (each rank then holds one head, read by its
    query heads: a head's group spans whole ranks; every rank under MQA)."""
    m, nkv = int(model_shards), cfg.attn.n_kv_heads
    return 1 if m <= 1 or nkv % m == 0 else m // nkv


def rank_placement(path: str, shape: Sequence[int], cfg: ModelConfig, sizes: Dict[str, int],
                   fsdp: bool = False) -> Spec:
    """The spec of the shard a rank holds of a parameter leaf:
    :func:`param_placement`'s, but K/V leaves cut on "model" exactly when
    the kv heads divide the axis (by :func:`kv_head_range`, which then
    agrees with the rule's column chunks), else held whole over it (each
    rank its heads; :func:`kv_copies`)."""
    spec = param_placement(path, shape, sizes, fsdp)
    m = sizes.get("model", 1)
    if _ATTN_KV.search(path) and m > 1:
        spec = spec[:-1] + (("model",) if kv_copies(cfg, m) == 1 else (None,))
    return spec


def _path(keys: Tuple[Any, ...]) -> str:
    """The "/"-joined dict keys of a leaf (list indices dropped: the port's
    per-layer lists are the JAX tree's stacked axes)."""
    return "/".join(str(k) for k in keys if not isinstance(k, int))


def _leaves(tree: Any, keys: Tuple[Any, ...] = ()) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (i,))
    else:
        yield keys, tree


def _rebuild(tree: Any, fn, keys: Tuple[Any, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, fn, keys + (i,)) for i, v in enumerate(tree)]
    return fn(keys, tree)


def fsdp_dim(path: str, ndim: int) -> Optional[int]:
    """The dim of a leaf that FSDP cuts over "data" (its rule's "F" slot),
    or None."""
    for pat, trailing in _RULES:
        if re.search(pat, path):
            if "F" not in trailing or ndim < len(trailing):
                return None
            return ndim - len(trailing) + trailing.index("F")
    return None


def cut_leaf(path: str, leaf: Any, cfg: ModelConfig, sizes: Dict[str, int],
             coords: Dict[str, int], fsdp: bool = False) -> Any:
    """One rank's shard of a parameter leaf (a tensor or a numpy array,
    possibly stacked on leading axes): the chunk at the rank's coordinate
    of every dim :func:`param_placement` puts on an axis (``fsdp``: the
    "F" dims over "data" too), and K/V leaves on the head range of
    :func:`kv_head_range`. A leaf left whole is returned as it is (the
    same object)."""
    spec = param_placement(path, leaf.shape, sizes, fsdp)
    m = sizes.get("model", 1)
    if _ATTN_KV.search(path) and m > 1:
        lo, hi = kv_head_range(cfg, m, coords.get("model", 0))
        hd = cfg.head_dim
        spec = spec[:-1] + (None,)
        if (lo, hi) != (0, cfg.attn.n_kv_heads):
            leaf = leaf[..., lo * hd: hi * hd]
    index = []
    for dim, ax in zip(leaf.shape, spec):
        if ax is None:
            index.append(slice(None))
            continue
        step = dim // sizes[ax]
        c = coords.get(ax, 0)
        index.append(slice(c * step, (c + 1) * step))
    if all(s == slice(None) for s in index):
        return leaf
    return leaf[tuple(index)]


def leaf_name(path: str) -> str:
    """The name a layer asks :func:`is_split` about: a leaf's last two path
    keys ("attn/wo", "mlp/w_down", "moe/w_up", "embed/tok"), the part of
    the path the rule table matches on."""
    return "/".join(path.split("/")[-2:])


def cut_tree(tree: Any, cfg: ModelConfig, sizes: Dict[str, int], coords: Dict[str, int],
             fsdp: bool = False) -> Tuple[Any, FrozenSet[str]]:
    """Every leaf of ``tree`` cut by :func:`cut_leaf` (a cut tensor is
    copied, so the full one can be freed; whole leaves are shared), and the
    :func:`leaf_name` of the leaves it cut over the model axis
    (:func:`split_names` gives those cut over "data" under ``fsdp``). A
    name is cut everywhere or nowhere (every layer's leaf of a name has one
    shape), else ``ValueError``."""
    check_tensor_parallel(cfg, sizes.get("model", 1))
    model_cut, _ = split_names(tree, cfg, sizes, fsdp)
    seen: Dict[str, bool] = {}

    def one(keys, leaf):
        path = _path(keys)
        out = cut_leaf(path, leaf, cfg, sizes, coords, fsdp)
        name, was = leaf_name(path), out is not leaf
        if was and isinstance(out, torch.Tensor):
            out = out.contiguous().clone()
        if seen.setdefault(name, was) != was:
            raise ValueError(f"leaf {name!r} is cut in some layers and whole in others")
        return out

    out = _rebuild(tree, one)
    return out, model_cut


def split_names(tree: Any, cfg: ModelConfig, sizes: Dict[str, int], fsdp: bool = False
                ) -> Tuple[FrozenSet[str], FrozenSet[str]]:
    """The :func:`leaf_name` of the leaves of ``tree`` (tensors, arrays or
    meta tensors: shapes are enough) that :func:`cut_tree` cuts over the
    model axis, and of those it cuts over "data" (``fsdp``)."""
    m = sizes.get("model", 1)
    # K/V are cut on head ranges (kv_head_range), whatever the rule says
    kv_cut = m > 1 and any(kv_head_range(cfg, m, r) != (0, cfg.attn.n_kv_heads)
                           for r in range(m))
    model, data = set(), set()
    for keys, leaf in _leaves(tree):
        path = _path(keys)
        spec = param_placement(path, leaf.shape, sizes, fsdp)
        if (kv_cut if _ATTN_KV.search(path) and m > 1 else "model" in spec):
            model.add(leaf_name(path))
        if "data" in spec:
            data.add(leaf_name(path))
    return frozenset(model), frozenset(data)


def shard_params(params: Any, cfg: ModelConfig, spmd: "ShardCtx") -> Tuple[Any, "ShardCtx"]:
    """This rank's shards of the port's full parameter tree under ``spmd``'s
    mesh (:func:`cut_tree`), and ``spmd`` with ``split`` and
    ``data_split`` recording the leaves it cut: run the shards under that
    context. Without FSDP only the model axis cuts parameters, so a
    data-only mesh returns both as they are."""
    run = placed(spmd, cfg, params)
    if run is spmd:  # nothing to cut
        return params, spmd
    out, _ = cut_tree(params, cfg, mesh_sizes(spmd.mesh), spmd.coords(), spmd.fsdp)
    return out, run


def placed(spmd: "ShardCtx", cfg: ModelConfig, shapes: Any) -> "ShardCtx":
    """``spmd`` with ``split`` / ``data_split`` as :func:`shard_params`
    records them for a tree of ``shapes`` (the full parameter tree, meta
    tensors will do): the context a step on already cut shards runs under;
    ``spmd`` itself when the mesh cuts nothing."""
    if spmd is None or spmd.mesh is None:
        return spmd
    sizes = mesh_sizes(spmd.mesh)
    check_tensor_parallel(cfg, spmd.model_shards)
    if spmd.model_shards <= 1 and not (spmd.fsdp and sizes.get("data", 1) > 1):
        return spmd
    split, data_split = split_names(shapes, cfg, sizes, spmd.fsdp)
    return dataclasses.replace(spmd, split=split, data_split=data_split)


def local_cache_config(cfg: ModelConfig, spmd: Optional["ShardCtx"]) -> ModelConfig:
    """The config whose caches hold one rank's share: ``cfg`` with the kv
    heads of :func:`kv_head_range` when :func:`shard_params` cut K/V
    (slots are cut by the pool; SSM heads by :func:`local_ssm_heads`:
    ``d_model`` fixes every D-wide leaf, so the config keeps it)."""
    if spmd is None or "attn/wk" not in spmd.split:
        return cfg
    lo, hi = kv_head_range(cfg, spmd.model_shards, spmd.coords()["model"])
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, n_kv_heads=hi - lo))


def local_ssm_heads(cfg: ModelConfig, spmd: Optional["ShardCtx"]) -> Optional[int]:
    """The SSM heads one rank's decode states hold when :func:`shard_params`
    cut the Mamba2 blocks (its share of ``cfg.ssm.n_heads``), else None
    (all of them)."""
    if spmd is None or "ssm/w_x" not in spmd.split:
        return None
    return cfg.ssm.n_heads(cfg.d_model) // spmd.model_shards


# ---------------------------------------------------------------------------
# SPMD routed-execution context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh context of SPMD routed execution (JAX's ``ShardCtx``).

    - **semantics** (``data_shards``): ``batch_capacity`` decode splits the
      batch into ``data_shards`` contiguous groups and routes the top
      ``kb_local = round(ratio·B/d)`` sequences within each, a global
      budget of ``d·kb_local`` with no cross-group communication.
      ``token_topk`` is per sequence, so it never depends on the split.
    - **execution** (``mesh``): with a ``DeviceMesh`` attached, each rank
      runs the model on its own ``B/d`` rows (``data_axes``: "data", and
      "pod" in front where the mesh has one) with its shards of the
      weights (``model_axis``, tensor parallel; ``fsdp``: parameters cut
      over "data" too), so the routed step's decision, cache gather and
      scatters are shard-local.

    ``ShardCtx(mesh=None, data_shards=d)`` runs the same partitioned
    semantics on one device: the reference the mesh is held against."""

    mesh: Any = None
    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    data_shards: int = 1
    # params and AdamW moments sharded over "data" too (JAX's ZeRO-3):
    # fused dispatch falls back (blocks.fused_dispatch_supported)
    fsdp: bool = False
    # the leaf_name()s of the leaves shard_params cut over the model axis
    split: FrozenSet[str] = frozenset()
    # ... and over "data" (fsdp), gathered at the start of a model call
    data_split: FrozenSet[str] = frozenset()

    @property
    def spmd(self) -> bool:
        """True when the model runs on this rank's shard of the batch."""
        return self.mesh is not None and bool(self.data_axes)

    @property
    def model_shards(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return mesh_sizes(self.mesh).get(self.model_axis, 1)

    def check_batch(self, batch: int) -> None:
        if self.data_shards > 1 and batch % self.data_shards != 0:
            raise ValueError(f"batch {batch} not divisible by data_shards={self.data_shards}")

    # -- the rank's place on the mesh (the port's multi-controller view) --

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every mesh dim (empty without a mesh)."""
        if self.mesh is None:
            return {}
        return {name: int(self.mesh.get_local_rank(name)) for name in self.mesh.mesh_dim_names}

    @property
    def data_rank(self) -> int:
        """This rank's data group: it holds batch rows
        ``[data_rank·B/d, (data_rank+1)·B/d)`` (the index over
        ``data_axes``, pod-major)."""
        c, sizes = self.coords(), mesh_sizes(self.mesh)
        rank = 0
        for ax in self.data_axes:
            rank = rank * sizes[ax] + c[ax]
        return rank

    def group(self, axis: str) -> Any:
        """The process group of this rank's peers along mesh axis ``axis``."""
        return self.mesh.get_group(axis)

    def data_groups(self) -> Tuple[Any, ...]:
        """The process groups of ``data_axes`` whose size is over 1: a sum
        over each in turn is the sum over the data-parallel ranks."""
        sizes = mesh_sizes(self.mesh)
        return tuple(self.mesh.get_group(a) for a in self.data_axes if sizes[a] > 1)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (equal shapes) concatenated on dim 0 in
        data-rank order (pod-major): gathered over the inner data axis
        first, then over "pod"."""
        for ax in reversed(self.data_axes):
            t = C.all_gather(t, 0, self.group(ax))
        return t

    def broadcast_rows(self, t: torch.Tensor, data_rank: int) -> torch.Tensor:
        """``t`` of the ranks at data index ``data_rank`` (and this rank's
        model index) to every rank, in place: over the inner data axis from
        the holder's coordinate there (every pod's rank at it sends), then
        over "pod" from the holder's pod."""
        sizes, idx = mesh_sizes(self.mesh), int(data_rank)
        for ax in reversed(self.data_axes):
            C.broadcast(t, idx % sizes[ax], self.group(ax))
            idx //= sizes[ax]
        return t


def shard_ctx(mesh: Any, data_shards: Optional[int] = None, fsdp: bool = False) -> ShardCtx:
    """A :class:`ShardCtx` from a mesh (or a bare shard count), as in JAX:
    ``shard_ctx(mesh)`` puts the batch over the mesh's ``("pod", "data")``
    axes and "model" to tensor parallelism; ``shard_ctx(None,
    data_shards=d)`` is the partitioned semantics alone. A given
    ``data_shards`` must equal the mesh's data degree."""
    if mesh is None:
        return ShardCtx(data_shards=int(data_shards or 1), fsdp=fsdp)
    sizes = mesh_sizes(mesh)
    bd = batch_axes(mesh)
    d = _axis_size(sizes, bd)
    if data_shards is not None and int(data_shards) != d:
        raise ValueError(f"data_shards={data_shards} != mesh data degree {d}")
    model = "model" if "model" in sizes else None
    return ShardCtx(mesh=mesh, data_axes=bd, model_axis=model, data_shards=d, fsdp=fsdp)


# ---------------------------------------------------------------------------
# The running model call's mesh, for the layer code
# ---------------------------------------------------------------------------


# (ShardCtx, whether batch statistics are global) of the running model call
_RUNNING: contextvars.ContextVar = contextvars.ContextVar("model_parallel", default=None)


@contextlib.contextmanager
def model_parallel(spmd: Optional[ShardCtx], batch: bool = False):
    """Make ``spmd``'s mesh the one the layer code asks :func:`is_split`
    about and reduces and gathers over for the duration of a model call
    (the port's counterpart of JAX's ambient mesh). ``batch``: the call
    runs on this rank's rows of a global batch whose statistics (losses,
    load balance) every rank computes (a training forward,
    :func:`batch_sum`). A no-op without a mesh."""
    if spmd is None or spmd.mesh is None:
        yield
        return
    token = _RUNNING.set((spmd, batch))
    try:
        yield
    finally:
        _RUNNING.reset(token)


@contextlib.contextmanager
def resumed(run: Any):
    """Re-enter a running model call's context captured by
    :func:`current` (a recomputation in the backward runs on autograd's
    threads, which do not see the caller's context)."""
    token = _RUNNING.set(run)
    try:
        yield
    finally:
        _RUNNING.reset(token)


def current() -> Any:
    """The running model call's context, for :func:`resumed`."""
    return _RUNNING.get()


def running() -> Optional[ShardCtx]:
    """The running model call's context (None outside one on a mesh)."""
    run = _RUNNING.get()
    return None if run is None else run[0]


def is_split(name: str) -> bool:
    """Whether the running model call's weights hold a rank's part of the
    leaf ``name`` (a :func:`leaf_name`), as :func:`shard_params` recorded."""
    spmd = running()
    return spmd is not None and name in spmd.split


def model_rank() -> int:
    """This rank's index on the running model call's model axis."""
    return running().coords()["model"]


def running_cache_config(cfg: ModelConfig) -> ModelConfig:
    """:func:`local_cache_config` of the running model call: the config a
    prefill makes its caches with."""
    return local_cache_config(cfg, running())


def _model_group() -> Any:
    return running().mesh.get_group("model")


def copy_model(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as it is; under autograd, when the leaf ``name`` is split, its
    gradient is summed over the model axis (the input of a column-parallel
    product: ``wq``/``wk``/``wv``, ``w_up``/``w_gate``, the experts,
    ``unemb``; and the MoE combine's gates)."""
    if not is_split(name) or not torch.is_grad_enabled():
        return x
    return C.copy_to(x, _model_group())


def reduce_model(x: torch.Tensor, name: str) -> torch.Tensor:
    """The sum over the model axis of partial products (``wo``, ``w_down``
    and the expert combine, whose contraction dim is split) when the leaf
    ``name`` is split (its gradient passed through under autograd);
    ``x`` as it is otherwise. Gloo reduces CUDA tensors itself, so this
    never stages through the host."""
    if not is_split(name):
        return x
    if torch.is_grad_enabled():
        return C.reduce_from(x, _model_group())
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_model_group())
    return x


def sum_model(x: torch.Tensor, name: str) -> torch.Tensor:
    """The sum over the model axis of a per-rank partial statistic (the
    SSM's gated-norm sum of squares over a rank's ``d_inner`` channels)
    when the leaf ``name`` is split, summed over it in the backward too
    (every rank's part of the statistic feeds every rank's output)."""
    if not is_split(name):
        return x
    if torch.is_grad_enabled():
        return C.sum_over(x, (_model_group(),))
    return C.all_reduce(x.contiguous(), _model_group())


def whole_in_split(leaf: torch.Tensor, name: str, block: str) -> torch.Tensor:
    """A leaf ``name`` the rules leave whole, as a rank uses it inside a
    block whose leaf ``block`` is split: under autograd its gradient,
    partial on each rank (from the rank's own part of the block), comes
    out summed over the model axis, so the leaf stays replicated. The leaf
    as it is otherwise."""
    if not torch.is_grad_enabled() or is_split(name) or not is_split(block):
        return leaf
    return C.copy_to(leaf, _model_group())


def gather_model(x: torch.Tensor, dim: int, name: str) -> torch.Tensor:
    """Every model rank's slice of ``x`` along ``dim`` (the D-sharded
    embedding rows, the vocab-sharded logits) when the leaf ``name`` is
    split (the gradient's own slice back under autograd)."""
    if not is_split(name):
        return x
    if torch.is_grad_enabled():
        return C.gather_from(x, dim, _model_group())
    return C.all_gather(x, dim, _model_group())


def gather_data(params: Any, spmd: Optional[ShardCtx], skip: Sequence[str] = ()) -> Any:
    """FSDP: ``params`` (a parameter tree, or one layer group of it) with
    every leaf ``spmd`` cut over "data" gathered whole on its
    :func:`fsdp_dim` (reduce-scattered back under autograd); the subtrees
    under the top-level keys in ``skip`` as they are; ``params`` itself
    without such leaves."""
    if spmd is None or not spmd.data_split:
        return params
    group = spmd.group("data")
    grad = torch.is_grad_enabled()

    def one(keys, leaf):
        path = _path(keys)
        if leaf_name(path) not in spmd.data_split:
            return leaf
        dim = fsdp_dim(path, leaf.dim())
        return C.gather_params(leaf, dim, group) if grad else C.all_gather(leaf, dim, group)

    if isinstance(params, dict) and skip:
        return {k: v if k in skip else _rebuild(v, one, (k,)) for k, v in params.items()}
    return _rebuild(params, one)


# ---------------------------------------------------------------------------
# Global batch statistics of a training call
# ---------------------------------------------------------------------------


def batch_degree() -> int:
    """The number of data-parallel ranks whose rows make the running
    call's global batch (1 outside a training call on a mesh)."""
    run = _RUNNING.get()
    if run is None or not run[1]:
        return 1
    return run[0].data_shards


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks of the running training
    call, with the sum's adjoint in the backward (every rank's upstream
    gradient is the same, so each rank's rows get ``d`` times their share
    and the data-axis mean of the ranks' gradients is the global one);
    ``x`` itself off a mesh."""
    if batch_degree() == 1:
        return x
    return C.sum_over(x, running().data_groups())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every element of the global batch (each rank
    holds ``x.numel()`` of them); ``x.mean()`` off a mesh."""
    d = batch_degree()
    if d == 1:
        return x.mean()
    return batch_sum(x.sum()) / (x.numel() * d)


def global_mean_rows(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of ``x`` across the global batch; ``x.mean(0)``
    off a mesh."""
    d = batch_degree()
    if d == 1:
        return x.mean(dim=0)
    return batch_sum(x.sum(dim=0)) / (x.shape[0] * d)


def batch_rows() -> Tuple[int, int]:
    """(this rank's index among the data-parallel ranks, their number) of
    the running training call; (0, 1) off a mesh. A rank's rows of a
    global batch are the index-th of that many equal parts."""
    d = batch_degree()
    return (0, 1) if d == 1 else (running().data_rank, d)
