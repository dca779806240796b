"""Carry weights between the JAX package's parameter tree and the port's.

The JAX tree (``repro.models.api.init_model``) stacks every group leaf on
a leading axis (``jax.vmap`` over groups) so ``lax.scan`` can walk it. The
port keeps one dict per group in a list (``repro_torch.models.transformer``).
:func:`from_jax_params` takes the JAX tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) or CPU tensors (a restored
checkpoint) and unstacks it; :func:`stack_groups` stacks the port's
parameters back into the JAX layout as CPU tensors, :func:`to_numpy_tree`
as numpy arrays. Optimizer moments share the parameters' tree, so the same
functions carry them.

bfloat16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16 type,
which ``torch.from_numpy`` rejects: they travel as their 16-bit
patterns and are reinterpreted (never rounded through float32), so every
bit survives both ways. The router and predictor are f32 on both sides,
as are the Mamba2 blocks' ``A_log``, ``skip_D`` and ``dt_bias`` in a bf16
model; the ssm family's tree ({"full", "mod"} groups of {"ln", "ssm"}
layers) carries the same way. The hybrid's tree (a ``shared_attn`` block
beside its groups) stacks its group leaves on two leading axes,
``(n_seg, n_pairs)``; the port keeps a list of segments, each a list of
group dicts (``repro_torch.models.ssm_lm``), and both functions unfold or
fold the two axes. The enc-dec tree's ``enc_blocks`` (one block stacked
over ``n_enc_layers``) is a list of blocks in the port; its groups carry
decoder blocks (``xattn`` and ``lnx`` beside the rest) as any group does.
The VLM tree is the dense one (with the q/k/v biases).

:func:`shard_jax_params` cuts one rank's shards out of a carried JAX tree
by the sharding rule table (:mod:`repro_torch.distributed.sharding`) before
the conversion, so a mesh rank never holds the whole tree as tensors.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]
# subtrees whose leaves are stacked on leading axes in the JAX tree
STACKED = ("groups", "enc_blocks")


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device, copy=True)
    arr = np.asarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _group_depth(tree: Tree) -> int:
    """Leading group axes of a JAX tree's group leaves: two for the hybrid
    (segments, then the groups of a segment), one otherwise."""
    return 2 if "shared_attn" in tree else 1


def _unstack(stacked: Tree, depth: int, dev: torch.device) -> List[Any]:
    """Group dicts of a stacked JAX subtree, as a list (nested ``depth``
    deep) in the stacking order."""
    n_groups = {leaf.shape[0] for leaf in _leaves(stacked)}
    if len(n_groups) != 1:
        raise ValueError(f"group leaves disagree on the group count: {sorted(n_groups)}")
    (n,) = n_groups
    out: List[Any] = []
    for i in range(n):
        if depth == 1:
            out.append({kind: _map(stacked[kind], lambda a, i=i: _to_tensor(a[i], dev))
                        for kind in stacked})
        else:
            out.append(_unstack(_map(stacked, lambda a, i=i: a[i]), depth - 1, dev))
    return out


def from_jax_params(tree: Tree, device: DeviceLike = None) -> Tree:
    """JAX parameter tree (numpy leaves) -> the port's parameters on
    ``device``. Groups come out in order, each holding its ``full`` block
    and then its ``mod`` routed block; ``tail`` and ``shared_attn`` stay
    single blocks; the hybrid's groups come out as a list of segments."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev)  # noqa: E731
    out: Tree = {k: _map(v, conv) for k, v in tree.items() if k not in STACKED}
    out["groups"] = _unstack(tree["groups"], _group_depth(tree), dev)
    if "enc_blocks" in tree:
        n = _leaves(tree["enc_blocks"])[0].shape[0]
        out["enc_blocks"] = [_map(tree["enc_blocks"], lambda a, i=i: _to_tensor(a[i], dev))
                             for i in range(n)]
    return out


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def stack_groups(params: Tree) -> Tree:
    """The port's parameters (or a tree of their shape) restacked into the
    JAX tree layout, as detached CPU tensors of the same dtypes."""
    out: Tree = {k: _map(v, lambda t: t.detach().cpu()) for k, v in params.items()
                 if k not in STACKED}
    for k in STACKED:
        if k in params:
            out[k] = _stack(params[k])
    return out


def to_numpy_tree(params: Tree) -> Tree:
    """:func:`stack_groups` as numpy arrays. bfloat16 leaves come back as
    their ``uint16`` bit patterns (``arr.view(ml_dtypes.bfloat16)``
    restores the type)."""
    return _map(stack_groups(params), _to_numpy)


def _stack(trees: List[Any]) -> Any:
    """Stack matching trees on a new leading axis; a list of lists (the
    hybrid's segments) stacks its inner lists first."""
    if isinstance(trees, list) and isinstance(trees[0], list):
        return _stack([_stack(t) for t in trees])
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach().cpu() for t in trees])


def jax_ndims(params: Tree) -> List[int]:
    """Each leaf's rank in the JAX tree, in ``tree_leaves`` order of the
    port's ``params``: a group leaf carries the stacking axes (two for the
    hybrid's groups, one for the others and the enc-dec ``enc_blocks``)."""
    depth = {"groups": _group_depth(params), "enc_blocks": 1}
    out: List[int] = []

    def walk(tree: Any, extra: int) -> None:
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v, extra)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, extra)
        else:
            out.append(tree.dim() + extra)

    for k, v in params.items():
        walk(v, depth.get(k, 0))
    return out


def shard_jax_params(tree: Tree, cfg: Any, mesh: Any, coords: Dict[str, int],
                     device: DeviceLike = None) -> Tuple[Tree, FrozenSet[str]]:
    """One rank's shards of a JAX parameter tree (numpy leaves, group leaves
    stacked), as the port's parameters on ``device``, and the names of the
    leaves that were cut (a :class:`~repro_torch.distributed.sharding.ShardCtx`'s
    ``split``: run the shards under that context). Each leaf is cut by
    :func:`repro_torch.distributed.sharding.cut_leaf` at the rank's
    ``coords`` (its index on every axis of ``mesh``, a ``DeviceMesh`` or a
    mapping of axis sizes), then converted as by :func:`from_jax_params`.
    The stacked leading axes are never cut."""
    from repro_torch.distributed.sharding import cut_tree, mesh_sizes

    cut, split = cut_tree(tree, cfg, mesh_sizes(mesh), coords)
    return from_jax_params(cut, device), split
