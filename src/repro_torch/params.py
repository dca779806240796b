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
bit survives both ways. The router and predictor are f32 on both sides.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]


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


def from_jax_params(tree: Tree, device: DeviceLike = None) -> Tree:
    """JAX parameter tree (numpy leaves) -> the port's parameters on
    ``device``. Groups come out in order, each holding its ``full`` block
    and then its ``mod`` routed block; ``tail`` stays a single block."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(a, dev)  # noqa: E731
    out: Tree = {k: _map(v, conv) for k, v in tree.items() if k != "groups"}
    stacked = tree["groups"]
    n_groups = {leaf.shape[0] for leaf in _leaves(stacked)}
    if len(n_groups) != 1:
        raise ValueError(f"group leaves disagree on the group count: {sorted(n_groups)}")
    (n,) = n_groups
    groups: List[Tree] = []
    for i in range(n):
        groups.append({kind: _map(stacked[kind], lambda a, i=i: _to_tensor(a[i], dev))
                       for kind in stacked})
    out["groups"] = groups
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
                 if k != "groups"}
    groups = params["groups"]
    out["groups"] = {
        kind: _stack([g[kind] for g in groups]) for kind in groups[0]
    }
    return out


def to_numpy_tree(params: Tree) -> Tree:
    """:func:`stack_groups` as numpy arrays. bfloat16 leaves come back as
    their ``uint16`` bit patterns (``arr.view(ml_dtypes.bfloat16)``
    restores the type)."""
    return _map(stack_groups(params), _to_numpy)


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach().cpu() for t in trees])
