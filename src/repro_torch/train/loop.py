"""Train step factory + fault-tolerant training loop.

Port of ``repro/train/loop.py``. :func:`make_train_step` builds the step:
loss and gradients by autograd -> global-norm clip -> cosine LR -> AdamW,
with optional gradient accumulation over microbatches (the sum in f32, as
the JAX scan's carry). The step updates the state in place (the optimizer
writes parameters and moments where they lie) and returns it.

On a mesh (``spmd``, a ``ShardCtx`` with a ``DeviceMesh``) every rank runs
the same step on its rows of the global batch and its shards of the state
(:class:`MeshLayout`): the local loss and gradients (the loss is the
global batch's, see ``models.api.model_loss``), then the data-axis mean of
the gradients (an all-reduce; under FSDP the gathered leaves' gradients
come back reduce-scattered), the clip over the global norm, the cosine LR
and AdamW on the rank's shards in place. With microbatches the
gradients are reduced once a step, after the accumulation, as the JAX
step's implicit all-reduce is.

:class:`Trainer` wires it to a loader and the checkpoint manager:
resume from the newest readable checkpoint, periodic saves, a NaN-loss
circuit breaker and a per-step heartbeat. Checkpoints hold the JAX
package's train-state layout (groups stacked, ``opt/{m,v,count}``,
``step``), so either package resumes from the other's; a mesh trainer
gathers its shards for a save (rank 0 writes) and cuts each leaf to its
placement on a restore, so a checkpoint written on one mesh resumes on
another or in one process.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.params import from_jax_params, jax_ndims, stack_groups
from repro_torch.utils import tree_leaves

State = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def _trainable(params: Any) -> Any:
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _on_mesh(spmd: Optional[SH.ShardCtx]) -> bool:
    return spmd is not None and spmd.mesh is not None


class MeshLayout:
    """Where a mesh trainer's parameter leaves lie: each leaf's spec by its
    path (:func:`~repro_torch.distributed.sharding.rank_placement`: JAX's
    rule, "F" over "data" under FSDP, the AdamW moments mirroring it; K/V
    on head ranges), and the collectives of a step over them. ``spmd`` is
    the context with the cut leaves recorded
    (:func:`~repro_torch.distributed.sharding.placed`).

    K/V whose heads do not divide the model axis are held whole over it:
    each rank holds the heads of ``kv_head_range``, and ``kv_copies``
    ranks hold each (every rank under MQA). Each of those ranks computes
    its head's gradient from its own query heads only, so the step sums it
    over them (:meth:`sum_shared_kv`), counts it once in the clip's norm
    and takes one copy of each head for a checkpoint."""

    def __init__(self, cfg: ModelConfig, spmd: SH.ShardCtx):
        full = api.init_model(cfg, device="meta", generator=torch.Generator())
        self.cfg = cfg
        self.spmd = SH.placed(spmd, cfg, full)
        self.sizes = SH.mesh_sizes(spmd.mesh)
        self.full = [(SH._path(keys), leaf) for keys, leaf in SH._leaves(full)]
        # the specs of a rank's shards (the moments mirror them); every
        # layer's leaf of a path has one shape, so one spec a path
        self.specs = {p: SH.rank_placement(p, leaf.shape, cfg, self.sizes, spmd.fsdp)
                      for p, leaf in self.full}
        m = self.sizes.get("model", 1)
        # K/V paths held by several model ranks a head, and this rank's heads
        self.copies = SH.kv_copies(cfg, m)
        self.shared = frozenset(p for p, _ in self.full
                                if self.copies > 1 and SH._ATTN_KV.search(p))
        self.heads = SH.kv_head_range(cfg, m, self.spmd.coords().get("model", 0))
        # one rank: every collective is the identity, and the step is the
        # single-process step's arithmetic
        self.trivial = math.prod(self.sizes.values()) == 1

    def paths_of(self, params: Any) -> List[str]:
        """The path of every leaf of ``params`` (the port's tree), in
        ``tree_leaves`` order."""
        return [SH._path(keys) for keys, _ in SH._leaves(params)]

    def specs_of(self, params: Any) -> List[SH.Spec]:
        """The spec of every leaf of ``params``, in ``tree_leaves`` order."""
        return [self.specs[p] for p in self.paths_of(params)]

    def sum_shared_kv(self, params: Any, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shared K/V leaf's gradient summed over the model ranks that
        hold the same heads: written at its heads' columns of a zero
        full-width buffer, all-reduced over "model" (the other ranks add
        zeros there) and cut back."""
        if not self.shared:
            return grads
        hd, nkv = self.cfg.head_dim, self.cfg.attn.n_kv_heads
        lo, hi = self.heads[0] * hd, self.heads[1] * hd
        out = list(grads)
        idx = [i for i, p in enumerate(self.paths_of(params)) if p in self.shared]
        wide = []
        for i in idx:
            g = grads[i]
            buf = torch.zeros(g.shape[:-1] + (nkv * hd,), dtype=g.dtype, device=g.device)
            buf[..., lo:hi] = g
            wide.append(buf)
        for i, buf in zip(idx, _bucket_sum(wide, (self.spmd.group("model"),))):
            out[i] = buf[..., lo:hi].contiguous()
        return out

    def mean_grads(self, params: Any, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of the step: shared K/V summed over their model
        ranks (:meth:`sum_shared_kv`), then the data-axis mean: summed over
        the data-parallel ranks (one bucketed all-reduce a dtype; a leaf cut
        over "data" was summed over it by its gather's reduce-scatter, and
        is summed over "pod" only), divided by their number."""
        grads = self.sum_shared_kv(params, grads)
        sp = self.spmd
        if sp.data_shards == 1:
            return grads
        pod = tuple(sp.group(a) for a in sp.data_axes if a == "pod" and self.sizes[a] > 1)
        specs = self.specs_of(params)
        out = list(grads)
        for groups, idx in ((sp.data_groups(), [i for i, s in enumerate(specs) if "data" not in s]),
                            (pod, [i for i, s in enumerate(specs) if "data" in s])):
            for i, g in zip(idx, _bucket_sum([grads[i] for i in idx], groups)):
                out[i] = g
        return [g / sp.data_shards for g in out]

    def total_square(self, params: Any) -> Callable[[List[torch.Tensor]], torch.Tensor]:
        """The clip's sum of the leaves' square-sums: each leaf's summed over
        the mesh axes it is cut on (a replicated leaf counted once; a shared
        K/V head summed over "model" and divided by its copies, so once)."""
        paths = self.paths_of(params)
        sp = self.spmd

        def total(sq: List[torch.Tensor]) -> torch.Tensor:
            by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
            for s, p in zip(sq, paths):
                axes = {a for a in self.specs[p] if a is not None}
                if p in self.shared:
                    s, axes = s / self.copies, axes | {"model"}
                by_axes.setdefault(tuple(sorted(axes)), []).append(s)
            parts = []
            for axes, vals in sorted(by_axes.items()):
                part = torch.sum(torch.stack([v.to(sq[0].device) for v in vals]))
                for ax in axes:
                    part = C.all_reduce(part, sp.group(ax))
                parts.append(part)
            return torch.sum(torch.stack(parts))

        return total

    def gather(self, tree: Any) -> Any:
        """A tree of the params' structure (params or a moment) with every
        leaf gathered whole over the axes it is cut on (a shared K/V leaf:
        gathered over "model" and one copy of each head kept)."""
        def one(keys, leaf):
            path = SH._path(keys)
            t = leaf.detach()
            for dim, ax in enumerate(self.specs[path]):
                if ax is not None and self.sizes[ax] > 1:
                    t = C.all_gather(t, dim, self.spmd.group(ax))
            if path in self.shared:
                m, width = self.sizes["model"], t.shape[-1]
                t = C.all_gather(t, t.dim() - 1, self.spmd.group("model"))
                t = t.reshape(t.shape[:-1] + (m, width))[..., ::self.copies, :]
                t = t.reshape(t.shape[:-2] + (-1,))
            return t

        return SH._rebuild(tree, one)

    def cut(self, key: str, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's part of a checkpoint leaf (the JAX layout's flat key
        ``params/...``, ``opt/m/...``, ``opt/v/...``, or a replicated
        scalar)."""
        for prefix in ("params/", "opt/m/", "opt/v/"):
            if key.startswith(prefix):
                out = SH.cut_leaf(key[len(prefix):], leaf, self.cfg, self.sizes,
                                  self.spmd.coords(), self.spmd.fsdp)
                return out.contiguous().clone() if out is not leaf else leaf
        return leaf

    def placed_bytes(self) -> int:
        """The bytes of this rank's parameters and AdamW moments that the
        placement gives (each leaf's full size over the product of its
        axes' sizes, a shared K/V leaf's at its heads' share; moments
        f32)."""
        total = 0
        nkv = self.cfg.attn.n_kv_heads
        for p, leaf in self.full:
            n = leaf.numel() // math.prod(self.sizes[a] for a in self.specs[p] if a is not None)
            if p in self.shared:
                n = n * (self.heads[1] - self.heads[0]) // nkv
            total += n * (leaf.element_size() + 8)
        return total


def _bucket_sum(tensors: List[torch.Tensor], groups) -> List[torch.Tensor]:
    """Each tensor summed over every group in turn, one all-reduce a dtype
    and group (the tensors flattened into one buffer)."""
    if not tensors or not groups:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for group in groups:
            C.all_reduce(flat, group)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def state_bytes(state: State) -> int:
    """Bytes of the parameters and AdamW moments a state holds (a rank's
    shards on a mesh)."""
    return sum(t.numel() * t.element_size()
               for tree in (state["params"], state["opt"]["m"], state["opt"]["v"])
               for t in tree_leaves(tree))


def make_train_state(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0,
                     params: Optional[Any] = None, spmd: Optional[SH.ShardCtx] = None) -> State:
    """Fresh parameters (or ``params``), zero AdamW moments, step 0. On a
    mesh (``spmd``) the rank keeps its shards of the full parameters (every
    rank draws the same ones from ``seed``), and moments of their shapes."""
    if params is None:
        params = api.init_model(cfg, device=device, seed=seed)
    if _on_mesh(spmd):
        params, _ = SH.shard_params(params, cfg, spmd)
    return {"params": _trainable(params), "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def state_to_host(state: State, layout: Optional[MeshLayout] = None) -> Dict[str, Any]:
    """The train state in the JAX package's layout, as CPU tensors (on a
    mesh, every rank's shards gathered first: a collective)."""
    gather = (lambda t: t) if layout is None else layout.gather
    return {
        "params": stack_groups(gather(state["params"])),
        "opt": {"m": stack_groups(gather(state["opt"]["m"])),
                "v": stack_groups(gather(state["opt"]["v"])),
                "count": state["opt"]["count"].detach().cpu().to(torch.int32)},
        "step": state["step"].detach().cpu().to(torch.int32),
    }


def state_from_host(tree: Dict[str, Any], device: DeviceLike = None) -> State:
    """A train state in the JAX layout (for example a restored checkpoint)
    on ``device``, parameters ready for autograd."""
    opt = tree["opt"]
    return {
        "params": _trainable(from_jax_params(tree["params"], device)),
        "opt": {"m": from_jax_params(opt["m"], device), "v": from_jax_params(opt["v"], device),
                "count": torch.as_tensor(opt["count"]).to(torch.int32).reshape(())},
        "step": torch.as_tensor(tree["step"]).to(torch.int32).reshape(()),
    }


def _grad(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaves; a leaf the loss does not reach gets zeros (as
    jax.grad gives)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _split_micro(key: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` microbatches of a batch leaf on a new leading axis: M-RoPE
    positions ``(3, B, S)`` split their batch axis 1, as JAX's
    ``_split_micro`` does."""
    if key.endswith("positions") and x.dim() == 3 and x.shape[0] == 3:
        return x.reshape((3, n, x.shape[1] // n) + tuple(x.shape[2:])).transpose(0, 1)
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


GradsFn = Callable[[Any, Dict[str, torch.Tensor], int],
                   Tuple[torch.Tensor, Metrics, List[torch.Tensor]]]


def make_grads_fn(cfg: ModelConfig, tcfg: TrainConfig, spmd: Optional[SH.ShardCtx] = None,
                  layout: Optional[MeshLayout] = None) -> GradsFn:
    """``grads(params, batch, step) -> (loss, aux, grads)``: the step's loss
    (the mean over microbatches), the last microbatch's aux and the
    gradients in ``tree_leaves`` order, on a mesh the data-axis mean of
    the ranks' (``layout``, built from ``spmd`` when not given)."""
    if layout is None and _on_mesh(spmd):
        layout = MeshLayout(cfg, spmd)
    run = layout.spmd if layout is not None else spmd

    def loss_fn(params, batch, step: int):
        # one CPU generator per step (the JAX fold_in(seed, step)): it seeds
        # the stochastic router's draws, the same for every microbatch
        gen = torch.Generator().manual_seed(tcfg.seed * 1_000_003 + step)
        return api.model_loss(params, cfg, batch, generator=gen, spmd=run)

    def grads_of(params, batch, step: int):
        leaves = tree_leaves(params)
        n = tcfg.microbatches
        if n <= 1:
            loss, aux = loss_fn(params, batch, step)
            grads = _grad(loss, leaves)
            loss = loss.detach()
        else:
            mbs = {k: _split_micro(k, v, n) for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(n):
                loss, aux = loss_fn(params, {k: v[i] for k, v in mbs.items()}, step)
                for a, g in zip(acc, _grad(loss, leaves)):
                    a += g.float()
                loss_sum = loss_sum + loss.detach()
            loss, grads = loss_sum / n, [a / n for a in acc]
        if layout is not None:
            grads = layout.mean_grads(params, grads)
        return loss, aux, grads

    return grads_of


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, spmd: Optional[SH.ShardCtx] = None
                    ) -> Callable[[State, Dict[str, torch.Tensor]], Tuple[State, Metrics]]:
    """The step ``(state, batch) -> (state, metrics)``; ``spmd`` (a
    ``ShardCtx``) runs it on a mesh: every rank calls it with its rows and
    its shards of the state (:func:`make_train_state`)."""
    ocfg = tcfg.optim
    if ocfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={ocfg.grad_compression!r}: the JAX train step never reads it "
            "(ROADMAP Queue 3); call repro_torch.optim.compression.compressed_all_reduce")
    layout = MeshLayout(cfg, spmd) if _on_mesh(spmd) else None
    grads_of = make_grads_fn(cfg, tcfg, spmd, layout)

    def step_fn(state: State, batch: Dict[str, torch.Tensor]) -> Tuple[State, Metrics]:
        step = int(state["step"])
        loss, aux, grads = grads_of(state["params"], batch, step)
        total = None if layout is None or layout.trivial else layout.total_square(state["params"])
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm, total)
        lr = cosine_schedule(step, ocfg)
        # weight decay where the JAX tree's leaf has ndim >= 2 (its stacked groups)
        decay = [n >= 2 for n in jax_ndims(state["params"])]
        adamw_update(state["params"], grads, state["opt"], ocfg, float(lr), decay)
        metrics: Metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss})
        state["step"] = state["step"] + 1
        return state, metrics

    return step_fn


class Trainer:
    """Fault-tolerant loop: resume -> step -> heartbeat -> checkpoint.

    On a mesh (``spmd``) every rank runs one: the loader gives the rank's
    rows, the state holds its shards, a save gathers them (every rank
    takes part; rank 0 writes) and a restore cuts each leaf of the newest
    checkpoint to this rank's placement, whatever mesh wrote it."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        loader,
        step_fn: Optional[Callable] = None,
        ckpt: Optional[CheckpointManager] = None,
        log_fn: Callable[[str], None] = print,
        device: DeviceLike = None,
        spmd: Optional[SH.ShardCtx] = None,
    ):
        self.cfg, self.tcfg, self.loader = cfg, tcfg, loader
        self.device = resolve_device(device)
        self.spmd = spmd
        self.layout = MeshLayout(cfg, spmd) if _on_mesh(spmd) else None
        self.step_fn = step_fn or make_train_step(cfg, tcfg, spmd)
        self.ckpt = ckpt or CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep_ckpts, async_save=tcfg.async_ckpt
        )
        self.log = log_fn
        self.heartbeats: List[Tuple[int, float]] = []  # (step, wall seconds)

    def init_or_resume(self) -> State:
        restored = self.ckpt.restore_latest(None if self.layout is None else self.layout.cut)
        if restored is not None:
            step, tree = restored
            self.log(f"[trainer] resumed from checkpoint step {step}")
            if hasattr(self.loader, "step"):
                self.loader.step = int(step)
            return state_from_host(tree, self.device)
        self.log("[trainer] fresh init")
        return make_train_state(self.cfg, self.device, seed=self.tcfg.seed, spmd=self.spmd)

    def save(self, state: State, wait: bool = False) -> None:
        host = state_to_host(state, self.layout)
        if self.layout is None or dist.get_rank() == 0:
            self.ckpt.save(int(state["step"]), host, wait=wait)

    def run(self, state: State, n_steps: int) -> Tuple[State, Dict[str, float]]:
        last_metrics: Dict[str, float] = {}
        start_step = int(state["step"])
        for i in range(n_steps):
            batch = next(self.loader)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step to finish on the device
            self.heartbeats.append((start_step + i, time.perf_counter() - t0))
            if not torch.isfinite(torch.tensor(loss)):
                # circuit breaker: stop before a NaN state reaches a checkpoint
                self.ckpt.wait()
                raise FloatingPointError(f"non-finite loss at step {start_step + i}")
            step_no = start_step + i + 1
            if step_no % self.tcfg.log_every == 0:
                self.log(
                    f"[trainer] step {step_no} loss={loss:.4f} "
                    f"ce={float(metrics.get('ce', loss)):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f}"
                )
            if step_no % self.tcfg.ckpt_every == 0:
                self.save(state)
            last_metrics = {k: float(v.float().mean()) for k, v in metrics.items()}
        self.ckpt.wait()
        return state, last_metrics
