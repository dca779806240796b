"""Train step factory + fault-tolerant training loop.

Port of ``repro/train/loop.py``. :func:`make_train_step` builds the step:
loss and gradients by autograd -> global-norm clip -> cosine LR -> AdamW,
with optional gradient accumulation over microbatches (the sum in f32, as
the JAX scan's carry). The step updates the state in place (the optimizer
writes parameters and moments where they lie) and returns it.

:class:`Trainer` wires it to a loader and the checkpoint manager:
resume from the newest readable checkpoint, periodic saves, a NaN-loss
circuit breaker and a per-step heartbeat. Checkpoints hold the JAX
package's train-state layout (groups stacked, ``opt/{m,v,count}``,
``step``), so either package resumes from the other's.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.params import from_jax_params, stack_groups
from repro_torch.utils import tree_leaves

State = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def _trainable(params: Any) -> Any:
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def make_train_state(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0,
                     params: Optional[Any] = None) -> State:
    """Fresh parameters (or ``params``), zero AdamW moments, step 0."""
    if params is None:
        params = api.init_model(cfg, device=device, seed=seed)
    return {"params": _trainable(params), "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def state_to_host(state: State) -> Dict[str, Any]:
    """The train state in the JAX package's layout, as CPU tensors."""
    return {
        "params": stack_groups(state["params"]),
        "opt": {"m": stack_groups(state["opt"]["m"]), "v": stack_groups(state["opt"]["v"]),
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


def _split_micro(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[State, Dict[str, torch.Tensor]], Tuple[State, Metrics]]:
    ocfg = tcfg.optim

    def loss_fn(params, batch, step: int):
        # one CPU generator per step (the JAX fold_in(seed, step)): it seeds
        # the stochastic router's draws, the same for every microbatch
        gen = torch.Generator().manual_seed(tcfg.seed * 1_000_003 + step)
        return api.model_loss(params, cfg, batch, generator=gen)

    def grads_of(params, batch, step: int):
        leaves = tree_leaves(params)
        n = tcfg.microbatches
        if n <= 1:
            loss, aux = loss_fn(params, batch, step)
            return loss.detach(), aux, _grad(loss, leaves)
        mbs = {k: _split_micro(v, n) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            loss, aux = loss_fn(params, {k: v[i] for k, v in mbs.items()}, step)
            for a, g in zip(acc, _grad(loss, leaves)):
                a += g.float()
            loss_sum = loss_sum + loss.detach()
        return loss_sum / n, aux, [a / n for a in acc]

    def step_fn(state: State, batch: Dict[str, torch.Tensor]) -> Tuple[State, Metrics]:
        step = int(state["step"])
        loss, aux, grads = grads_of(state["params"], batch, step)
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm)
        lr = cosine_schedule(step, ocfg)
        adamw_update(state["params"], grads, state["opt"], ocfg, float(lr))
        metrics: Metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss})
        state["step"] = state["step"] + 1
        return state, metrics

    return step_fn


class Trainer:
    """Fault-tolerant loop: resume -> step -> heartbeat -> checkpoint."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        loader,
        step_fn: Optional[Callable] = None,
        ckpt: Optional[CheckpointManager] = None,
        log_fn: Callable[[str], None] = print,
        device: DeviceLike = None,
    ):
        self.cfg, self.tcfg, self.loader = cfg, tcfg, loader
        self.device = resolve_device(device)
        self.step_fn = step_fn or make_train_step(cfg, tcfg)
        self.ckpt = ckpt or CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep_ckpts, async_save=tcfg.async_ckpt
        )
        self.log = log_fn
        self.heartbeats: List[Tuple[int, float]] = []  # (step, wall seconds)

    def init_or_resume(self) -> State:
        restored = self.ckpt.restore_latest()
        if restored is not None:
            step, tree = restored
            self.log(f"[trainer] resumed from checkpoint step {step}")
            if hasattr(self.loader, "step"):
                self.loader.step = int(step)
            return state_from_host(tree, self.device)
        self.log("[trainer] fresh init")
        return make_train_state(self.cfg, self.device, seed=self.tcfg.seed)

    def save(self, state: State, wait: bool = False) -> None:
        self.ckpt.save(int(state["step"]), state_to_host(state), wait=wait)

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
