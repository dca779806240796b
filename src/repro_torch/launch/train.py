"""Training entry point of the port, on the GPU unless ``--device cpu``.

The port of ``repro/launch/train.py``: random weights from the seed, the
synthetic corpus of ``data/synthetic.py`` through the prefetching
:class:`~repro_torch.data.loader.ShardedLoader`, and the fault-tolerant
:class:`~repro_torch.train.Trainer` (resume from the newest checkpoint in
``--ckpt-dir``, periodic and final saves, NaN circuit breaker).
``--backend`` picks the MoD dispatch backend; ``pallas_fused`` runs the
routed blocks through the fused routed-attention and routed-MLP kernels.

Multi-device (``--spmd``): one process a device under ``torchrun`` (NCCL on
CUDA, gloo with ``--device cpu``), every rank training on its rows of each
global batch over a ("data", "model") mesh of all ranks: ``--data-axis``
(0 = all ranks the model and pod axes leave), ``--model-axis`` (tensor
parallel, any family), ``--pod-axis`` (> 1: a ("pod", "data", "model")
mesh, the batch over pod × data), ``--fsdp`` (parameters and
moments cut over "data" too), ``--microbatches`` (rank r's microbatch i is
its slice of global microbatch i). Rank 0 prints one ``[train] mesh:`` line
and writes the checkpoints (the JAX layout, gathered from every rank).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mod-paper-1b \\
      --backend pallas_fused --batch 4 --seq 2048 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --batch 4 --seq 2048 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu --steps 3
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --spmd --model-axis 2 --device cpu --smoke --steps 2

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-7b --smoke --device cpu --steps 3

An MoE model's last step also prints its MoE aux terms (load-balance and
router-z losses, dropped and no-op fractions, per block kind). The
enc-dec and VLM families take their frontends' outputs as stubs
(``api.stub_inputs``, seeded by ``--seed`` and the step, drawn for the
global batch): encoder frames beside the tokens (whisper), embeddings and
M-RoPE positions in place of the tokens (qwen2-vl), as the JAX package's
tests feed them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    MeshConfig,
    OptimConfig,
    TrainConfig,
    get_config,
    smoke_config,
    with_mod_backend,
)
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.train import Trainer
from repro_torch.train.loop import state_bytes


def stub_frontend(cfg, seed: int):
    """The loader transform of the enc-dec and VLM families: the stub
    frontend's inputs (``api.stub_inputs``) of the global batch, drawn from
    ``seed`` and the batch's step; a VLM batch drops its tokens for the
    embeddings."""

    def transform(step, batch):
        B, S = batch["labels"].shape
        batch.update(api.stub_inputs(cfg, B, S, seed=seed * 1_000_003 + step, device="cpu"))
        if cfg.family == "vlm":
            del batch["tokens"]
        return batch

    return transform


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mod-paper-60m")
    ap.add_argument("--smoke", action="store_true", help="reduced config of the arch family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--spmd", action="store_true",
                    help="train over a ('data','model') mesh of every rank (run under torchrun)")
    ap.add_argument("--data-axis", type=int, default=0, help="0 = all ranks")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pod-axis", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--dtype", default=None, help="override model dtype (e.g. float32)")
    ap.add_argument("--backend", default=None, choices=["xla", "pallas", "pallas_fused"],
                    help="MoD dispatch backend (default: the arch's own)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the stub frontends' inputs")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.backend:
        cfg = with_mod_backend(cfg, args.backend)

    spmd, say = None, print
    if args.spmd:
        from repro_torch.launch import mesh as M

        device = M.init_process_group("gloo" if args.device == "cpu" else "nccl",
                                      device=args.device)
        n = dist.get_world_size()
        data_ax = args.data_axis or max(1, n // max(args.model_axis * args.pod_axis, 1))
        spmd = M.mesh_ctx(MeshConfig(pod=args.pod_axis, data=data_ax, model=args.model_axis,
                                     fsdp=args.fsdp))
        if dist.get_rank() != 0:
            say = lambda *a, **k: None  # noqa: E731
    else:
        device = resolve_device(args.device)

    tcfg = TrainConfig(
        global_batch=args.batch,
        seq_len=args.seq,
        microbatches=args.microbatches,
        optim=OptimConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                          total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        log_every=10,
        ckpt_every=max(50, args.steps // 4),
    )
    loader = ShardedLoader(
        SyntheticLM(cfg.vocab, args.seq, seed=tcfg.seed), args.batch, device, spmd=spmd,
        microbatches=args.microbatches,
        transform=stub_frontend(cfg, args.seed) if cfg.family in ("encdec", "vlm") else None)
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts, async_save=tcfg.async_ckpt)
    trainer = Trainer(cfg, tcfg, loader, ckpt=ckpt, device=device, spmd=spmd, log_fn=say)
    state = trainer.init_or_resume()
    if spmd is not None:
        say(f"[train] mesh: {M.describe_mesh(spmd.mesh)}, fsdp={spmd.fsdp}; state (params + AdamW "
            f"moments) {state_bytes(state)} bytes a rank, placement "
            f"{trainer.layout.placed_bytes()}")
    start = int(state["step"])
    build.reset_counters()
    try:
        state, metrics = trainer.run(state, max(0, args.steps - start))
        counts = build.launch_counts()
        trainer.save(state, wait=True)
    finally:
        loader.close()
    say(f"[train] {cfg.name} ({cfg.mod.backend}) on {device}: done at step {int(state['step'])}: "
        f"loss={metrics.get('loss', float('nan')):.4f} ce={metrics.get('ce', float('nan')):.4f}")
    moe_aux = {k: v for k, v in metrics.items() if "moe/" in k}
    if moe_aux:
        say(f"[train] moe aux (last step): {json.dumps(moe_aux)}")
    say(f"[train] kernel launches: {json.dumps(counts)}")
    if args.spmd:
        M.destroy_process_group()


if __name__ == "__main__":
    main()
