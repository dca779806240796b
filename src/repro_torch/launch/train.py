"""Training driver of the port, on one device (the GPU unless
``--device cpu``).

The single-device form of ``repro/launch/train.py``: random weights from
``--seed``, the synthetic corpus of ``data/synthetic.py``, and the
fault-tolerant :class:`~repro_torch.train.Trainer` (resume from the newest
checkpoint in ``--ckpt-dir``, periodic and final saves, NaN circuit
breaker). ``--backend`` picks the MoD dispatch backend; ``pallas_fused``
runs the routed blocks through the fused routed-attention and routed-MLP
kernels. The mesh, FSDP and model-axis flags of the JAX driver come with
multi-device support.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mod-paper-1b \\
      --backend pallas_fused --batch 4 --seq 2048 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --batch 4 --seq 2048 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu --steps 3

An MoE model's last step also prints its MoE aux terms (load-balance and
router-z losses, dropped and no-op fractions, per block kind).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    OptimConfig,
    TrainConfig,
    get_config,
    smoke_config,
    with_mod_backend,
)
from repro_torch.data.loader import SyntheticLoader
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.train import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mod-paper-60m")
    ap.add_argument("--smoke", action="store_true", help="reduced config of the arch family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dtype", default=None, help="override model dtype (e.g. float32)")
    ap.add_argument("--backend", default=None, choices=["xla", "pallas", "pallas_fused"],
                    help="MoD dispatch backend (default: the arch's own)")
    ap.add_argument("--device", default="cuda")
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
    loader = SyntheticLoader(SyntheticLM(cfg.vocab, args.seq, seed=tcfg.seed), args.batch, device)
    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts, async_save=tcfg.async_ckpt)
    trainer = Trainer(cfg, tcfg, loader, ckpt=ckpt, device=device)
    state = trainer.init_or_resume()
    start = int(state["step"])
    build.reset_counters()
    state, metrics = trainer.run(state, max(0, args.steps - start))
    counts = build.launch_counts()
    trainer.save(state, wait=True)
    print(f"[train] {cfg.name} ({cfg.mod.backend}) on {device}: done at step {int(state['step'])}: "
          f"loss={metrics.get('loss', float('nan')):.4f} ce={metrics.get('ce', float('nan')):.4f}")
    moe_aux = {k: v for k, v in metrics.items() if "moe/" in k}
    if moe_aux:
        print(f"[train] moe aux (last step): {json.dumps(moe_aux)}")
    print(f"[train] kernel launches: {json.dumps(counts)}")


if __name__ == "__main__":
    main()
