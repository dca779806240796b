"""Serving driver of the port: continuous-batching MoD decode over a
request stream, on the GPU unless ``--device cpu``.

Mirrors ``repro/launch/serve.py`` for the flags of the padded engine, plus
``--device``. Weights are random, drawn from ``--seed``. Prompt lengths
are mixed uniformly over ``[--min-prompt-len, --prompt-len]``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mod-paper-1b \\
      --dtype bfloat16 --batch 8 --requests 16 \\
      --min-prompt-len 128 --prompt-len 1024 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.config import get_config, smoke_config, with_mod_backend
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.serve import EngineConfig, Request, ServingEngine, add_engine_args


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mod-paper-60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8, help="decode-batch slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="shortest prompt (default: --prompt-len, all equal)")
    ap.add_argument("--gen", type=int, default=32, help="tokens per request")
    ap.add_argument("--requests", type=int, default=0, help="total requests (default: 2x batch)")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="submit one request every N engine steps (0 = all upfront)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--backend", default=None, choices=["xla", "pallas", "pallas_fused"],
                    help="MoD dispatch backend, as in the JAX CLI; all three run the "
                         "same CUDA gather/scatter kernels (default: the arch's own)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    add_engine_args(ap)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.backend:
        cfg = with_mod_backend(cfg, args.backend)
    params = api.init_model(cfg, device=args.device, seed=args.seed)

    n_requests = args.requests or 2 * args.batch
    lo = args.min_prompt_len or args.prompt_len
    lens = np.random.default_rng(args.seed).integers(lo, args.prompt_len + 1, n_requests)
    data = SyntheticLM(cfg.vocab, args.prompt_len, seed=7)
    prompts = np.asarray(data.batch(0, n_requests)["tokens"])
    ctx = args.prompt_len + args.gen
    engine = ServingEngine(params, cfg, EngineConfig.from_args(args, batch_size=args.batch,
                                                               ctx=ctx), device=args.device)
    outputs = engine.run_stream(
        [Request(tokens=prompts[i, : lens[i]], max_new_tokens=args.gen)
         for i in range(n_requests)],
        args.arrival_every,
    )

    s = engine.stats()
    lat = np.asarray([o.residency_steps for o in outputs], np.float64)
    kv = engine.pool.cache_bytes()
    print(f"[serve] arch={cfg.name} device={engine.device} slots={args.batch} ctx={ctx} "
          f"requests={len(outputs)} policy={args.policy}")
    print(f"[serve] {s['steps']:.0f} engine steps in {s['wall_s']:.2f}s: "
          f"{s['tokens_per_s']:.1f} tok/s aggregate, mean occupancy "
          f"{s['mean_occupancy']:.2f}/{args.batch}; prefill {s['prefill_s']:.2f}s over "
          f"{s['prefills']:.0f} prompts, decode {s['decode_s']:.2f}s over "
          f"{s['decode_steps']:.0f} steps")
    print(f"[serve] latency (steps): p50={np.percentile(lat, 50):.0f} "
          f"p95={np.percentile(lat, 95):.0f}")
    if np.isfinite(s["mean_routed_frac"]):
        print(f"[serve] MoD decode routed fraction: {s['mean_routed_frac']:.3f} "
              f"(capacity_ratio={cfg.mod.capacity_ratio}); KV pool "
              f"{kv['total'] / 2**20:.1f} MiB (mod/full cache ratio "
              f"{kv['mod_vs_full_ratio']:.2f})")
    print(f"[serve] kernel launches: {build.launch_counts()} (0 on the CPU: plain versions)")
    first = min(outputs, key=lambda o: o.uid)
    print(f"[serve] sample continuation: {first.tokens[-10:].tolist()}")


if __name__ == "__main__":
    main()
