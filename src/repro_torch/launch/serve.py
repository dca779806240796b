"""Serving driver of the port: continuous-batching MoD decode over a
request stream, on the GPU unless ``--device cpu``.

Mirrors ``repro/launch/serve.py`` for the flags of the padded, paged
(``--page-size``, ``--n-pages``, ``--prefix-cache``), ragged
(``--ragged``, ``--ragged-segments``), self-speculative (``--speculate``,
``--draft-ratio``, ``--verify-budget``) and quantized (``--quant-kv``,
``--quant-scale``) engines, overload control (``--adaptive-capacity``,
``--priority``, ``--deadline``) and fault injection (``--inject-faults``),
plus ``--device``. Weights
are random, drawn from ``--seed``. Prompt lengths are mixed uniformly over
``[--min-prompt-len, --prompt-len]``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mod-paper-1b \\
      --dtype bfloat16 --batch 8 --requests 16 \\
      --min-prompt-len 128 --prompt-len 1024 --gen 32 --page-size 16 --prefix-cache
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --page-size 16 --speculate 3 --draft-ratio 0.0
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --page-size 16 --adaptive-capacity --inject-faults 0 --requests 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --dtype bfloat16 --batch 8 --requests 16 --min-prompt-len 32 --prompt-len 128 --gen 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --smoke --device cpu \
      --batch 4 --requests 6 --prompt-len 8 --gen 6 --page-size 16

Multi-device (``--spmd``): one process a device under ``torchrun``, every
rank running the same engine over a ("data", "model") mesh of all ranks
(``--model-axis`` ranks of tensor parallelism, any family; data takes the
rest; ``--pod-axis`` > 1 makes it ("pod", "data", "model"), the slots cut
over pod × data) over NCCL, or gloo with ``--device cpu``.
``--data-shards`` alone runs the same partitioned MoD routing on one
device. Rank 0 prints.

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve --spmd \
      --model-axis 2 --device cpu --smoke --batch 4 --requests 6 --gen 4

The ssm, hybrid, enc-dec and VLM families (``mamba2-*``, ``zamba2-*``,
``whisper-*``, ``qwen2-vl-*``) ingest prompts one token per decode step,
as the JAX engine serves them; the run prints which path it took. An
enc-dec request carries stub encoder frames (``api.stub_inputs``, seeded
by ``--seed`` and the request's index), which the engine encodes once at
admission; the VLM engine decodes text tokens.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
from torch import distributed as dist

from repro_torch.config import get_config, smoke_config, with_mod_backend
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.serve import EngineConfig, FaultInjector, Request, ServingEngine, add_engine_args


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
    ap.add_argument("--priority", default="batch", choices=["batch", "latency"],
                    help="priority class of the submitted requests: latency-tier is admitted "
                         "first and keeps full MoD capacity under overload")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds from submit; expired requests finish "
                         "as 'expired' instead of occupying slots (0 = no deadline)")
    ap.add_argument("--spmd", action="store_true",
                    help="serve over a ('data','model') mesh of every rank (run under torchrun, "
                         "one process a device): batch-sharded cache pool, shard-local MoD "
                         "routing, tensor parallelism over --model-axis")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel degree of the --spmd mesh")
    ap.add_argument("--pod-axis", type=int, default=1,
                    help="pod degree of the --spmd mesh (> 1: a ('pod','data','model') mesh)")
    ap.add_argument("--inject-faults", type=int, default=-1,
                    help="thread a seeded FaultInjector through the engine (NaN/Inf logits, "
                         "page exhaustion, stragglers, preemption storms) with this seed; "
                         "-1 = off")
    add_engine_args(ap)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.backend:
        cfg = with_mod_backend(cfg, args.backend)
    device, mesh, say = args.device, None, print
    if args.spmd:
        from repro_torch.launch import mesh as M

        device = M.init_process_group("gloo" if args.device == "cpu" else "nccl",
                                      device=args.device)
        mesh = M.auto_mesh(args.model_axis, pod=args.pod_axis)
        if dist.get_rank() != 0:
            say = lambda *a, **k: None  # noqa: E731
        say(f"[serve] SPMD mesh: {M.describe_mesh(mesh)}")
    params = api.init_model(cfg, device=device, seed=args.seed)

    n_requests = args.requests or 2 * args.batch
    lo = args.min_prompt_len or args.prompt_len
    lens = np.random.default_rng(args.seed).integers(lo, args.prompt_len + 1, n_requests)
    data = SyntheticLM(cfg.vocab, args.prompt_len, seed=7)
    prompts = np.asarray(data.batch(0, n_requests)["tokens"])
    ctx = args.prompt_len + args.gen
    if args.page_size:  # the paged pool needs whole pages
        ctx = -(-ctx // args.page_size) * args.page_size
    injector = FaultInjector.seeded(args.inject_faults) if args.inject_faults >= 0 else None
    engine = ServingEngine(params, cfg, EngineConfig.from_args(
        args, batch_size=args.batch, ctx=ctx, fault_injector=injector, mesh=mesh), device=device)

    def enc_emb(i):  # the enc-dec family's stub frontend: frames of its own a request
        if cfg.family != "encdec":
            return None
        return api.stub_inputs(cfg, 1, 0, seed=args.seed + i, device=device)["enc_emb"][0]

    outputs = engine.run_stream(
        [Request(tokens=prompts[i, : lens[i]], max_new_tokens=args.gen, priority=args.priority,
                 deadline_s=args.deadline or None, enc_emb=enc_emb(i))
         for i in range(n_requests)],
        args.arrival_every,
    )

    s = engine.stats()
    lat = np.asarray([o.residency_steps for o in outputs], np.float64)
    kv = engine.pool.cache_bytes()
    say(f"[serve] arch={cfg.name} device={engine.device} slots={args.batch} ctx={ctx} "
        f"requests={len(outputs)} policy={args.policy}")
    if engine.spmd is not None and engine.scheduler.routed_capacity is not None:
        say(f"[serve] shard-local routing: data_shards={engine.spmd.data_shards} "
            f"global kb={engine.scheduler.routed_capacity} (= d * round(ratio * B/d)); "
            f"model_shards={engine.spmd.model_shards}")
    say(f"[serve] {s['steps']:.0f} engine steps in {s['wall_s']:.2f}s: "
          f"{s['tokens_per_s']:.1f} tok/s aggregate, mean occupancy "
          f"{s['mean_occupancy']:.2f}/{args.batch}; prefill {s['prefill_s']:.2f}s over "
          f"{s['prefills']:.0f} prompts, decode {s['decode_s']:.2f}s over "
          f"{s['decode_steps']:.0f} steps")
    say(f"[serve] prompt ingestion: " + (
        "batched prefill (model_prefill)" if engine.prefill_mode == "batch"
        else f"stepped, one prompt token per decode step ({cfg.family} family)"))
    say(f"[serve] latency (steps): p50={np.percentile(lat, 50):.0f} "
          f"p95={np.percentile(lat, 95):.0f}")
    if np.isfinite(s["mean_routed_frac"]):
        say(f"[serve] MoD decode routed fraction: {s['mean_routed_frac']:.3f} "
              f"(capacity_ratio={cfg.mod.capacity_ratio}); KV pool "
              f"{kv['total'] / 2**20:.1f} MiB (mod/full cache ratio "
              f"{kv['mod_vs_full_ratio']:.2f})")
    if args.page_size:
        say(f"[serve] paged pool: page_size={args.page_size} pages={s['n_pages']:.0f} "
              f"peak_utilization={s['page_utilization_peak']:.2f} "
              f"prefix_hit_rate={s['prefix_hit_rate']:.2f} preemptions={s['preemptions']:.0f} "
              f"prefill_tokens_computed={s['prefill_tokens_computed']:.0f}")
    if engine.quant is not None:
        wide = engine.pool.unquantized_kv_bytes()
        say(f"[serve] quantized KV: {engine.quant.kv}/{engine.quant.granularity} scales, "
              f"kv {s['kv_bytes'] / 2**20:.2f} MiB, {wide / s['kv_bytes']:.3f}x less than the "
              f"unquantized pool of the same shape ({wide / 2**20:.2f} MiB)")
    if args.speculate:
        say(f"[serve] speculative: speculate={args.speculate} draft_ratio={args.draft_ratio} "
              f"rounds={s['speculative_rounds']:.0f} "
              f"accept_rate={s['speculative_accept_rate']:.3f} "
              f"tokens_per_round={s['speculative_tokens_per_round']:.2f}")
    if args.ragged:
        say(f"[serve] ragged mixed step: segments={args.ragged_segments} "
              f"padded_token_fraction={s['padded_token_fraction']:.3f}")
    if args.deadline or args.adaptive_capacity or injector is not None:
        ok = sum(1 for o in outputs if o.ok)
        say(f"[serve] lifecycle: ok={ok}/{len(outputs)} shed={s['shed']:.0f} "
              f"expired={s['expired']:.0f} cancelled={s['cancelled']:.0f} "
              f"failed={s['failed']:.0f}")
    if args.adaptive_capacity:
        say(f"[serve] capacity controller: level_max={s.get('capacity_level_max', 0.0):.0f} "
              f"level_changes={s.get('capacity_level_changes', 0.0):.0f} "
              f"degraded_decode_steps={s.get('degraded_decode_steps', 0.0):.0f}")
    if injector is not None:
        fired = ", ".join(f"{f['kind']}@{f['step']}" for f in injector.fired)
        say(f"[serve] faults fired: {fired or 'none'}")
    say(f"[serve] kernel launches: {build.launch_counts()} (0 on the CPU: plain versions)")
    first = min(outputs, key=lambda o: o.uid)
    say(f"[serve] sample continuation: {first.tokens[-10:].tolist()}")
    if args.spmd:
        M.destroy_process_group()


if __name__ == "__main__":
    main()
