#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. Builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc`` and runs, in order (any
failure raises and exits non-zero):

1. the device line: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, kernel build time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the ``mod-paper-1b`` serving path gives it, with timings (CUDA
   events, median after warm-up) of the kernel, the plain version and one
   PyTorch library call as a yardstick (never called by the port);
3. the port against itself across devices: ``mod-paper-60m`` at full width
   and depth in f32, backend ``pallas``, the same weights on the CPU (plain
   versions) and on the card (kernels): a 256-token prefill and 16
   teacher-forced decode steps;
4. the main path: ``mod-paper-1b`` in bf16 through the port's
   ``ServingEngine`` (8 slots, 16 greedy requests, prompts of 128-1024
   tokens, 32 new tokens each), with every kernel's launch count read
   from this phase alone.

It prints a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line,
then as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints no result and exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA cores
SOURCES = {
    "gather_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                    "src/repro/kernels/routing.py:81"),
    "scatter_add_rows": ("src/repro_torch/kernels/csrc/routing.cu",
                         "src/repro/kernels/routing.py:118"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:146"),
}
# f32: the kernel's online softmax sums in another order than the plain
# version's dense softmax. bf16: both round p to bf16 before p@V, but
# against different running maxima, and round the output to bf16, so the
# two may differ by one bf16 ulp of the output (at most 2^-7 of its value,
# hence rtol 8e-3) plus the p rounding on small outputs (atol 8e-3, twice
# the largest difference seen on an H100, 2^-8)
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call between CUDA events recorded around it. For a
    short kernel this is the host's launch cost (the card waits for the
    host), so kernel times come from :func:`profile_call` instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_call(fn, iters: int = 10, warmup: int = 2):
    """(wall ms per call, device-busy ms per call, top kernels) from
    torch.profiler's CUDA activity (CUPTI): device time is the sum of the
    durations of every kernel and copy the calls ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    busy = sum(by_name.values())
    if busy <= 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, busy, top


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call (kernels and copies only, no host gaps)."""
    return profile_call(fn, iters)[1]


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_routing(cfg, dev, results):
    from repro_torch.kernels import routing

    g = torch.Generator(device=dev).manual_seed(0)
    D = cfg.d_model
    for S in (2048, 1000):
        k = cfg.mod.capacity(S)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, S, D, generator=g, device=dev).to(dtype)
            idx = torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values[None]
            delta = torch.randn(1, k, D, generator=g, device=dev).to(dtype)
            gate = torch.randn(1, k, generator=g, device=dev)
            es = x.element_size()
            out = routing.gather_rows(x, idx)
            want = routing.gather_rows_plain(x, idx)
            if not torch.equal(out, want):
                raise AssertionError(f"gather_rows differs from its plain version at S={S} {dtype}")
            out2 = routing.scatter_add_rows(x, idx, delta, gate)
            want2 = routing.scatter_add_rows_plain(x, idx, delta, gate)
            if not torch.equal(out2, want2):
                raise AssertionError(f"scatter_add_rows differs from its plain version at S={S} {dtype}")
            flat = (idx[0]).contiguous()
            upd = (gate[..., None] * delta.float()).to(dtype)[0]
            rows = {
                "gather_rows": dict(
                    call_ms=event_ms(lambda: routing.gather_rows(x, idx)),
                    ms=time_ms(lambda: routing.gather_rows(x, idx)),
                    plain_ms=time_ms(lambda: routing.gather_rows_plain(x, idx)),
                    library_ms=time_ms(lambda: torch.take_along_dim(x, idx[..., None], dim=1)),
                    bound=bound_ms(2 * k * D * es + 8 * k, 0, dtype),
                    max_abs_err=(out.float() - want.float()).abs().max().item(),
                ),
                "scatter_add_rows": dict(
                    call_ms=event_ms(lambda: routing.scatter_add_rows(x, idx, delta, gate)),
                    ms=time_ms(lambda: routing.scatter_add_rows(x, idx, delta, gate)),
                    plain_ms=time_ms(lambda: routing.scatter_add_rows_plain(x, idx, delta, gate)),
                    # index_add of the precomputed gated update (one call)
                    library_ms=time_ms(lambda: x[0].index_add(0, flat, upd)),
                    bound=bound_ms(2 * S * D * es + k * D * es + 12 * k, 2 * k * D, dtype),
                    max_abs_err=(out2.float() - want2.float()).abs().max().item(),
                ),
            }
            for name, r in rows.items():
                shape = f"B=1 S={S} D={D} k={k} {str(dtype)[6:]}"
                log(f"[kernels] {name:16s} {shape:32s} bitwise-equal ms={r['ms']:.4f} "
                    f"call_ms={r['call_ms']:.4f} "
                    f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                    f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
                results.setdefault(name, {})[(S, dtype)] = dict(r, shape=shape)


def _valid_pairs(q_pos, kv_pos):
    v = (kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    return int(v.sum().item())


def _flash_bytes(q, k, q_pos, kv_pos, es):
    """Bytes the function must move: q rows and k/v rows whose position is
    valid (a padded row cannot change a valid output), the whole output and
    both position arrays."""
    (B, Sq, nq, hd), nkv = q.shape, k.shape[2]
    n_q = int((q_pos >= 0).sum().item())
    n_kv = int((kv_pos >= 0).sum().item())
    return (n_q * nq * hd + 2 * n_kv * nkv * hd + B * Sq * nq * hd) * es \
        + 4 * (q_pos.numel() + kv_pos.numel())


def check_flash(cfg, dev, results):
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(1)
    nq, hd = cfg.attn.n_heads, cfg.head_dim
    cases = []
    for S in (2048, 1000):
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None].clone()
        pos[:, S - 24:] = -1  # padded tail
        cases.append((f"prefill S={S}", 1, S, S, nq, pos, pos))
    B, ctx = 8, 1056
    lens = torch.randint(128, ctx + 1, (B,), generator=g, device=dev)
    kv_pos = torch.arange(ctx, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    kv_pos = torch.where(kv_pos < lens[:, None], kv_pos, torch.full_like(kv_pos, -1))
    cases.append((f"decode B=8 ctx={ctx}", B, 1, ctx, nq, (lens - 1)[:, None].int(), kv_pos))
    pos = torch.arange(1000, dtype=torch.int32, device=dev)[None]
    cases.append(("gqa S=1000 nkv=2", 1, 1000, 1000, 2, pos, pos))
    for label, B, Sq, Skv, nkv, q_pos, kv_pos in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, nq, hd, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
            out = FA.flash_attention(q, k, v, q_pos, kv_pos)
            want = FA.flash_attention_plain(q, k, v, q_pos, kv_pos)
            torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
            err = (out.float() - want.float()).abs().max().item()
            mask = FA.valid_mask(q_pos, kv_pos, True, 0)[:, None]  # (B, 1, Sq, Skv)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            if nkv != nq:
                kh = kh.repeat_interleave(nq // nkv, dim=1)
                vh = vh.repeat_interleave(nq // nkv, dim=1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            es = q.element_size()
            nbytes = _flash_bytes(q, k, q_pos, kv_pos, es)
            flops = 4.0 * hd * nq * _valid_pairs(q_pos, kv_pos)
            r = dict(
                call_ms=event_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos)),
                ms=time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos)),
                plain_ms=time_ms(lambda: FA.flash_attention_plain(q, k, v, q_pos, kv_pos), iters=5),
                library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)),
                bound=bound_ms(nbytes, flops, dtype),
                max_abs_err=err,
                shape=f"{label} {nq}x{hd} {str(dtype)[6:]}",
            )
            log(f"[kernels] flash_attention  {r['shape']:32s} max_abs_err={err:.3g} "
                f"ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})")
            results.setdefault("flash_attention", {})[(label, dtype)] = r


# ---------------------------------------------------------------------------
# Phase 3: the port on the CPU against the port on the card
# ---------------------------------------------------------------------------


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def cross_device_parity(dev):
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api

    cfg = with_mod_backend(dataclasses.replace(get_config("mod-paper-60m"), dtype="float32"),
                           "pallas")
    cpu = torch.device("cpu")
    p_cpu = api.init_model(cfg, device=cpu, seed=3)
    p_gpu = _to(p_cpu, dev)
    B, S, steps = 4, 256, 16
    ctx = S + steps
    toks = torch.as_tensor(SyntheticLM(cfg.vocab, S, seed=11).batch(0, B)["tokens"]).long()
    lc, cc = api.model_prefill(p_cpu, cfg, {"tokens": toks}, ctx)
    lg, cg = api.model_prefill(p_gpu, cfg, {"tokens": toks.to(dev)}, ctx)

    def compare(tag, a, b):
        a, b = a.float(), b.float().cpu()
        diff = (a - b).abs().max().item()
        lim = 1e-3 * a.abs().max().item()
        log(f"[parity] {tag}: max|dlogit|={diff:.3g} (limit {lim:.3g})")
        if not diff <= lim:
            raise AssertionError(f"{tag}: logits differ by {diff} > {lim}")

    def rings(tag, c1, c2):
        for gi, (g1, g2) in enumerate(zip(c1["groups"], c2["groups"])):
            if not torch.equal(g1["mod"]["pos"], g2["mod"]["pos"].cpu()):
                raise AssertionError(f"{tag}: routed tokens of MoD group {gi} differ")
        log(f"[parity] {tag}: routed tokens identical in all {len(c1['groups'])} MoD rings")

    compare("prefill", lc, lg)
    rings("prefill", cc, cg)
    tok = lc[:, -1].argmax(-1)[:, None]
    active = torch.ones(B, dtype=torch.bool)
    for step in range(steps):
        pos = torch.full((B,), S + step, dtype=torch.int32)
        lc, cc, ac = api.model_decode(p_cpu, cc, cfg, tok, pos, active)
        lg, cg, ag = api.model_decode(p_gpu, cg, cfg, tok.to(dev), pos.to(dev), active.to(dev))
        mc, mg = ac["mod/decode_routed"], ag["mod/decode_routed"].cpu()
        log(f"[parity] decode step {step:2d}: max|dlogit|={(lc - lg.cpu()).abs().max().item():.3g} "
            f"routed cpu={mc.tolist()} gpu={mg.tolist()}")
        if not torch.equal(mc, mg):
            gap = (ac["mod/decode_scores"] - ag["mod/decode_scores"].cpu()).abs().max().item()
            log(f"[parity] routed masks differ; scores cpu={ac['mod/decode_scores'].tolist()} "
                f"gpu={ag['mod/decode_scores'].tolist()} max gap {gap:.3g}")
            raise AssertionError(f"decode step {step}: routed masks differ")
        compare(f"decode step {step}", lc, lg)
        tok = lc.argmax(-1)[:, None]  # the CPU run's tokens feed both
    rings("after decode", cc, cg)


# ---------------------------------------------------------------------------
# Phase 4: the main path — mod-paper-1b serving at full width
# ---------------------------------------------------------------------------


def serve_1b(dev):
    from repro_torch.config import get_config, with_mod_backend
    from repro_torch.core.routing import batch_capacity_k
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = with_mod_backend(get_config("mod-paper-1b"), "pallas")
    t0 = time.perf_counter()
    params = api.init_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_params() / 1e9:.2f}B params in {cfg.dtype}, "
        f"init {time.perf_counter() - t0:.1f}s")
    B, n_req, gen, lo, hi = 8, 16, 32, 128, 1024
    ecfg = EngineConfig(batch_size=B, ctx=hi + gen)
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n_req)
    prompts = SyntheticLM(cfg.vocab, hi, seed=7).batch(0, n_req)["tokens"]
    # warm-up (cuBLAS handles, allocator) on a separate engine, off the count
    ServingEngine(params, cfg, ecfg, device=dev).run_stream(
        [Request(tokens=prompts[i, :lo], max_new_tokens=2) for i in range(2)], 0)
    engine = ServingEngine(params, cfg, ecfg, device=dev)
    reqs = [Request(tokens=prompts[i, : lens[i]], max_new_tokens=gen) for i in range(n_req)]
    build.reset_counters()
    torch.cuda.synchronize()
    outs = engine.run_stream(reqs, 0)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    s = engine.stats()
    if len(outs) != n_req:
        raise AssertionError(f"{len(outs)} of {n_req} requests finished")
    for o in outs:
        if not o.ok or len(o.tokens) != gen:
            raise AssertionError(f"request {o.uid}: {o.finish_reason} {o.error} {len(o.tokens)} tokens")
    kb = batch_capacity_k(cfg, B)
    if abs(s["mean_routed_frac"] - kb / B) > 1e-9:
        raise AssertionError(f"decode routed fraction {s['mean_routed_frac']} != kb/B = {kb / B}")
    for name in SOURCES:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"[serve] {n_req} requests (prompts {lens.min()}-{lens.max()} tokens, {gen} new each), "
        f"{B} slots: {s['generated_tokens']:.0f} tokens in {s['wall_s']:.2f}s = "
        f"{s['tokens_per_s']:.1f} tok/s; prefill {1e3 * s['prefill_s'] / s['prefills']:.1f} ms "
        f"per prompt ({s['prefills']:.0f}), decode {1e3 * s['decode_s'] / s['decode_steps']:.2f} ms "
        f"per step ({s['decode_steps']:.0f} steps); routed fraction {s['mean_routed_frac']:.4f} "
        f"= kb/B = {kb}/{B}; all logits finite")
    # where the time goes: one decode step (8 live rows at position 1000)
    # and one 1000-token prefill, profiled outside the counted run
    tok = torch.zeros(B, 1, dtype=torch.long, device=dev)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    prompt = torch.as_tensor(prompts[:1, :1000], device=dev).long()
    for label, fn in (
        ("decode step B=8", lambda: api.model_decode(params, engine.pool.caches, cfg, tok, pos, act)),
        ("prefill S=1000", lambda: api.model_prefill(params, cfg, {"tokens": prompt}, hi + gen)),
    ):
        wall, busy, top = profile_call(fn, iters=5)
        log(f"[profile] {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.3f}; top kernels: "
            + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
    log(f"[serve] launches on the main path: {json.dumps(counts)} "
        f"(per prefill of one prompt: gather/scatter {cfg.n_layers // 2}, flash {cfg.n_layers}; "
        f"per decode step: flash {cfg.n_layers})")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; kernels built in {build_s:.1f}s "
        f"({', '.join(f'{k}: {Path(v['path']).name}' for k, v in libs.items())})")
    for stem, info in libs.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {stem}: {line.strip()}")

    cfg1b = get_config("mod-paper-1b")
    results: dict = {}
    check_routing(cfg1b, dev, results)
    check_flash(cfg1b, dev, results)
    cross_device_parity(dev)
    counts = serve_1b(dev)

    picks = {  # the entry of each kernel at a main-path shape (bf16, prompt of 1000)
        "gather_rows": results["gather_rows"][(1000, torch.bfloat16)],
        "scatter_add_rows": results["scatter_add_rows"][(1000, torch.bfloat16)],
        "flash_attention": results["flash_attention"][("prefill S=1000", torch.bfloat16)],
    }
    kernels = []
    for name, r in picks.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
