#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package. Builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc`` and runs, in order (any
failure raises and exits non-zero):

1. the device line: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, kernel build time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the ``mod-paper-1b`` serving and training paths give it, with
   timings (device time from torch.profiler) of the kernel, the plain
   version and, where one exists, one PyTorch library call as a yardstick
   (never called by the port); then the gradients of all five kernel
   wrappers (their ``autograd.Function``) against autograd through the
   plain versions;
3. the port against itself across devices, ``mod-paper-60m`` at full width
   and depth in f32, the same weights on the CPU (plain versions) and on
   the card (kernels): with backend ``pallas`` a 256-token prefill and 16
   teacher-forced decode steps; with backend ``pallas_fused`` one train
   step (B=2, S=256): loss, gradient norm, post-AdamW parameters and the
   routed masks of every MoD layer;
4. the serving path: ``mod-paper-1b`` in bf16 through the port's
   ``ServingEngine`` (8 slots, 16 greedy requests, prompts of 128-1024
   tokens, 32 new tokens each), with every kernel's launch count read
   from this phase alone;
5. the training path: ``mod-paper-1b`` in bf16, backend ``pallas_fused``,
   B=4 at S=2048, 5 steps through the port's ``Trainer``: per-step loss,
   wall time, device-busy time and idle share, and every kernel's launch
   count read from this phase alone.

It prints a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line,
then as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
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
    "routed_attention": ("src/repro_torch/kernels/csrc/routed_attention.cu",
                         "src/repro/kernels/flash_attention.py:348"),
    "routed_mlp_scatter": ("src/repro_torch/kernels/csrc/routed_mlp.cu",
                           "src/repro/kernels/swiglu.py:195"),
}
SERVE_KERNELS = ("gather_rows", "scatter_add_rows", "flash_attention")
TRAIN_KERNELS = ("routed_attention", "routed_mlp_scatter", "flash_attention")
# f32: the kernel's online softmax sums in another order than the plain
# version's dense softmax. bf16: both round p to bf16 before p@V, but
# against different running maxima, and round the output to bf16, so the
# two may differ by one bf16 ulp of the output (at most 2^-7 of its value,
# hence rtol 8e-3) plus the p rounding on small outputs (atol 8e-3, twice
# the largest difference seen on an H100, 2^-8)
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}
# the fused routed kernels round where their plain versions round but sum
# their products in another order than cuBLAS: f32 within 1e-4; in bf16 a
# sum on the other side of a rounding boundary moves a value by one bf16
# ulp (2^-8 relative), which the following products carry
ROUTED_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
              torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


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


def _w(g, dev, dtype, *shape):
    return (torch.randn(*shape, generator=g, device=dev) / shape[0] ** 0.5).to(dtype)


def _causal_pairs(pos):
    """(query, key) pairs of the routed rows that the causal make_mask keeps."""
    return int(((pos[:, None, :] >= 0) & (pos[:, None, :] <= pos[:, :, None])).sum().item())


def check_fused(cfg, dev, results):
    """routed_attention and routed_mlp_scatter at the mod-paper-1b training
    shape: B=4, S=2048, k = capacity(2048) = 256 routed rows per sequence."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import swiglu as SW

    g = torch.Generator(device=dev).manual_seed(2)
    B, S, D, F = 4, 2048, cfg.d_model, cfg.d_ff
    k = cfg.mod.capacity(S)
    nq, nkv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.head_dim
    spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, cfg.attn.rope_theta, "rope",
                             cfg.norm_eps)
    mspec = SW.RoutedMlpSpec(cfg.act, cfg.norm_eps)
    for dtype in (torch.bfloat16, torch.float32):
        es = 2 if dtype == torch.bfloat16 else 4
        x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
        idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                           for _ in range(B)])
        pos = idx.to(torch.int32)
        ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
              "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
        a, h = FA.routed_attention(x, idx, pos, ap, spec)
        wa, wh = FA.routed_attention_plain(x, idx, pos, ap, spec)
        for got, want in ((a, wa), (h, wh)):
            torch.testing.assert_close(got.float(), want.float(), **ROUTED_TOL[dtype])
        err_a = max((a.float() - wa.float()).abs().max().item(),
                    (h.float() - wh.float()).abs().max().item())
        M = B * k
        attn_flops = 2.0 * M * D * (nq + 2 * nkv) * hd + 2.0 * M * nq * hd * D \
            + 4.0 * hd * nq * _causal_pairs(pos)
        attn_bytes = (M * D + 2 * M * D + (2 * nq + 2 * nkv) * hd * D + D) * es + 12 * M
        mp = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D)}
        if cfg.glu:
            mp["w_gate"] = _w(g, dev, dtype, D, F)
        gate = torch.randn(B, k, generator=g, device=dev)
        out = SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec)
        want = SW.routed_mlp_scatter_plain(x, h, a, idx, gate, mp, mspec)
        torch.testing.assert_close(out.float(), want.float(), **ROUTED_TOL[dtype])
        err_m = (out.float() - want.float()).abs().max().item()
        n_w = 3 if cfg.glu else 2
        mlp_flops = 2.0 * M * D * F * n_w
        mlp_bytes = (2 * B * S * D + 2 * M * D + n_w * D * F + D) * es + 12 * M
        shape = f"B={B} S={S} k={k} D={D} {str(dtype)[6:]}"
        rows = {
            "routed_attention": dict(
                ms=time_ms(lambda: FA.routed_attention(x, idx, pos, ap, spec), iters=5),
                plain_ms=time_ms(lambda: FA.routed_attention_plain(x, idx, pos, ap, spec),
                                 iters=5),
                library_ms=None, bound=bound_ms(attn_bytes, attn_flops, dtype),
                max_abs_err=err_a, shape=f"{shape} {nq}x{hd}"),
            "routed_mlp_scatter": dict(
                ms=time_ms(lambda: SW.routed_mlp_scatter(x, h, a, idx, gate, mp, mspec), iters=5),
                plain_ms=time_ms(lambda: SW.routed_mlp_scatter_plain(x, h, a, idx, gate, mp, mspec),
                                 iters=5),
                library_ms=None, bound=bound_ms(mlp_bytes, mlp_flops, dtype),
                max_abs_err=err_m, shape=f"{shape} F={F}"),
        }
        for name, r in rows.items():
            r["tflops"] = (attn_flops if name == "routed_attention" else mlp_flops) / r["ms"] / 1e9
            log(f"[kernels] {name:18s} {r['shape']:44s} max_abs_err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
                f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) achieved {r['tflops']:.2f} TFLOP/s")
            results.setdefault(name, {})[dtype] = r


def _grads(fn, inputs, seed):
    """Gradients, by autograd, of a loss linear in fn's outputs (fixed random
    weights, so the cotangents do not depend on the forward values)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    loss.backward()
    for t in leaves:
        if t.grad is None:
            raise AssertionError("a kernel wrapper returned no gradient")
    return [t.grad for t in leaves]


def check_grads(cfg, dev):
    """Autograd through each kernel's autograd.Function (kernel forward)
    against autograd through its plain version, bf16 and f32. Tolerances:
    gather/scatter backwards are the same two copy/update kernels (exact;
    dgate sums in another order, 1e-5); the fused kernels' backwards
    recompute the plain version (equal up to cuBLAS's own order, 1e-5);
    the flash backward (torch ops from the kernel's lse) against the
    dense plain version's autograd: f32 1e-4, bf16 3e-2 (the plain
    version's autograd rounds at its bf16 casts)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import routing as KR
    from repro_torch.kernels import swiglu as SW

    g = torch.Generator(device=dev).manual_seed(4)
    B, S, D, nq, hd, F = 2, 512, 512, 4, 128, 1024
    k = 64
    for dtype in (torch.bfloat16, torch.float32):
        loose = 1e-4 if dtype == torch.float32 else 3e-2
        x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
        idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                           for _ in range(B)])
        pos = idx.to(torch.int32)
        delta = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
        gate = torch.randn(B, k, generator=g, device=dev)
        q, kk, vv = (torch.randn(B, S, nq, hd, generator=g, device=dev).to(dtype)
                     for _ in range(3))
        spos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        ap = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nq * hd),
              "wv": _w(g, dev, dtype, D, nq * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
        spec = FA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
        mp = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
              "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D),
              "w_gate": _w(g, dev, dtype, D, F)}
        mspec = SW.RoutedMlpSpec("silu", 1e-5)
        ak, mk = list(ap), list(mp)
        cases = {
            "gather_rows": (lambda x_: KR.gather_rows(x_, idx),
                            lambda x_: KR.gather_rows_plain(x_, idx), [x], 1e-5),
            "scatter_add_rows": (lambda *t: KR.scatter_add_rows(t[0], idx, t[1], t[2]),
                                 lambda *t: KR.scatter_add_rows_plain(t[0], idx, t[1], t[2]),
                                 [x, delta, gate], 1e-5),
            "flash_attention": (lambda *t: FA.flash_attention(*t, spos, spos),
                                lambda *t: FA.flash_attention_plain(*t, spos, spos),
                                [q, kk, vv], loose),
            "routed_attention": (
                lambda x_, *ps: FA.routed_attention(x_, idx, pos, dict(zip(ak, ps)), spec),
                lambda x_, *ps: FA.routed_attention_plain(x_, idx, pos, dict(zip(ak, ps)), spec),
                [x, *ap.values()], 1e-5),
            "routed_mlp_scatter": (
                lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter(
                    x_, h_, a_, idx, g_, dict(zip(mk, ps)), mspec),
                lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter_plain(
                    x_, h_, a_, idx, g_, dict(zip(mk, ps)), mspec),
                [x, delta, delta, gate, *mp.values()], 1e-5),
        }
        for name, (fn, plain, inputs, tol) in cases.items():
            build.reset_counters()
            got = _grads(fn, inputs, 5)
            launched = build.launch_counts()[name]
            want = _grads(plain, inputs, 5)
            errs = []
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
                errs.append((a.float() - b.float()).abs().max().item())
            if launched < 1:
                raise AssertionError(f"{name}: the gradient check launched no kernel")
            log(f"[grads] {name:18s} {str(dtype)[6:]:9s} {len(got)} input gradients, max |diff| "
                f"{max(errs):.3g} (tolerance {tol:g}), {launched} launches")


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


@contextlib.contextmanager
def recorded_masks():
    """Record the routed mask of every token_topk decision made inside."""
    from repro_torch.core import routing as ROUT

    real, masks = ROUT.decide_tokens, []

    def record(*args, **kwargs):
        decision = real(*args, **kwargs)
        masks.append(decision.mask.detach().cpu())
        return decision

    ROUT.decide_tokens = record
    try:
        yield masks
    finally:
        ROUT.decide_tokens = real


def train_step_parity(dev):
    """One train step of mod-paper-60m (f32, pallas_fused, B=2, S=256) on the
    CPU and on the card from the same state. The state starts at step 1 so
    the warmup leaves a nonzero learning rate. Limits: loss within 1e-5 and
    gradient norm within 1e-4 relative (f32 sums in another order);
    routed masks equal. AdamW's first step moves each weight by about
    lr·sign(g), so a weight whose gradient is within the f32 noise of 0 may
    move differently: at most 1e-4 of all weights may differ by more than
    lr/100."""
    from repro_torch.config import OptimConfig, TrainConfig, get_config, with_mod_backend
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import api
    from repro_torch.train.loop import make_train_state, make_train_step
    from repro_torch.utils import tree_leaves, tree_map

    cfg = with_mod_backend(dataclasses.replace(get_config("mod-paper-60m"), dtype="float32"),
                           "pallas_fused")
    lr = 1e-3
    tcfg = TrainConfig(global_batch=2, seq_len=256,
                       optim=OptimConfig(lr=lr, warmup_steps=1, total_steps=10))
    p_cpu = api.init_model(cfg, device="cpu", seed=5)
    p_gpu = tree_map(lambda t: t.detach().to(dev, copy=True), p_cpu)
    batch = {k: torch.as_tensor(v).long()
             for k, v in SyntheticLM(cfg.vocab, 256, seed=13).batch(0, 2).items()}
    step_fn = make_train_step(cfg, tcfg)
    out = {}
    for name, params, d in (("cpu", p_cpu, torch.device("cpu")), ("gpu", p_gpu, dev)):
        state = make_train_state(cfg, d, params=params)
        state["step"] = torch.ones((), dtype=torch.int32)
        with recorded_masks() as masks:
            state, metrics = step_fn(state, {k: v.to(d) for k, v in batch.items()})
        out[name] = (state, {k: float(v) for k, v in metrics.items()}, masks)
    (s_c, m_c, mask_c), (s_g, m_g, mask_g) = out["cpu"], out["gpu"]
    dl = abs(m_c["loss"] - m_g["loss"]) / abs(m_c["loss"])
    dn = abs(m_c["grad_norm"] - m_g["grad_norm"]) / m_c["grad_norm"]
    log(f"[parity] train step: loss cpu={m_c['loss']:.7f} gpu={m_g['loss']:.7f} (rel {dl:.3g}); "
        f"grad norm cpu={m_c['grad_norm']:.6f} gpu={m_g['grad_norm']:.6f} (rel {dn:.3g}); "
        f"lr {m_c['lr']:.3g}")
    if not (dl <= 1e-5 and dn <= 1e-4):
        raise AssertionError("train step: loss or gradient norm differ beyond the limits")
    if len(mask_c) != len(mask_g) or not mask_c:
        raise AssertionError("train step: different numbers of routing decisions")
    for i, (a, b) in enumerate(zip(mask_c, mask_g)):
        if not torch.equal(a, b):
            raise AssertionError(f"train step: routed mask of MoD layer {i} differs")
    n_total = n_far = 0
    worst = 0.0
    for a, b in zip(tree_leaves(s_c["params"]), tree_leaves(s_g["params"])):
        d = (a.detach() - b.detach().cpu()).abs()
        n_total += d.numel()
        n_far += int((d > lr / 100).sum())
        worst = max(worst, d.max().item())
    log(f"[parity] train step: routed masks identical in all {len(mask_c)} MoD layers; "
        f"post-AdamW weights: max |diff| {worst:.3g} = {worst / lr:.3g} lr, "
        f"{n_far} of {n_total} differ by more than lr/100")
    if n_far > 1e-4 * n_total:
        raise AssertionError("train step: post-AdamW weights differ beyond the limit")


# ---------------------------------------------------------------------------
# Phase 4: the serving path — mod-paper-1b at full width
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
    for name in SERVE_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
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


# ---------------------------------------------------------------------------
# Phase 5: the training path — mod-paper-1b at full width and depth
# ---------------------------------------------------------------------------


def _kernel_group(name: str) -> str:
    """The port kernel a CUDA kernel name belongs to (the fused kernels are
    several __global__ functions each), else the kind of library kernel."""
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(t in name for t in ("routed_attn_kernel", "rope_kernel", "EpiStore", "EpiResid")):
        return "routed_attention"
    if any(t in name for t in ("EpiGlu", "EpiAct", "EpiScatter")):
        return "routed_mlp_scatter"
    if "rmsnorm_rows" in name:
        return "routed_* rmsnorm"
    if "gather_rows" in name or "scatter_update" in name or "copy_bytes" in name:
        return "gather/scatter"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "Kernel2")):
        return "library GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    return "other PyTorch kernels"


def train_1b(dev):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import OptimConfig, TrainConfig, get_config, with_mod_backend
    from repro_torch.data.loader import SyntheticLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.train import Trainer

    cfg = with_mod_backend(get_config("mod-paper-1b"), "pallas_fused")
    B, S, steps = 4, 2048, 5
    tcfg = TrainConfig(global_batch=B, seq_len=S,
                       optim=OptimConfig(lr=1e-4, warmup_steps=2, total_steps=steps),
                       log_every=1, ckpt_every=10**9)
    loader = SyntheticLoader(SyntheticLM(cfg.vocab, S, seed=0), B, dev)
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, tcfg, loader, ckpt=CheckpointManager(ckdir), device=dev,
                          log_fn=lambda m: None)
        t0 = time.perf_counter()
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {cfg.n_params() / 1e9:.2f}B params in {cfg.dtype}, backend "
            f"{cfg.mod.backend}, B={B} S={S} (k={cfg.mod.capacity(S)} routed rows per sequence), "
            f"init {time.perf_counter() - t0:.1f}s")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        losses = []
        for i in range(steps):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, m = trainer.run(state, 1)
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            busy = sum(by_name.values())
            wall = 1e3 * trainer.heartbeats[-1][1]
            groups: dict = {}
            for n, t in by_name.items():
                groups[_kernel_group(n)] = groups.get(_kernel_group(n), 0.0) + t
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            losses.append(m["loss"])
            log(f"[train] step {i + 1}: loss {m['loss']:.4f} ce {m['ce']:.4f} grad norm "
                f"{m['grad_norm']:.3f} lr {m['lr']:.3g}; wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")
            log("[train]   device ms by group: " + "; ".join(
                f"{g} {t:.1f}" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
            log("[train]   top kernels: " + "; ".join(f"{n[:60]} {t:.1f} ms" for n, t in top))
        counts = build.launch_counts()
    log(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    per_step = {name: counts[name] / steps for name in counts}
    log(f"[train] launches in {steps} steps: {json.dumps(counts)} (per step: routed_attention "
        f"{per_step['routed_attention']:g}, routed_mlp_scatter {per_step['routed_mlp_scatter']:g}, "
        f"flash_attention {per_step['flash_attention']:g}; {cfg.n_layers // 2} of each per forward)")
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    for name in ("gather_rows", "scatter_add_rows"):
        if counts.get(name, 0) != 0:
            raise AssertionError(f"{name} ran under pallas_fused: the fused kernels were bypassed")
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
    check_fused(cfg1b, dev, results)
    check_grads(cfg1b, dev)
    cross_device_parity(dev)
    train_step_parity(dev)
    serve_counts = serve_1b(dev)
    train_counts = train_1b(dev)

    picks = {  # the entry of each kernel at a main-path shape (bf16)
        "gather_rows": results["gather_rows"][(1000, torch.bfloat16)],
        "scatter_add_rows": results["scatter_add_rows"][(1000, torch.bfloat16)],
        "flash_attention": results["flash_attention"][("prefill S=1000", torch.bfloat16)],
        "routed_attention": results["routed_attention"][torch.bfloat16],
        "routed_mlp_scatter": results["routed_mlp_scatter"][torch.bfloat16],
    }
    kernels = []
    for name, r in picks.items():
        src, replaces = SOURCES[name]
        # launches from the path the kernel's timed shape belongs to: the
        # serving run for gather/scatter/flash, the training run for the
        # fused kernels; both runs' counts ride along
        path_counts = train_counts if name in ("routed_attention", "routed_mlp_scatter") \
            else serve_counts
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "launches_by_path": {"serve": serve_counts.get(name, 0),
                                 "train": train_counts.get(name, 0)},
        })
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
