"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch (the repository's ``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: gather/scatter are copies and exact updates, so bitwise; the
flash kernel sums its online softmax in another order than the dense plain
version (f32 atol 2e-5), and rounds p to bf16 against another running max
before p@V (bf16 atol and rtol 8e-3: one bf16 ulp of the output is at most
2^-7 of its value). That holds on every bf16 path (wgmma tiles at head
dims 64 and 128, whose two warpgroups' even and odd key tiles merge in
f32; mma.sync tiles at 32, 80 and 256; split-KV decode, four warps a chunk,
one launch in one chunk, partials merged in f32 past it), on wrapped
rings and rows with no valid key; a row's bf16 bits do not depend on
empty slots appended to K/V or on the batch around it; its f32 lse is
the plain version's within 1e-4 (exact bf16 products summed in f32 in
other orders); a one-chunk decode call equals, bit for bit, the same
chunk through the merge launch. The ragged write-back runs one flat grid
of 16-, 4- or 1-byte vectors (``ragged.scatter_plan``) and is bitwise at
each width, touching only its target rows. The fused routed kernels (routed_attention,
routed_mlp_scatter) round where their plain versions round, but sum their
products in another order than cuBLAS: f32 within 1e-4 (atol and rtol);
in bf16 a sum that lands on the other side of a rounding boundary moves a
value by one bf16 ulp (2^-8 relative) and the following products carry it,
hence ROUTED_TOL. routed_attention runs its bf16 projections on the wgmma
GEMM where D is a multiple of 8 (``routed_attention_path``, recorded by
call) and its bf16 attention core on tensor cores (three passes over the
key tiles for the dense softmax's values, tiles skipped by position): the
same tolerance holds at the GEMM's tile edges (M = B·k of 1 to 1000, D and
nq·hd multiples of 8 but not of 64), with windows over several key tiles
and a query row with no valid key (the mean of V); two calls and a
CUDA-graph replay give the eager call's bits.

Gradients: every wrapper is a ``torch.autograd.Function``; autograd
through it must match autograd through the plain version. Routed
attention / MLP recompute the plain version in their backward, so with a
loss linear in the outputs the two agree to the bit up to cuBLAS's own
order; gather/scatter backwards are the same two kernels (exact); the
flash backward is the blocked torch-op backward from the kernel's lse,
against autograd through the dense plain version (f32 1e-4; bf16: the
plain version's autograd rounds at its bf16 casts, the Function does not).

Self-speculative serving: rounds give the non-speculative engine's greedy
streams on the card (paged, int8/page prefix, ragged), and truncation
keeps the pool's books and pages consistent.

Ragged paged flash attention: the kernel sums its online softmax per key
tile, merges warps' and key chunks' states, the plain version takes one
dense softmax, and in bf16 they round p against different maxima (on
int8/e4m3 pages p' = p * vs is kept to ~16 bits as two bf16 terms):
flash's TOL on every path and head dim, at keys past bit 31 and 63 of a
chunk, at page sizes 8, 16 and 32. A context split over chunks (the merge
launch) gives the one-chunk call's bits, two calls and a CUDA-graph replay
give the same bits. Its edge cases are ``chip_smoke.py``'s phase 10(d),
imported from there so that each case is kept in one place. SwiGLU: the kernel (tensor cores for bf16, CUDA cores for f32) and
the plain version (cuBLAS in f32) sum in their own order; in bf16 a sum
on the other side of a rounding boundary moves an element of h by one ulp
and y rounds once, so they agree within 2^-7 of max|y| (f32: 2e-5 of it).

Both MLP kernels run their bf16 products on the wgmma GEMM where D and F
are multiples of 8 and the bases aligned (``swiglu.gemm_path``; the launch
counters record the path by call): the same tolerances hold there, at tile
edges too, and the K order is fixed, so two calls and a CUDA-graph replay
give the eager call's bits.

Overload control and faults (phase 13a of ``chip_smoke.py``, imported
from there): mod-paper-60m in f32 with the same weights on the CPU and the
card, the adaptive paged + prefix engine's lifecycle run and the seeded
fault matrix on the paged, ragged and speculative engines (and on
mod-paper-60m-vanilla) give equal levels, streams, finish reasons, fired
logs and counters on both devices: exact, greedy streams.

Partitioned routing (phase 16 of ``chip_smoke.py``): ``batch_select``
per slot group on the card equals the CPU's, and the contiguous engine
over a one-rank NCCL mesh serves the unsharded engine's streams and
decode logits bit for bit.

MoE (torch ops, no kernel of its own): ``moe_mlp`` on the card picks the
CPU's experts, slots and kept set, with f32 outputs within 1e-5 (cuBLAS
sums the expert products in another order) and equal dropped and no-op
fractions; its combine gathers each token's slots and sums them in
ascending expert order, so two calls give the same bits; a staged-MoDE
``pallas_fused`` forward launches routed_attention and the
scatter_add_rows combine once per routed layer, and no gather.

SSD intra-chunk: both sides compute in f32 from the same (widened)
inputs (the tensor-core path splits each f32 operand into three bf16
terms, so its products are exact too); the kernel takes the cumsum of
loglam in its own order, torch's scan in another, and each decay
exp(l_i - l_j) carries that rounding (up to |l|·2^-24 relative), so the
outputs agree within 1e-5 of their largest value plus 2·max|l|·2^-24 on
either path; its backward is autograd through the plain version, so its
gradients equal the plain version's.

The mesh trainer (phase 17 of ``chip_smoke.py``): the autograd collectives
over a one-rank NCCL group pass values and gradients through unchanged;
the int8 compressed all-reduce of CUDA gradients is bitwise the same call
on CPU tensors (its quantization is exact per element); a train step on a
(1, 1) NCCL mesh has the single-process step's loss bit for bit and
launches the fused routed kernels under pure DP and the gather/scatter
kernels under FSDP.
"""
import contextlib
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    FAULT_ENGINES_60M, RAGGED_EDGE_MODES, adaptive_lifecycle, check_ragged_edge_case, fault_soak,
    flash_call, ragged_edge_case, ragged_plan)

from repro_torch import config as TC  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged as KP  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.kernels import routing as KR  # noqa: E402
from repro_torch.kernels import ssd as KSSD  # noqa: E402
from repro_torch.kernels import swiglu as SW  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}
ROUTED_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
              torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _offset(t, offset_bytes):
    """A contiguous copy of ``t`` whose base sits ``offset_bytes`` past an
    aligned allocation."""
    n = offset_bytes // t.element_size()
    buf = torch.empty(n + t.numel(), dtype=t.dtype, device=t.device)
    return buf[n:].view(t.shape).copy_(t)


def _dispatch_reference(x, idx, delta, gate):
    """Gather, scatter-add and gather's VJP per batch row through the ragged
    plain versions (a zero row for an index outside [0, S), dropped by the
    scatter), which the public plain versions cannot take."""
    rows = [(x[b], idx[b][None].int(), delta[b][None], gate[b][None])
            for b in range(x.shape[0])]
    gathered = torch.stack([KRG.ragged_gather_rows_plain(xb, ib)[0] for xb, ib, _, _ in rows])
    scattered = torch.stack([KRG.ragged_scatter_add_rows_plain(*r) for r in rows])
    vjp = torch.stack([KRG.ragged_scatter_add_rows_plain(torch.zeros_like(xb), ib, db,
                                                         torch.ones_like(gb))
                       for xb, ib, db, gb in rows])
    return gathered, scattered, vjp


# (B, S, D, k, base offset in bytes, index dtype, indices out of range)
ROUTING_CASES = [
    (1, 77, 96, 10, 0, torch.int64, False),
    (3, 2048, 1792, 256, 0, torch.int64, False),
    (4, 2048, 2048, 256, 0, torch.int64, False),  # mamba2-1.3b's training shape
    (2, 33, 5, 33, 0, torch.int64, False),  # k = S, odd rows
    (1, 1000, 1792, 1000, 0, torch.int64, False),  # capacity 1.0: k = S
    (3, 100, 96, 20, 2, torch.int64, False),  # bases 2 bytes off 16: 1-/2-byte vectors
    (3, 100, 96, 20, 4, torch.int64, False),  # 4 bytes off: 4-byte vectors
    (3, 100, 96, 20, 8, torch.int64, False),
    (4, 300, 64, 50, 0, torch.int64, True),  # B > 1, -1 and >= S selections
    (4, 300, 64, 50, 0, torch.int32, True),
    (2, 513, 1792, 64, 0, torch.int32, False),  # int32, as the flat stream
    (2, 37, 6, 37, 4, torch.int32, True),  # k = S, narrow rows, 4 bytes off
    (2, 50, 8192, 7, 0, torch.int64, True),  # the gather's rows in 2 or 4 chunks
    (8, 448, 384, 128, 0, torch.int64, False),  # whisper-tiny's decoder (768-byte bf16 rows)
]


@pytest.mark.parametrize("dtype,case", [
    (dt, c) for c in ROUTING_CASES for dt in DTYPES
    if c[4] % torch.empty(0, dtype=dt).element_size() == 0])
def test_routing_kernels_bitwise(dev, dtype, case):
    """Gather, scatter-add and gather's VJP (the zero target) at every
    vector width, with int64 and int32 indices, k = S and indices out of
    range, bitwise against their plain versions; each call one launch, on
    the plan dispatch_plan makes for its bases."""
    B, S, D, k, off, idx_dtype, oob = case
    g = torch.Generator(device=dev).manual_seed(0)
    x = _offset(torch.randn(B, S, D, generator=g, device=dev).to(dtype), off)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    if oob:
        idx[1:, ::7] = -1
        idx[1:, 3::11] = S + torch.arange(idx[1:, 3::11].shape[1], device=dev)
    idx = idx.to(idx_dtype)
    delta = _offset(torch.randn(B, k, D, generator=g, device=dev).to(dtype), off)
    gate = torch.randn(B, k, generator=g, device=dev)
    want_g, want_s, want_z = _dispatch_reference(x, idx, delta, gate)
    build.reset_counters()
    if idx_dtype == torch.int64 and not oob:
        assert torch.equal(KR.gather_rows_plain(x, idx), want_g)
        assert torch.equal(KR.scatter_add_rows_plain(x, idx, delta, gate), want_s)
        assert torch.equal(KR.gather_rows(x, idx), want_g)
        assert torch.equal(KR.scatter_add_rows(x, idx, delta, gate), want_s)
    else:
        assert torch.equal(KR.gather_launch(x, idx, KR.GATHER_ROWS), want_g)
        assert torch.equal(KR.scatter_launch(x, idx, delta, gate, KR.SCATTER_ADD_ROWS), want_s)
    assert torch.equal(KR.gather_rows_vjp(idx, delta, x.shape), want_z)
    torch.cuda.synchronize()
    es, ib = x.element_size(), idx.element_size()
    plans = [KR.dispatch_plan("gather", B, S, k, D * es, es, ib, (x.data_ptr(), 0)),
             KR.dispatch_plan("scatter", B, S, k, D * es, es, ib, (x.data_ptr(), delta.data_ptr())),
             KR.dispatch_plan("scatter_zero", B, S, k, D * es, es, ib, (delta.data_ptr(),))]
    if off % 16:
        assert plans[0].vec == (4 if off % 4 == 0 else 1)
        assert plans[1].vec == plans[2].vec == (4 if off % 4 == 0 else 2)
    assert KR.GATHER_ROWS.by_call == {(p.kind, p.vec, p.unroll, B, S, k, D * es): 1
                                      for p in plans[:1]}
    assert KR.SCATTER_ADD_ROWS.by_call == {(p.kind, p.vec, p.unroll, B, S, k, D * es): 1
                                           for p in plans[1:]}


def _flash_inputs(dev, dtype, B, Sq, Skv, nq, nkv, hd, layout, seed=1):
    """q/k/v and positions for one flash case. ``layout``:
    "tail": keys at positions 0.. with the last 3 slots empty (-1); queries
    at the last Sq positions (Sq == Skv: the keys' own positions);
    "ring": a ring of Skv slots after Skv + 37 writes, so kv_pos wraps and
    is not monotone in the slot index; queries at the newest positions;
    "late": keys start at position 5 and query row 0 sits at position 2, so
    it has no valid key under causality (its output is 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, nq, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    idx = torch.arange(Skv, dtype=torch.int32, device=dev)
    if layout == "ring":
        n = Skv + 37
        kv_pos = idx + Skv * ((n - 1 - idx) // Skv)
        q_pos = torch.arange(n - Sq, n, dtype=torch.int32, device=dev)
    elif layout == "late":
        kv_pos = idx + 5
        q_pos = torch.arange(Skv + 5 - Sq, Skv + 5, dtype=torch.int32, device=dev)
        q_pos[0] = 2
    else:
        kv_pos = idx.clone()
        kv_pos[-3:] = -1
        q_pos = kv_pos.clone() if Sq == Skv else torch.arange(
            Skv - 3 - Sq, Skv - 3, dtype=torch.int32, device=dev).clamp_min(0)
    return q, k, v, q_pos[None].repeat(B, 1), kv_pos[None].repeat(B, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Sq,Skv,nq,nkv,hd,causal,window",
    [
        (2, 45, 45, 4, 2, 64, True, 0),  # GQA, ragged edges
        (1, 300, 300, 14, 14, 128, True, 0),
        (8, 1, 1056, 14, 14, 128, True, 0),  # decode against a ring
        (2, 17, 70, 4, 4, 32, False, 0),
        (1, 64, 64, 2, 1, 256, True, 16),  # sliding window
        # the bf16 decode path (Sq * nq/nkv <= 16 rows) and the tile path
        # around it, at every head dim; Skv under one split chunk and over
        # many chunks; GQA with g = 2 and 7
        *[(2, Sq, Skv, 2, 2, hd, True, 0) for hd in (32, 64, 128, 256)
          for Sq in (1, 15, 16, 17, 65, 300) for Skv in (50, 1000)],
        (3, 1, 700, 8, 4, 128, True, 0),  # g = 2, decode
        (2, 8, 700, 8, 4, 64, True, 0),  # g = 2, 16 rows: decode
        (2, 9, 700, 8, 4, 64, True, 0),  # g = 2, 18 rows: tile
        (2, 2, 900, 14, 2, 128, True, 0),  # g = 7, 14 rows: decode
        (2, 3, 900, 14, 2, 128, True, 0),  # g = 7, 21 rows: tile
        (2, 1, 600, 4, 4, 128, True, 100),  # window, decode
        (2, 65, 600, 4, 4, 128, False, 0),  # non-causal, tile
        (2, 1, 600, 4, 4, 256, False, 0),  # non-causal, decode
        # head dim 80 (zamba2's shared block): mma.sync tiles, split-KV
        # decode over 9 chunks + the merge and in one chunk, a window
        (1, 1000, 1000, 32, 32, 80, True, 0),
        (8, 1, 1056, 32, 32, 80, True, 0),
        (8, 1, 100, 32, 32, 80, True, 0),
        (2, 65, 300, 4, 2, 80, True, 40),
        (2, 4, 300, 8, 2, 80, False, 0),  # 16 (position, head) rows: decode
        # the dense configs' decode shapes: granite-20b's MQA (48 rows of one
        # kv head: the wgmma tiles), qwen2's group of 7 (7 rows: decode) and
        # its 4-token speculative window (28 rows: wgmma)
        (8, 1, 1056, 48, 1, 128, True, 0),
        (8, 1, 1056, 28, 4, 128, True, 0),
        (2, 4, 1056, 28, 4, 128, True, 0),
        # whisper-tiny (6 heads of 64): the encoder's 1500 frames (wgmma),
        # cross-attention decode over 12 chunks + the merge, and the
        # decoder's 448 training positions over the frames (wgmma)
        (1, 1500, 1500, 6, 6, 64, False, 0),
        (8, 1, 1500, 6, 6, 64, False, 0),
        (2, 448, 1500, 6, 6, 64, False, 0),
    ],
)
def test_flash_attention_matches_plain(dev, dtype, B, Sq, Skv, nq, nkv, hd, causal, window):
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, dtype, B, Sq, Skv, nq, nkv, hd, "tail")
    if Sq != Skv:  # queries anywhere in the context
        g = torch.Generator(device=dev).manual_seed(2)
        q_pos = torch.randint(0, Skv, (B, Sq), generator=g, device=dev, dtype=torch.int32)
    build.reset_counters()
    got = FA.flash_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    plan = FA.flash_plan(B, Sq, Skv, nq, nkv, hd, dtype)
    assert FA.FLASH_ATTENTION.by_call == {(plan.path, B, Sq, Skv, nq, nkv, hd, plan.kernels): 1}
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,path,kernels", [(1, 1500, 1500, "wgmma", 1),
                                                   (8, 1, 1500, "decode", 2),
                                                   (2, 448, 1500, "wgmma", 1)])
def test_flash_attention_at_whisper_cross_attention(dev, dtype, B, Sq, Skv, path, kernels):
    """whisper-tiny's cross-attention calls as the model makes them: every
    position 0 (JAX's ``kv_pos=None``: all keys valid, a slot's unfilled
    cross-KV too), ``causal=False``; the decode call over 12 chunks of 128
    keys plus the merge launch."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, Sq, 6, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, 6, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, 6, 64, generator=g, device=dev).to(dtype)
    k[-1, Skv // 2:] = 0  # half a row of zero keys and values (an unfilled slot's)
    v[-1, Skv // 2:] = 0
    qp = torch.zeros((B, Sq), dtype=torch.int32, device=dev)
    kp = torch.zeros((B, Skv), dtype=torch.int32, device=dev)
    build.reset_counters()
    got = FA.flash_attention(q, k, v, qp, kp, causal=False)
    want = FA.flash_attention_plain(q, k, v, qp, kp, causal=False)
    torch.cuda.synchronize()
    plan = FA.flash_plan(B, Sq, Skv, 6, 6, 64, dtype)
    assert (plan.path, plan.kernels) == ((path, kernels) if dtype == torch.bfloat16
                                         else ("f32", 1))
    if plan.path == "decode":
        assert plan.n_splits == 12 and plan.merge
    assert FA.FLASH_ATTENTION.by_call == {(plan.path, B, Sq, Skv, 6, 6, 64, plan.kernels): 1}
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # the same as attending every key with no positions at all
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2).float() for t in (q, k, v))).transpose(1, 2)
    torch.testing.assert_close(got.float(), sdpa, **TOL[dtype])


@pytest.mark.parametrize("layout", ["ring", "late"])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("Sq,nq,nkv,window", [(1, 4, 4, 0), (16, 2, 2, 0), (2, 14, 2, 0),
                                              (17, 4, 4, 0), (65, 4, 2, 0), (65, 4, 4, 300)])
def test_flash_attention_bf16_paths_on_rings_and_empty_rows(dev, layout, hd, Sq, nq, nkv,
                                                            window):
    """A wrapped ring (kv_pos not monotone in the slot) and a query row with
    no valid key, through the decode path (Sq * nq/nkv <= 16) and the tile
    path, over Skv = 1000 (8-16 split chunks)."""
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, 2, Sq, 1000, nq, nkv, hd,
                                           layout, seed=3)
    got = FA.flash_attention(q, k, v, q_pos, kv_pos, window=window)
    want = FA.flash_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    if layout == "late":
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))


@pytest.mark.parametrize("layout", ["tail", "ring"])
@pytest.mark.parametrize("Sq,nq,nkv", [(1, 14, 14), (2, 14, 2), (65, 4, 4)])
@pytest.mark.parametrize("hd,Skv", [(128, 700), (128, 100), (64, 300), (256, 700), (80, 700),
                                    (80, 100)])
def test_flash_attention_bf16_rows_do_not_depend_on_skv_or_batch(dev, layout, Sq, nq, nkv, hd,
                                                                 Skv):
    """Bitwise: a row's output is the same when empty (-1) slots are appended
    to K/V (more key tiles for the wgmma warpgroups' parity split and the
    mma.sync tiles; more split chunks on the decode path, where Skv = 100
    turns a one-launch call into chunks and a merge), and when its batch
    row is computed alone (B = 1) or among 8."""
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, 8, Sq, Skv, nq, nkv, hd, layout,
                                           seed=4)
    base = FA.flash_attention(q, k, v, q_pos, kv_pos)
    extra = 333
    pad = lambda t, val: torch.cat(  # noqa: E731
        [t, torch.full((8, extra) + t.shape[2:], val, dtype=t.dtype, device=dev)], dim=1)
    longer = FA.flash_attention(q, pad(k, 0), pad(v, 0), q_pos, pad(kv_pos, -1))
    assert torch.equal(longer, base)
    for b in (0, 5):
        alone = FA.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], q_pos[b:b + 1],
                                   kv_pos[b:b + 1])
        assert torch.equal(alone[0], base[b])


@pytest.mark.parametrize("Skv", [64, 128, 129, 256, 300, 383, 511])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_wgmma_key_split_merges_both_halves(dev, Skv, hd):
    """The wgmma path's two consumer warpgroups take the even and the odd key
    tiles of 128 keys: with the last valid key in an even tile (only the
    first warpgroup has keys at Skv <= 128), in an odd one, and in a tile
    cut by Skv, their merged rows and lse equal the plain version's."""
    Sq, nq, nkv = 70, 4, 2
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, 2, Sq, Skv, nq, nkv, hd, "tail",
                                           seed=6)
    g = torch.Generator(device=dev).manual_seed(7)
    q_pos = torch.randint(0, Skv, (2, Sq), generator=g, device=dev, dtype=torch.int32)
    q_pos[:, 0] = Skv - 4  # a row that reads the last valid key
    assert FA.flash_plan(2, Sq, Skv, nq, nkv, hd, torch.bfloat16).path == "wgmma"
    scale = hd ** -0.5
    out, lse = FA._flash_launch(q, k, v, q_pos, kv_pos, True, 0, scale, True)
    want, want_l = FA._flash_plain(q, k, v, q_pos, kv_pos, True, 0, scale)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("Skv,window,layout", [(40, 0, "tail"), (128, 0, "ring"),
                                               (100, 20, "tail"), (128, 0, "late")])
def test_flash_attention_decode_chunk_warps_and_one_launch(dev, Skv, window, layout):
    """One chunk: four warps on fixed quarters of its keys (some with no
    valid key: Skv = 40 fills one and a part, a window of 20 leaves the
    first quarters empty), merged in warp order and written by the chunk's
    own launch. The counter records one kernel launch, and the bits (out
    and lse) equal those of the same keys with 333 empty (-1) slots
    appended, which run as chunks and the merge launch."""
    _decode_one_launch_equals_the_merge(dev, Skv, window, layout, 128)


@pytest.mark.parametrize("Skv,window,layout", [(40, 0, "tail"), (128, 0, "ring"),
                                               (100, 20, "late")])
def test_flash_attention_decode_at_head_dim_80_one_launch_equals_the_merge(dev, Skv, window,
                                                                           layout):
    """The same at head dim 80, where the four warps finish 3, 3, 2 and 2
    of the ten n8 column tiles of the chunk's merge."""
    _decode_one_launch_equals_the_merge(dev, Skv, window, layout, 80)


def _decode_one_launch_equals_the_merge(dev, Skv, window, layout, hd):
    nq, nkv = 14, 14
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, 3, 1, Skv, nq, nkv, hd, layout,
                                           seed=8)
    scale = hd ** -0.5
    plan = FA.flash_plan(3, 1, Skv, nq, nkv, hd, torch.bfloat16)
    assert plan.path == "decode" and plan.n_splits == 1 and not plan.merge
    build.reset_counters()
    out, lse = FA._flash_launch(q, k, v, q_pos, kv_pos, True, window, scale, True)
    torch.cuda.synchronize()
    assert FA.FLASH_ATTENTION.by_call == {("decode", 3, 1, Skv, nq, nkv, hd, 1): 1}
    want, want_l = FA._flash_plain(q, k, v, q_pos, kv_pos, True, window, scale)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=0.0)
    extra = 333
    assert FA.flash_plan(3, 1, Skv + extra, nq, nkv, hd, torch.bfloat16).merge
    pad = lambda t, val: torch.cat(  # noqa: E731
        [t, torch.full((3, extra) + t.shape[2:], val, dtype=t.dtype, device=dev)], dim=1)
    out2, lse2 = FA._flash_launch(q, pad(k, 0), pad(v, 0), q_pos, pad(kv_pos, -1), True, window,
                                  scale, True)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,nq,nkv,layout", [(1, 14, 14, "tail"), (2, 14, 2, "late"),
                                              (300, 4, 2, "tail"), (65, 4, 4, "late")])
def test_flash_attention_lse_matches_plain(dev, dtype, Sq, nq, nkv, layout):
    """The f32 row log-sum-exp the backward reads, on every path (a row with
    no valid key: log(1e-30)). Both sides sum exact bf16 products in f32 in
    other orders, and l over another split of the keys: within 1e-4."""
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, dtype, 2, Sq, 1000, nq, nkv, 128, layout,
                                           seed=5)
    scale = 128 ** -0.5
    _, lse = FA._flash_launch(q, k, v, q_pos, kv_pos, True, 0, scale, True)
    _, want = FA._flash_plain(q, k, v, q_pos, kv_pos, True, 0, scale)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=0.0)


def _eager_and_replayed(fn):
    """fn()'s tensors from an eager call and from one replay of a CUDA graph
    that captured fn (after a warm-up on a side stream, as capture wants)."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    graph.replay()
    torch.cuda.synchronize()
    return want, got


@pytest.mark.parametrize("B,Skv", [(8, 1056), (1, 128)])
def test_flash_attention_decode_replays_in_a_cuda_graph(dev, B, Skv):
    """The decode path captures into a CUDA graph (over many chunks its two
    kernels and the scratch allocation; in one chunk its one kernel), and a
    replay gives the eager call's bits."""
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, B, 1, Skv, 14, 14, 128, "ring")
    want, got = _eager_and_replayed(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos))
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Sq,Skv,hd,needs_grad", [(2, 65, 1000, 128, False),
                                                     (2, 300, 300, 64, True),
                                                     (4, 2048, 2048, 128, True),
                                                     (2, 65, 300, 256, True)])
def test_flash_attention_tile_path_replays_in_a_cuda_graph(dev, B, Sq, Skv, hd, needs_grad):
    """Both tile paths (wgmma: its tensor maps are kernel parameters, so the
    captured launch keeps its own; mma.sync at head dim 256) capture into
    a CUDA graph through the public wrapper, also as training calls it
    (inputs that need a gradient: the kernel writes the lse the Function
    saves), and a replay gives the eager call's bits, out and lse."""
    q, k, v, q_pos, kv_pos = _flash_inputs(dev, torch.bfloat16, B, Sq, Skv, 4, 4, hd, "tail")
    q, k, v = (t.requires_grad_(needs_grad) for t in (q, k, v))
    assert FA.flash_plan(B, Sq, Skv, 4, 4, hd, torch.bfloat16).path == (
        "mma_sync" if hd == 256 else "wgmma")
    (want, want_l), (got, got_l) = _eager_and_replayed(
        lambda: flash_call(FA, q, k, v, q_pos, kv_pos))
    assert torch.equal(got, want)
    if needs_grad:
        assert torch.equal(got_l, want_l)
        _, plain_l = FA._flash_plain(q.detach(), k.detach(), v.detach(), q_pos, kv_pos, True, 0,
                                     hd ** -0.5)
        torch.testing.assert_close(got_l, plain_l, atol=1e-4, rtol=0.0)
    else:
        assert got_l is None and want_l is None


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 2, 48, device=dev)
    pos = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q, pos, pos)
    with pytest.raises(TypeError):
        KR.gather_rows(torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 2, dtype=torch.int32,
                                                                         device=dev))


# ---------------------------------------------------------------------------
# fused routed block kernels
# ---------------------------------------------------------------------------


def _routed_inputs(dev, dtype, B, S, k, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    return g, x, idx


def _w(g, dev, dtype, *shape):
    return (torch.randn(*shape, generator=g, device=dev) / shape[0] ** 0.5).to(dtype)


def _attn_params(g, dev, dtype, D, nq, nkv, hd, bias):
    p = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
         "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
         "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
    if bias:
        for key, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[key] = (0.1 * torch.randn(n * hd, generator=g, device=dev)).to(dtype)
    return p


ATTN_CASES = [
    # B, S, k, D, nq, nkv, hd, bias, window, pos_emb
    (2, 64, 13, 64, 4, 2, 32, True, 0, "rope"),  # GQA, biases, k not a multiple of 16
    (1, 300, 40, 256, 4, 4, 64, False, 16, "rope"),  # sliding window
    (2, 128, 37, 128, 2, 1, 128, False, 0, "none"),
    (1, 64, 20, 512, 2, 2, 256, False, 0, "rope"),  # head_dim 256: > 48 KB shared memory
    (4, 2048, 256, 1792, 14, 14, 128, False, 0, "rope"),  # mod-paper-1b training shape
    (2, 1024, 200, 128, 4, 2, 64, False, 64, "rope"),  # a window across 4 key tiles
    (1, 700, 130, 256, 2, 1, 256, True, 40, "rope"),  # head_dim 256's 32-key tiles, window
    # the wgmma GEMM's edges in bf16: M = B*k of 1, 63, 65, 129 and 1000
    # rows against 128-row tiles; D and nq*hd multiples of 8 but not of 64
    (1, 40, 1, 72, 3, 1, 32, True, 0, "rope"),
    (1, 100, 63, 136, 5, 5, 32, False, 0, "rope"),
    (1, 100, 65, 40, 3, 3, 32, True, 8, "rope"),
    (3, 64, 43, 200, 3, 1, 32, False, 0, "none"),
    (4, 512, 250, 264, 9, 3, 32, True, 0, "rope"),
    (2, 50, 21, 44, 2, 2, 32, True, 0, "rope"),  # D not a multiple of 8: the CUDA-core GEMM
    # the dense configs' widths, k = 128 of S = 1024
    (1, 1024, 128, 5120, 32, 8, 128, False, 0, "rope"),  # mistral-nemo: nq*hd 4096 != D
    (1, 1024, 128, 3584, 28, 4, 128, True, 0, "rope"),  # qwen2: a group of 7, biases
    (1, 1024, 128, 6144, 48, 1, 128, False, 0, "rope"),  # granite-20b: MQA, N = 128
]


def _attn_call(dev, dtype, B, S, k, D, nq, nkv, hd, bias, window, pos_emb):
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 2)
    pos = idx.to(torch.int32)
    pos[0, 0] = -1  # a key without a position is masked out
    params = _attn_params(g, dev, dtype, D, nq, nkv, hd, bias)
    spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, window, 10000.0, pos_emb, 1e-5)
    return (lambda: FA.routed_attention(x, idx, pos, params, spec),
            lambda: FA.routed_attention_plain(x, idx, pos, params, spec))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,k,D,nq,nkv,hd,bias,window,pos_emb", ATTN_CASES)
def test_routed_attention_matches_plain(dev, dtype, B, S, k, D, nq, nkv, hd, bias, window,
                                        pos_emb):
    """Query row 0 of batch row 0 sits at position -1 and has no valid key:
    the dense softmax gives it the mean of V (p = 1/k), as the plain
    version."""
    fn, plain = _attn_call(dev, dtype, B, S, k, D, nq, nkv, hd, bias, window, pos_emb)
    build.reset_counters()
    a, h = fn()
    wa, wh = plain()
    torch.cuda.synchronize()
    path = "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 else "cuda_cores"
    assert build.COUNTERS["routed_attention"].by_call == {(path, B, S, k, D, nq, nkv, hd): 1}
    torch.testing.assert_close(a.float(), wa.float(), **ROUTED_TOL[dtype])
    torch.testing.assert_close(h.float(), wh.float(), **ROUTED_TOL[dtype])


@pytest.mark.parametrize("case", [ATTN_CASES[4], ATTN_CASES[6], ATTN_CASES[11]],
                         ids=["1b", "hd256-window", "M1000"])
def test_routed_attention_bf16_gives_the_same_bits_twice_and_in_a_cuda_graph(dev, case):
    """No split sums and no atomics in either the wgmma GEMM or the
    attention core: two calls agree to the bit, and a CUDA-graph replay
    (tensor maps are kernel parameters) gives the eager call's bits."""
    fn, _ = _attn_call(dev, torch.bfloat16, *case)
    first, second = fn(), fn()
    want, got = _eager_and_replayed(fn)
    for w, f, s_, g_ in zip(want, first, second, got):
        assert torch.equal(f, s_) and torch.equal(g_, w) and torch.equal(w, f)


MLP_CASES = [
    # B, S, k, D, F, act, glu
    (2, 64, 13, 64, 96, "silu", True),
    (1, 100, 30, 128, 200, "gelu", True),
    (2, 48, 17, 64, 130, "gelu", False),
    (4, 2048, 256, 1792, 7168, "silu", True),  # mod-paper-1b training shape
    # the wgmma GEMM's edges in bf16: M = B*k of 1, 63, 65, 129 and 1000
    # rows against 128-row tiles; D and F multiples of 8 but not of the
    # 64-deep K step or the 128-wide tile
    (1, 40, 1, 72, 200, "silu", True),
    (1, 100, 63, 136, 328, "gelu", False),
    (1, 100, 65, 40, 56, "silu", True),
    (3, 64, 43, 200, 136, "gelu", True),
    (4, 512, 250, 264, 392, "silu", True),
]


def _mlp_params(g, dev, dtype, D, F, glu):
    p = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
         "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D)}
    if glu:
        p["w_gate"] = _w(g, dev, dtype, D, F)
    return p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,k,D,F,act,glu", MLP_CASES)
def test_routed_mlp_scatter_matches_plain(dev, dtype, B, S, k, D, F, act, glu):
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 3)
    h = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    a = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    params = _mlp_params(g, dev, dtype, D, F, glu)
    spec = SW.RoutedMlpSpec(act, 1e-5)
    build.reset_counters()
    out = SW.routed_mlp_scatter(x, h, a, idx, gate, params, spec)
    want = SW.routed_mlp_scatter_plain(x, h, a, idx, gate, params, spec)
    torch.cuda.synchronize()
    path = "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 else "cuda_cores"
    assert build.COUNTERS["routed_mlp_scatter"].by_call == {(path, B, S, k, D, F): 1}
    routed = torch.zeros(B, S, dtype=torch.bool, device=dev)
    routed.scatter_(1, idx, True)
    assert torch.equal(out[~routed], x[~routed])  # rows that are not routed pass through
    torch.testing.assert_close(out.float(), want.float(), **ROUTED_TOL[dtype])


# ---------------------------------------------------------------------------
# gradients through every kernel's autograd.Function
# ---------------------------------------------------------------------------


def _grads(fn, inputs, seed):
    """Gradients of a loss linear in fn's outputs (fixed random weights), so
    the cotangents do not depend on the forward values."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    loss.backward()
    return [t.grad for t in leaves if t.requires_grad]


def _assert_grads(got, want, tol):
    for a, b in zip(got, want):
        assert a is not None and b is not None
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routing_gradients_match_plain(dev, dtype):
    _, x, idx = _routed_inputs(dev, dtype, 2, 300, 40, 256, 4)
    g = torch.Generator(device=dev).manual_seed(5)
    delta = torch.randn(2, 40, 256, generator=g, device=dev).to(dtype)
    gate = torch.randn(2, 40, generator=g, device=dev)
    build.reset_counters()
    got = _grads(lambda x_: KR.gather_rows(x_, idx), [x], 0)
    want = _grads(lambda x_: KR.gather_rows_plain(x_, idx), [x], 0)
    assert torch.equal(got[0], want[0])
    got = _grads(lambda *t: KR.scatter_add_rows(t[0], idx, t[1], t[2]), [x, delta, gate], 1)
    want = _grads(lambda *t: KR.scatter_add_rows_plain(t[0], idx, t[1], t[2]), [x, delta, gate], 1)
    torch.cuda.synchronize()
    # gather's backward is a scatter launch (the zero target) and scatter's
    # a gather launch
    assert build.launch_counts()["gather_rows"] == 2
    assert build.launch_counts()["scatter_add_rows"] == 2
    assert [key[0] for key in KR.SCATTER_ADD_ROWS.by_call] == ["scatter_zero", "scatter"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    # gather's backward alone: one zero-target launch and no zero tensor of
    # x's shape (its peak is the gradient it returns)
    xr = x.detach().requires_grad_(True)
    out = KR.gather_rows(xr, idx)
    g_out = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    torch.cuda.synchronize()
    build.reset_counters()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (dx,) = torch.autograd.grad(out, xr, g_out)
    torch.cuda.synchronize()
    nbytes = dx.numel() * dx.element_size()
    assert torch.cuda.max_memory_allocated() - before <= -(-nbytes // 512) * 512
    assert build.launch_counts()["gather_rows"] == 0
    assert [(key[0], n) for key, n in KR.SCATTER_ADD_ROWS.by_call.items()] == [("scatter_zero", 1)]
    ones = torch.ones(idx.shape, device=dev)
    assert torch.equal(dx, KR.scatter_add_rows_plain(torch.zeros_like(x), idx, g_out, ones))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_gradients_match_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(6)
    B, S, nq, nkv, hd = 2, 300, 4, 2, 64
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev).to(dtype)
               for n in (nq, nkv, nkv))
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    pos[:, -5:] = -1
    build.reset_counters()
    got = _grads(lambda *t: FA.flash_attention(*t, pos, pos), [q, k, v], 7)
    want = _grads(lambda *t: FA.flash_attention_plain(*t, pos, pos), [q, k, v], 7)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    _assert_grads(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernel_gradients_match_plain(dev, dtype):
    B, S, k, D, nq, hd, F = 2, 96, 24, 128, 4, 32, 192
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 8)
    pos = idx.to(torch.int32)
    ap = _attn_params(g, dev, dtype, D, nq, nq, hd, True)
    spec = FA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
    keys = list(ap)
    got = _grads(lambda x_, *ps: FA.routed_attention(x_, idx, pos, dict(zip(keys, ps)), spec),
                 [x, *ap.values()], 9)
    want = _grads(lambda x_, *ps: FA.routed_attention_plain(x_, idx, pos, dict(zip(keys, ps)),
                                                            spec), [x, *ap.values()], 9)
    _assert_grads(got, want, dict(atol=1e-5, rtol=1e-5))
    h = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    a = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    mp = _mlp_params(g, dev, dtype, D, F, True)
    mspec = SW.RoutedMlpSpec("silu", 1e-5)
    mkeys = list(mp)
    got = _grads(lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter(
        x_, h_, a_, idx, g_, dict(zip(mkeys, ps)), mspec), [x, h, a, gate, *mp.values()], 10)
    want = _grads(lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter_plain(
        x_, h_, a_, idx, g_, dict(zip(mkeys, ps)), mspec), [x, h, a, gate, *mp.values()], 10)
    _assert_grads(got, want, dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
def test_training_step_launches_the_backends_kernels(dev, backend):
    """A loss and its gradients on the card: pallas_fused runs the fused
    kernels and no gather/scatter; xla and pallas the reverse."""
    from repro_torch.models import api
    from repro_torch.utils import tree_leaves

    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("mod-paper-60m")), backend)
    params = api.init_model(cfg, device=dev, seed=0)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=dev)
    build.reset_counters()
    loss, _ = api.model_loss(params, cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    n = len(params["groups"])
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tree_leaves(params))
    if backend == "pallas_fused":
        assert counts["flash_attention"] == n  # the full blocks only
        assert counts["routed_attention"] == counts["routed_mlp_scatter"] == n
        assert counts["gather_rows"] == counts["scatter_add_rows"] == 0
    else:
        assert counts["flash_attention"] == 2 * n  # full blocks and routed sub-sequences
        # forward gather + scatter, and each one's backward launches the other
        assert counts["gather_rows"] == counts["scatter_add_rows"] == 2 * n
        assert counts["routed_attention"] == counts["routed_mlp_scatter"] == 0


# ---------------------------------------------------------------------------
# paged KV pool kernels: copies, so bitwise; the scatters write in place
# ---------------------------------------------------------------------------

PAGED_DTYPES = [torch.float32, torch.bfloat16, torch.int32]


def _paged_inputs(dev, dtype, N, p, F, B, P, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = (torch.randn(N, p, F, generator=g, device=dev) * 8).to(dtype)
    # distinct physical pages per slot (page 0/1 reserved), as the pool maps them
    perm = torch.randperm(N - 2, generator=g, device=dev)[: B * P] + 2
    table = perm.reshape(B, P).to(torch.int32)
    return g, pages, table


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("N,p,F,B,P", [(530, 16, 1792, 8, 66), (530, 16, 1, 8, 66),
                                       (530, 16, 1792, 1, 62),  # a chunked prefill's table
                                       (11, 3, 5, 3, 3), (40, 7, 13, 2, 4)])
@pytest.mark.parametrize("offset", [0, 1])
def test_paged_gather_bitwise(dev, dtype, N, p, F, B, P, offset):
    """Every vector width the plan takes: 16 bytes, 4 (pages of 60 or 364
    bytes; f32 and int32 views one element off 16 bytes) and 1 (bf16 pages
    of 30 or 182 bytes; bf16 views one element in). The launch counter
    records the plan's width by call."""
    _, pages, table = _paged_inputs(dev, dtype, N, p, F, B, P, 11)
    if offset:  # the same pages in a view one element past an aligned base
        pages = torch.cat([pages.new_zeros(offset), pages.flatten()])[offset:].view(N, p, F)
    table[0, -1] = 0  # an unmapped (NULL) logical page
    table[-1, 0] = N + 5  # out of range: clamped, as the plain version clamps
    build.reset_counters()
    out = KP.paged_gather(pages, table)
    torch.cuda.synchronize()
    assert torch.equal(out, KP.paged_gather_plain(pages, table))
    page_bytes = p * F * pages.element_size()
    vec = KP.gather_plan(N, B, P, page_bytes, pages.data_ptr()).vec
    want_vec = next(v for v in (16, 4, 1) if page_bytes % v == 0 and
                    (offset * pages.element_size()) % v == 0)
    assert vec == want_vec
    assert build.COUNTERS["paged_gather"].by_call == {(vec, B, P, page_bytes): 1}


def test_paged_gather_replays_in_a_cuda_graph(dev):
    _, pages, table = _paged_inputs(dev, torch.bfloat16, 530, 16, 1792, 1, 62, 12)
    want, got = _eager_and_replayed(lambda: KP.paged_gather(pages, table))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("N,p,F,B,P", [(530, 16, 1792, 8, 66), (530, 16, 1, 8, 66),
                                       (11, 3, 5, 3, 3)])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_paged_scatter_rows_in_place_bitwise(dev, dtype, N, p, F, B, P, clamp, offset):
    """The decode-row scatter on the flat grid at every vector width (rows
    one element off an aligned base: 4-byte or 1-byte vectors), bitwise,
    writing no row outside its (clamped) targets, with positions and table
    entries out of range when ``clamp``; the launch counter records the
    plan's width by call."""
    g, pages, table = _paged_inputs(dev, dtype, N, p, F, B, P, 12)
    rows = (torch.randn(B, F, generator=g, device=dev) * 8).to(dtype)
    if offset:  # the same rows in a view one element past an aligned base
        rows = torch.cat([rows.new_zeros(offset), rows.flatten()])[offset:].view(B, F)
    pos = torch.randint(0, P * p, (B,), generator=g, device=dev).to(torch.int32)
    if clamp:  # positions below 0 and past P·p, table entries below 0 and past N
        pos[0], pos[-1] = -5, P * p + 7
        table[:, 0], table[:, -1] = -3, N + 9
    want = KP.paged_scatter_rows_plain(pages.clone(), table, rows, pos)
    before = pages.clone()
    ptr = pages.data_ptr()
    build.reset_counters()
    out = KP.paged_scatter_rows(pages, table, rows, pos)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr and torch.equal(pages, want)
    plan = KP.scatter_rows_plan(N, B, P, p, F * pages.element_size(), pages.data_ptr(),
                                rows.data_ptr())
    assert build.COUNTERS["paged_scatter_rows"].by_call == {
        (plan.vec, B, F * pages.element_size()): 1}
    # exactly the B target rows changed (rows equal to what was there excepted)
    changed = (pages != before).reshape(N * p, -1).any(-1).nonzero().flatten().tolist()
    t = pos.long().clamp(0, P * p - 1)
    pid = table.long()[torch.arange(B, device=dev), t // p].clamp(0, N - 1)
    targets = set((pid * p + t % p).tolist())
    assert set(changed) <= targets


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("N,p,F,B,P,S,C", [(530, 16, 1792, 8, 66, 3, 256), (530, 16, 1, 8, 66, 3, 256),
                                           # W = 7432 narrow rows (slot 0's 7424 prefill rows
                                           # need 464 of its pages)
                                           (3800, 16, 1, 8, 470, 29, 256),
                                           (23, 4, 5, 3, 6, 2, 8)])
@pytest.mark.parametrize("offset", [0, 1])
def test_ragged_paged_scatter_rows_in_place_bitwise(dev, dtype, N, p, F, B, P, S, C, offset):
    """The flat grid at every vector width (rows one element off an aligned
    base: 4-byte or 1-byte vectors), bitwise, writing no row outside its
    targets; the launch counter records the plan's width by call."""
    g, pages, table = _paged_inputs(dev, dtype, N, p, F, B, P, 13)
    W = B + S * C
    rows = (torch.randn(W, F, generator=g, device=dev) * 8).to(dtype)
    if offset:  # the same rows in a view one element past an aligned base
        rows = torch.cat([rows.new_zeros(offset), rows.flatten()])[offset:].view(W, F)
    # decode rows at distinct positions, then S segments of C tokens of
    # slot 0 after them; invalid rows (odd decode slots, segment tails) go
    # to the scratch page
    dec_pos = torch.full((B,), P * p - 1, dtype=torch.int32, device=dev)
    slot = torch.cat([torch.arange(B, device=dev), torch.zeros(S * C, dtype=torch.long, device=dev)])
    pos = torch.cat([dec_pos, torch.arange(S * C, dtype=torch.int32, device=dev)])
    valid = torch.cat([torch.arange(B, device=dev) % 2 == 0,
                       torch.arange(S * C, device=dev) < S * C - C // 2])
    pid, off = KRG.ragged_page_targets(table, slot, pos, valid, p, 1)
    want = KRG.ragged_paged_scatter_rows_plain(pages.clone(), pid, off, rows)
    before = pages.clone()
    build.reset_counters()
    KRG.ragged_paged_scatter_rows(pages, pid, off, rows)
    torch.cuda.synchronize()
    row_bytes = F * pages.element_size()
    plan = KRG.scatter_plan(N, W, p, row_bytes, pages.data_ptr(), rows.data_ptr())
    assert KRG.RAGGED_PAGED_SCATTER_ROWS.by_call == {(plan.vec, W, row_bytes): 1}
    keep = torch.ones(N, dtype=torch.bool, device=dev)
    keep[1] = False  # collisions on the scratch page are garbage by contract
    assert torch.equal(pages[keep], want[keep])
    hit = set((pid.long() * p + off.long()).tolist())
    changed = (pages != before).reshape(N * p, -1).any(-1).nonzero().flatten().tolist()
    assert set(changed) <= hit


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_paged_and_ragged_engines_launch_the_paged_kernels(dev, backend):
    """A paged decode step gathers and scatters every paged leaf once
    (3 per full-attention layer); the ragged step writes back through the
    ragged kernel; both give the contiguous engine's greedy streams."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("mod-paper-60m")), "pallas")
    params = api.init_model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (20, 33, 9, 41)]
    n_full = len(params["groups"])  # one full-attention layer per group
    streams = {}
    for name, kw in (("contiguous", {}), ("paged", dict(page_size=16)),
                     # every prompt chunk in the first step (2+3+1+3): the
                     # decode batches, and so the streams, are the padded ones
                     ("ragged", dict(page_size=16, ragged=True, ragged_segments=9))):
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=64, prefill_chunk=16,
                                                      paged_backend=backend, **kw), device=dev)
        build.reset_counters()
        outs = eng.run_stream([Request(tokens=p, max_new_tokens=6) for p in prompts], 0)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        streams[name] = {o.uid: o.tokens.tolist() for o in outs}
        steps = eng.stats()["decode_steps"]
        if name == "paged":
            assert counts["paged_scatter_rows"] == 3 * n_full * steps
            assert counts["paged_gather"] == 3 * n_full * (steps + len(prompts))
        if name == "ragged":
            assert counts["ragged_paged_scatter_rows"] >= 3 * n_full
            assert counts["paged_scatter_rows"] == 0
    assert streams["paged"] == streams["contiguous"] == streams["ragged"]


# ---------------------------------------------------------------------------
# quantized pages: the dequantizing gather; the ragged MoD dispatch kernels
# ---------------------------------------------------------------------------

NARROW = [torch.int8, torch.float8_e4m3fn]


def _narrow_pages(dev, narrow, N, p, F, G, seed):
    """Narrow pages and pow2 scales as the quantized pool writes them."""
    from repro_torch.serve.quant import QuantConfig, quantize_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, p, F, generator=g, device=dev) * torch.rand(N, p, 1, generator=g,
                                                                    device=dev) * 40
    kv = "int8" if narrow == torch.int8 else "fp8"
    return quantize_rows(x, G, QuantConfig(kv=kv))


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("narrow", NARROW)
@pytest.mark.parametrize("N,p,F,G,B,P", [(498, 16, 1792, 1, 8, 62), (498, 16, 1792, 14, 1, 62),
                                         (11, 3, 5, 1, 3, 3), (40, 7, 48, 3, 2, 4)])
def test_paged_gather_dequant_bitwise(dev, narrow, out_dtype, N, p, F, G, B, P):
    pages, scales = _narrow_pages(dev, narrow, N, p, F, G, 21)
    _, _, table = _paged_inputs(dev, torch.float32, N, 1, 1, B, P, 22)
    table[0, -1] = 0  # an unmapped (NULL) logical page
    table[-1, 0] = table[0, 0]  # a page two slots share (a cached prefix)
    build.reset_counters()
    out = KP.paged_gather_dequant(pages, scales, table, out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and out.shape == (B, P * p, F)
    assert torch.equal(out, KP.paged_gather_dequant_plain(pages, scales, table, out_dtype))
    assert build.launch_counts()["paged_gather_dequant"] == 1


def test_paged_gather_dequant_reads_a_layers_scale_columns(dev):
    """One scale tensor shared by the layers of a stacked leaf: a layer's
    gather reads its column slice (strided) like the plain version."""
    pages, _ = _narrow_pages(dev, torch.int8, 40, 4, 64, 2, 23)
    g = torch.Generator(device=dev).manual_seed(24)
    wide = 2.0 ** torch.randint(-6, 6, (40, 4, 6), generator=g, device=dev).float()
    _, _, table = _paged_inputs(dev, torch.float32, 40, 1, 1, 3, 5, 25)
    for cols in (slice(0, 2), slice(2, 4), slice(4, 6)):
        got = KP.paged_gather_dequant(pages, wide[:, :, cols], table, torch.bfloat16)
        assert torch.equal(got, KP.paged_gather_dequant_plain(pages, wide[:, :, cols], table,
                                                              torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,cap,D", [((1024,) * 4, 128, 1792),
                                        ((142, 998, 500, 300, 700, 256, 611, 400), 125, 1792),
                                        ((3, 1, 0, 5), 4, 13)])
def test_ragged_dispatch_bitwise(dev, dtype, lens, cap, D):
    g = torch.Generator(device=dev).manual_seed(26)
    offs = [0]
    for L in lens:
        offs.append(offs[-1] + L)
    T = offs[-1] + 7  # a padded tail
    x = torch.randn(T, D, generator=g, device=dev).to(dtype)
    idx = torch.full((len(lens), cap), -1, dtype=torch.int32, device=dev)
    for s, L in enumerate(lens):
        k = min(cap, L)
        sel = torch.sort(torch.randperm(L, generator=g, device=dev)[:k]).values
        idx[s, :k] = (offs[s] + sel).to(torch.int32)
    delta = torch.randn(len(lens), cap, D, generator=g, device=dev).to(dtype)
    gate = torch.where(idx >= 0, torch.randn(idx.shape, generator=g, device=dev), 0.0)
    before = x.clone()
    build.reset_counters()
    got = KRG.ragged_gather_rows(x, idx)
    out = KRG.ragged_scatter_add_rows(x, idx, delta, gate)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["ragged_gather_rows"] == 1 and counts["ragged_scatter_add_rows"] == 1
    assert torch.equal(got, KRG.ragged_gather_rows_plain(x, idx))
    assert bool((got[idx < 0] == 0).all())
    assert torch.equal(out, KRG.ragged_scatter_add_rows_plain(x, idx, delta, gate))
    assert torch.equal(x, before)  # a fresh output: the stream is read again later


def test_new_wrappers_refuse_grads_and_bad_input(dev):
    pages, scales = _narrow_pages(dev, torch.int8, 6, 2, 16, 1, 27)
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="gradient"):
        KP.paged_gather_dequant(pages, scales.clone().requires_grad_(True), table)
    with pytest.raises(TypeError, match="int8 or float8"):
        KP.paged_gather_dequant(pages.float(), scales, table)
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    idx = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_gather_rows(x, idx)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_scatter_add_rows(x, idx, torch.zeros(1, 1, 8, device=dev),
                                    torch.zeros(1, 1, device=dev))


@pytest.mark.parametrize("kv,gran", [("int8", "page"), ("fp8", "head")])
def test_quantized_engines_launch_the_dequant_gather(dev, kv, gran):
    """A quantized paged decode step widens every K/V leaf through the
    dequantizing gather (2 per full layer) and gathers positions plainly
    (1 per full layer); the ragged engine's streams equal the paged one's."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig

    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("mod-paper-60m")), "pallas")
    params = api.init_model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (20, 33, 9, 41)]
    n_full = len(params["groups"])
    q = QuantConfig(kv=kv, granularity=gran)
    streams = {}
    for name, kw in (("paged", dict(page_size=16)),
                     ("ragged", dict(page_size=16, ragged=True, ragged_segments=9))):
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=64, prefill_chunk=16,
                                                      quant=q, **kw), device=dev)
        build.reset_counters()
        outs = eng.run_stream([Request(tokens=p, max_new_tokens=6) for p in prompts], 0)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        streams[name] = {o.uid: o.tokens.tolist() for o in outs}
        if name == "paged":
            steps = eng.stats()["decode_steps"]
            assert counts["paged_gather_dequant"] == 2 * n_full * (steps + len(prompts))
            assert counts["paged_gather"] == n_full * (steps + len(prompts))
    assert streams["paged"] == streams["ragged"]


SPEC_ENGINES = {"paged": dict(page_size=16), "int8": dict(page_size=16, prefix_cache=True),
                "ragged": dict(page_size=16, ragged=True, ragged_segments=9)}


@pytest.mark.parametrize("ratio", [0.0, "capacity"])
@pytest.mark.parametrize("engine", list(SPEC_ENGINES))
def test_speculative_streams_equal_plain_on_the_card(dev, engine, ratio):
    """Self-speculative rounds (3 drafts, at draft ratio 0.0: draft then
    verify; at the model's ratio: one fused chain) give the card's
    non-speculative streams on the paged, the int8/page prefix and the
    ragged engine; a round launches only the paged gathers, flash and the
    ragged write-back, and the pool ends with no page in use."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig

    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("mod-paper-60m")), "pallas")
    ratio = cfg.mod.capacity_ratio if ratio == "capacity" else ratio
    params = api.init_model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (20, 33, 9, 41)]
    q = QuantConfig(kv="int8") if engine == "int8" else QuantConfig()
    streams = {}
    for name, spec in (("plain", {}), ("spec", dict(speculate=3, draft_ratio=ratio))):
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=4, ctx=64, prefill_chunk=16,
                                                      quant=q, **SPEC_ENGINES[engine], **spec),
                            device=dev)
        for p in prompts:
            eng.submit(Request(tokens=p, max_new_tokens=10))
        while eng.has_work:
            rounds, before = eng._spec_rounds, build.launch_counts()
            # a step that admits also prefills: check the pure rounds
            quiet = not eng.scheduler.queue and all(s.state == "generate" for s in eng.slots)
            eng.step()
            delta = {k for k, v in build.launch_counts().items() if v != before[k]}
            if spec and quiet and eng._spec_rounds > rounds:
                assert delta <= {"paged_gather", "paged_gather_dequant", "flash_attention",
                                 "ragged_paged_scatter_rows"}, delta
                assert "ragged_paged_scatter_rows" in delta
        streams[name] = {o.uid: o.tokens.tolist() for o in eng.finished}
        assert eng.stats()["pages_in_use"] == 0.0
        if spec:
            assert eng.stats()["speculative_rounds"] > 0
    assert streams["spec"] == streams["plain"]


def test_truncate_keeps_the_card_pool_consistent(dev):
    """Truncation drops the tail pages from the table (back to NULL) and the
    refcounts, leaves the kept pages' bytes alone, and a page it freed
    comes back scrubbed; reads past the cut see the template."""
    import numpy as np

    from repro_torch.serve.cache import _RESERVED, NULL_PAGE, PagedCachePool, flatten

    cfg = TC.smoke_config(TC.get_config("mod-paper-60m"))
    pool = PagedCachePool(cfg, 2, 64, 16, dev)
    pool.acquire(0)
    assert pool.alloc_pages(0, 64)
    ids = [int(x) for x in pool.table_np[0, :4]]
    g = torch.Generator(device=dev).manual_seed(5)
    for pages in pool.pages:
        fill = torch.randint(-100, 100, pages[ids].shape, generator=g, device=dev)
        pages[ids] = fill.to(pages.dtype)
    before = [pages.clone() for pages in pool.pages]
    assert pool.truncate(0, 20) == 2
    assert int(pool.n_mapped[0]) == 2 and (pool.table_np[0, 2:] == NULL_PAGE).all()
    assert set(ids[2:]) <= set(pool.free)
    assert all(torch.equal(a[ids], b[ids]) for a, b in zip(pool.pages, before))
    ref = np.zeros_like(pool.ref)
    np.add.at(ref, pool.table_np[0, :2], 1)
    assert (pool.ref == ref).all() and pool.ref[:_RESERVED].sum() == 0
    work = pool.read_slot(0)
    for j, i in enumerate(pool._paged_ids):
        leaf = flatten(work)[i][0]
        assert torch.equal(leaf[:32], torch.cat([before[j][ids[0]], before[j][ids[1]]]))
        tmpl = pool._tmpl_pages[j]
        assert torch.equal(leaf[32:], tmpl.repeat((2,) + (1,) * (tmpl.dim() - 1)))
    pool.acquire(1)
    assert pool.alloc_pages(1, 64)  # the free list's front: never used pages
    assert pool.alloc_pages(0, 64)  # then the two truncated ones, scrubbed
    assert [int(x) for x in pool.table_np[0, 2:]] == ids[2:]
    for j, pages in enumerate(pool.pages):
        for pid in ids[2:]:
            assert torch.equal(pages[pid], pool._tmpl_pages[j])


def test_forward_ragged_launches_the_dispatch_kernels(dev):
    """One ragged gather and one ragged scatter per MoD layer; equal
    segments give the padded forward's logits (dense ragged attention vs
    the flash kernel: f32 sums in other orders)."""
    import dataclasses

    from repro_torch.models import api

    cfg = TC.with_mod_backend(dataclasses.replace(
        TC.smoke_config(TC.get_config("mod-paper-60m")), dtype="float32"), "pallas")
    params = api.init_model(cfg, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(28)
    toks = torch.randint(0, cfg.vocab, (3, 32), generator=g, device=dev)
    offs = torch.arange(4, dtype=torch.int32, device=dev) * 32
    build.reset_counters()
    flat, _ = api.model_forward_ragged(params, cfg, toks.reshape(-1), offs, 32)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    assert counts["ragged_gather_rows"] == n_mod and counts["ragged_scatter_add_rows"] == n_mod
    padded, _ = api.model_forward(params, cfg, {"tokens": toks})
    torch.testing.assert_close(flat, padded.reshape(96, -1), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# SSD intra-chunk kernel (Mamba2)
# ---------------------------------------------------------------------------


def _ssd_inputs(dev, dtype, B, H, NC, Q, hd, ds, seed, layout="jax"):
    """mamba2's A = -(1..H) and dt drawn as its init draws dt_bias, so the
    decay's upper triangle overflows. layout "model": x, loglam and dt are
    (B, H, NC, Q, ·) views of (B, S, H, ·) tensors, as ssd_chunked passes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(B, NC, Q, H, generator=g, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    x = torch.randn(B, NC, Q, H, hd, generator=g, device=dev).to(dtype)
    Bm = torch.randn(B, NC, Q, ds, generator=g, device=dev).to(dtype)
    Cm = torch.randn(B, NC, Q, ds, generator=g, device=dev).to(dtype)
    perm = lambda t: t.permute(0, 3, 1, 2, *range(4, t.dim()))  # noqa: E731
    x, dt = perm(x), perm(dt)
    if layout == "jax":
        x, dt = x.contiguous(), dt.contiguous()
    return x, dt * A[None, :, None, None], dt, Bm, Cm


def _ssd_tol(loglam):
    return 1e-5 + 2 * torch.cumsum(loglam, -1).abs().max().item() * 2.0**-24


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,NC,Q,hd,ds,layout", [
    (4, 64, 16, 128, 64, 128, "model"),  # mamba2-1.3b's full blocks (S = 2048)
    (4, 64, 2, 128, 64, 128, "model"),  # its routed blocks (k = 256)
    (4, 5, 16, 64, 32, 32, "model"),  # bf16: G = 3 heads per block, 5 heads
    (1, 3, 2, 16, 32, 16, "jax"),  # odd heads, the smoke chunk
    (2, 5, 3, 40, 8, 24, "jax"),  # widths that are not multiples of 16
    (1, 80, 16, 128, 64, 64, "model"),  # zamba2-2.7b's forward (S = 2048, d_state 64)
])
def test_ssd_intra_chunk_matches_plain(dev, dtype, B, H, NC, Q, hd, ds, layout):
    """Each path within SSD_TOL of the plain version: bf16 with Q, hd and
    ds multiples of 16 on tensor cores, the rest on CUDA cores, as the
    launch counter records by call."""
    x, loglam, dt, Bm, Cm = _ssd_inputs(dev, dtype, B, H, NC, Q, hd, ds, 3, layout)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = KSSD.ssd_plan(B, H, NC, Q, hd, ds, dtype, sms, KSSD.aligned_rows(x, Bm, Cm))
    tensor = dtype == torch.bfloat16 and Q % 16 == hd % 16 == ds % 16 == 0
    assert plan.path == ("tensor" if tensor else "cuda")
    if tensor and H == 5:
        assert H % plan.G != 0
    build.reset_counters()
    y, inc = KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm)
    torch.cuda.synchronize()
    assert build.COUNTERS["ssd_intra_chunk"].by_call == {(plan.path, B, H, NC, Q, hd, ds): 1}
    wy, winc = KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(inc).all()
    tol = _ssd_tol(loglam)
    for got, want in ((y, wy), (inc, winc)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= tol, (err, tol)


def test_ssd_intra_chunk_paths_agree_and_replay(dev):
    """At mamba2's routed shape in bf16 the CUDA-core path, forced through
    the planner, and the tensor-core path both hold SSD_TOL; the tensor-core
    call gives the same bits twice and in a CUDA-graph replay."""
    x, loglam, dt, Bm, Cm = _ssd_inputs(dev, torch.bfloat16, 4, 64, 2, 128, 64, 128, 5, "model")
    wy, winc = KSSD.ssd_intra_chunk_plain(x, loglam, dt, Bm, Cm)
    tol = _ssd_tol(loglam)
    build.reset_counters()
    outs = {path: KSSD._launch(x, loglam, dt, Bm, Cm, path) for path in ("cuda", "tensor")}
    assert set(k[0] for k in build.COUNTERS["ssd_intra_chunk"].by_call) == {"cuda", "tensor"}
    for y, inc in outs.values():
        for got, want in ((y, wy), (inc, winc)):
            assert ((got - want).abs().max() / want.abs().max()).item() <= tol
    want, got = _eager_and_replayed(lambda: torch.cat(
        [t.flatten() for t in KSSD.ssd_intra_chunk(x, loglam, dt, Bm, Cm)]))
    assert torch.equal(got, want)
    assert torch.equal(want, torch.cat([t.flatten() for t in outs["tensor"]]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_intra_chunk_gradients_match_plain(dev, dtype):
    """The Function's backward recomputes through the plain version, so
    this holds its wiring (each input's gradient, in order, finite, and
    none for an input that needs none), not the kernel: the test above
    holds the kernel's forward."""
    x, loglam, dt, Bm, Cm = _ssd_inputs(dev, dtype, 2, 8, 2, 64, 32, 32, 4, "model")
    got = _grads(KSSD.ssd_intra_chunk, [x, loglam, dt, Bm, Cm], 11)
    want = _grads(KSSD.ssd_intra_chunk_plain, [x, loglam, dt, Bm, Cm], 11)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
    _assert_grads(got, want, dict(atol=1e-6, rtol=1e-6))
    xg = x.detach().clone().requires_grad_(True)
    rest = [t.detach().clone() for t in (loglam, dt, Bm, Cm)]
    y, _ = KSSD.ssd_intra_chunk(xg, *rest)
    y.sum().backward()
    assert xg.grad is not None and all(t.grad is None for t in rest)


def test_ssm_training_step_launches_the_ssd_kernel(dev):
    """The smoke mamba2-1.3b on the card: two SSD kernel launches per
    group in the forward (the full and the routed block), gather/scatter
    for the routed blocks, finite loss and gradients, and the CPU's loss."""
    import dataclasses

    from repro_torch.models import api
    from repro_torch.params import to_numpy_tree
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(TC.smoke_config(TC.get_config("mamba2-1.3b")), dtype="float32")
    params = api.init_model(cfg, device=dev, seed=0)
    cpu = api.init_model(cfg, device="cpu", seed=0)  # same shapes, then the card's values
    for a, b in zip(tree_leaves(cpu), tree_leaves(params)):
        a.copy_(b.cpu())
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for p in tree_leaves(params):
        p.requires_grad_(True)
    build.reset_counters()
    loss, _ = api.model_loss(params, cfg, batch)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    n = len(params["groups"])
    assert counts["ssd_intra_chunk"] == 2 * n
    assert counts["gather_rows"] == counts["scatter_add_rows"] == n
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tree_leaves(params))
    cpu_loss, _ = api.model_loss(cpu, cfg, {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    assert to_numpy_tree(params)["groups"]["mod"]["block"]["ssm"]["A_log"].shape == (n, 8)


# ---------------------------------------------------------------------------
# The op entry point's kernels: ragged paged flash attention and SwiGLU
# ---------------------------------------------------------------------------

SWIGLU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
NARROW_KV = [None, torch.int8, torch.float8_e4m3fn]


@pytest.mark.parametrize("causal,window", RAGGED_EDGE_MODES)
@pytest.mark.parametrize("narrow", NARROW_KV, ids=["wide", "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_paged_attention_matches_plain(dev, dtype, narrow, causal, window):
    check_ragged_edge_case(dev, dtype, narrow, causal, window)


@pytest.mark.parametrize("hd", [32, 128, 256])
def test_ragged_paged_attention_head_dims_and_a_decode_step(dev, hd):
    """Decode rows (seg_cap 1) over 62-page contexts of 16-row pages, MHA."""
    g = torch.Generator(device=dev).manual_seed(hd)
    B, P, p, nq = 8, 62, 16, 4
    N = 2 + B * P
    i32 = dict(dtype=torch.int32, device=dev)
    table = (2 + torch.randperm(B * P, generator=g, device=dev)).view(B, P).to(torch.int32)
    lens = torch.randint(1, P * p + 1, (B,), generator=g, device=dev)
    pos = torch.full((N, p), -1, **i32)
    for b in range(B):
        ids = torch.arange(int(lens[b]), **i32)
        pos[table[b, ids // p].long(), (ids % p).long()] = ids
    args = (torch.randn(B, nq, hd, generator=g, device=dev).bfloat16(),
            *(torch.randn(N, p, nq, hd, generator=g, device=dev).bfloat16() for _ in range(2)),
            pos, table, torch.arange(B + 1, **i32), torch.arange(B, **i32),
            (lens - 1).to(torch.int32))
    out = KRG.ragged_paged_flash_attention(*args, seg_cap=1)
    want = KRG.ragged_paged_flash_attention_plain(*args, seg_cap=1)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])


def _mixed_step(dev, dtype, narrow, hd=64, p=16, P=12, nq=4, nkv=2, B=4, prefill=40,
                null_pages=0, seed=0, keys=None):
    """Phase 10's mixed step at a small size: ``B`` slots whose first two
    pages are one shared prefix run, slot b holding positions [0, n_b); a
    decode row per slot at n_b - 1, then (``prefill`` > 0) a segment
    re-reading slot 0's last ``prefill`` positions, then 5 rows at
    position -1. The table maps each slot's pages in a shuffled order,
    NULL past its length, and ``null_pages`` more NULL entries. ``keys``:
    only these key indices of each slot hold a position. Narrow pages
    (int8 / e4m3) carry pow2 scales. Returns (args, keywords) of
    ragged_paged_flash_attention."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    N, shared = 2 + B * P, 2
    n = torch.randint(max(prefill, shared * p) + 1, P * p + 1, (B,), generator=g, device=dev)
    table = (2 + torch.randperm(B * P, generator=g, device=dev)).view(B, P).to(torch.int32)
    table[:, :shared] = table[0, :shared]
    table[torch.arange(P, device=dev)[None] * p >= n[:, None]] = 0
    pos = torch.full((N, p), -1, **i32)
    for b in range(B):
        ids = torch.arange(int(n[b]), **i32)
        if keys is not None:
            ids = ids[torch.isin(ids, torch.as_tensor(keys, **i32))]
        pos[table[b, ids // p].long(), (ids % p).long()] = ids
    table = torch.cat([table, torch.zeros(B, null_pages, **i32)], 1)
    q_pos = [(n - 1).to(torch.int32)]
    offs = list(range(B + 1))
    if prefill:
        q_pos.append(torch.arange(int(n[0]) - prefill, int(n[0]), **i32))
        offs.append(B + prefill)
    q_pos = torch.cat(q_pos + [torch.full((5,), -1, **i32)])
    slot = torch.cat([torch.arange(B, **i32), torch.zeros(len(offs) - 1 - B, **i32)])
    q = torch.randn(q_pos.shape[0], nq, hd, generator=g, device=dev).to(dtype)
    kv = [torch.randn(N, p, nkv, hd, generator=g, device=dev) for _ in range(2)]
    kw = dict(seg_cap=max(prefill, 1))
    if narrow is None:
        kv = [t.to(dtype) for t in kv]
    else:
        qmax = 127.0 if narrow == torch.int8 else 448.0
        kv = [(t * qmax / 3).clamp(-qmax, qmax).round().to(narrow) for t in kv]
        for name in ("k_scales", "v_scales"):
            kw[name] = 2.0 ** torch.randint(-9, -5, (N, p, nkv), generator=g, device=dev).float()
    return (q, *kv, pos, table, torch.tensor(offs, **i32), slot, q_pos), kw


def _ragged_call(args, kw):
    """The kernel's output, its plan and the counter's record of the call."""
    build.reset_counters()
    out = KRG.ragged_paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    return out, ragged_plan(args, kw), dict(build.COUNTERS["ragged_paged_flash_attention"].by_call)


@pytest.mark.parametrize("step", ["decode", "mixed"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("narrow", NARROW_KV, ids=["wide", "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_attention_every_path_and_head_dim(dev, dtype, narrow, hd, step):
    """bf16 queries on wide, int8 and e4m3 pages take the mma path, f32
    queries the f32 one; 192 keys a slot are two chunks (three at head dim
    256): the merge launch. Within TOL of the plain version, the flat tail
    exactly 0, the plan counted by call."""
    args, kw = _mixed_step(dev, dtype, narrow, hd=hd, prefill=0 if step == "decode" else 40,
                           seed=hd)
    out, plan, calls = _ragged_call(args, kw)
    assert plan.path == ("mma" if dtype == torch.bfloat16 else "f32")
    if plan.path == "mma":
        assert plan.rows == (16 if step == "decode" else 64) and plan.merge
    assert sum(calls.values()) == 1 and next(iter(calls))[-1] == plan.kernels
    want = KRG.ragged_paged_flash_attention_plain(*args, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert not out[int(args[5][-1]):].any()


@pytest.mark.parametrize("prefill", [0, 40])
@pytest.mark.parametrize("narrow", NARROW_KV, ids=["wide", "int8", "fp8"])
def test_ragged_attention_keys_past_bits_31_and_63(dev, narrow, prefill):
    """Only keys 33, 47, 63, 64, 97 and 127 of each slot's first chunk, and
    99-127 of the second, hold positions: a mask narrower than the chunk
    would drop them and the rows would differ from the plain version."""
    keys = [33, 47, 63, 64, 97, 127] + list(range(227, 256))
    args, kw = _mixed_step(dev, torch.bfloat16, narrow, P=16, prefill=prefill, keys=keys, seed=5)
    out, plan, _ = _ragged_call(args, kw)
    assert plan.chunk == 128 and plan.n_chunks == 2
    want = KRG.ragged_paged_flash_attention_plain(*args, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
    assert want[:4].abs().amax() > 0.1  # the decode rows see those keys


@pytest.mark.parametrize("narrow", [None, torch.int8], ids=["wide", "int8"])
@pytest.mark.parametrize("p", [8, 16, 32])
def test_ragged_attention_page_sizes(dev, p, narrow):
    """Keys are looked up through the table one row at a time: pages of 8,
    16 and 32 rows, chunks that start mid-page or span several pages."""
    args, kw = _mixed_step(dev, torch.bfloat16, narrow, p=p, P=384 // p, seed=p)
    out, _, _ = _ragged_call(args, kw)
    want = KRG.ragged_paged_flash_attention_plain(*args, **kw)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("prefill", [0, 40])
@pytest.mark.parametrize("narrow", NARROW_KV, ids=["wide", "int8", "fp8"])
def test_ragged_attention_split_context_equals_one_chunk(dev, narrow, prefill):
    """The same 128-key contexts in one chunk (one launch, the output
    written by the block) and with 16 NULL pages more in the table (three
    chunks, two of them empty, and the merge launch): the same bits."""
    one = _mixed_step(dev, torch.bfloat16, narrow, P=8, prefill=prefill, seed=9)
    split = _mixed_step(dev, torch.bfloat16, narrow, P=8, prefill=prefill, seed=9,
                        null_pages=16)
    got_one, plan_one, _ = _ragged_call(*one)
    got_split, plan_split, _ = _ragged_call(*split)
    assert (plan_one.kernels, plan_split.kernels, plan_split.n_chunks) == (1, 2, 3)
    assert torch.equal(got_one, got_split)


@pytest.mark.parametrize("P", [8, 12])
@pytest.mark.parametrize("narrow", [None, torch.float8_e4m3fn], ids=["wide", "fp8"])
def test_ragged_attention_same_bits_twice_and_in_a_cuda_graph(dev, narrow, P):
    """No atomics and a fixed merge order: two calls agree to the bit, and
    the call (one launch at P=8, the merge at 12, its scratch allocated
    inside the capture) replays in a CUDA graph with the eager call's bits."""
    args, kw = _mixed_step(dev, torch.bfloat16, narrow, P=P, seed=P)
    fn = lambda: KRG.ragged_paged_flash_attention(*args, **kw)  # noqa: E731
    assert torch.equal(fn(), fn())
    want, got = _eager_and_replayed(fn)
    assert torch.equal(got, want)


def _swiglu_inputs(dev, dtype, M, D, F):
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn(M, D, generator=g, device=dev).to(dtype)
    w = [(torch.randn(a, b, generator=g, device=dev) / a ** 0.5).to(dtype)
         for a, b in ((D, F), (D, F), (F, D))]
    return x, w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,F", [
    (37, 40, 72), (33, 44, 70), (1, 64, 64), (256, 1792, 7168),
    # the wgmma GEMM's edges: M against 128-row tiles; D and F multiples of
    # 8 but not of the 64-deep K step or the 128-wide tile
    (1, 72, 200), (63, 136, 328), (65, 40, 56), (129, 200, 136), (1000, 264, 392),
    (1000, 1792, 7168),  # mod-paper-1b's MLP
])
def test_swiglu_matches_plain(dev, dtype, M, D, F):
    """bf16 with D and F multiples of 8 runs the wgmma GEMM, the rest the
    CUDA-core one."""
    x, w = _swiglu_inputs(dev, dtype, M, D, F)
    build.reset_counters()
    out = SW.swiglu(x, *w)
    path = "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 else "cuda_cores"
    assert build.COUNTERS["swiglu"].by_call == {(path, M, D, F): 1}
    want = SW.swiglu_plain(x, *w)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= SWIGLU_TOL[dtype] * scale


def test_swiglu_takes_the_cuda_cores_for_an_unaligned_base(dev):
    """A bf16 view whose base is not 16-byte aligned takes the CUDA-core
    GEMM, chosen before launch, and agrees with the plain version."""
    x, w = _swiglu_inputs(dev, torch.bfloat16, 65, 136, 328)
    xs = torch.cat([x.new_zeros(1, 136), x])[1:]  # contiguous, base 272 bytes in
    wg = torch.cat([w[0].new_zeros(1), w[0].flatten()])[1:].view(136, 328)  # 2 bytes in
    assert xs.data_ptr() % 16 == 0 and wg.data_ptr() % 16 == 2
    build.reset_counters()
    out = SW.swiglu(xs, wg, w[1], w[2])
    assert build.COUNTERS["swiglu"].by_call == {("cuda_cores", 65, 136, 328): 1}
    want = SW.swiglu_plain(x, *w)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= SWIGLU_TOL[torch.bfloat16] * scale


def _mlp_call(dev, dtype, B, S, k, D, F, act="silu", glu=True):
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 3)
    h = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    a = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    params = _mlp_params(g, dev, dtype, D, F, glu)
    spec = SW.RoutedMlpSpec(act, 1e-5)
    return lambda: SW.routed_mlp_scatter(x, h, a, idx, gate, params, spec)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["swiglu", "routed_mlp_scatter"])
def test_mlp_kernels_give_the_same_bits_twice(dev, dtype, kernel):
    """No split of K and no atomics: two calls on the same inputs agree to
    the bit, on either GEMM."""
    if kernel == "swiglu":
        x, w = _swiglu_inputs(dev, dtype, 1000, 264, 392)
        fn = lambda: SW.swiglu(x, *w)  # noqa: E731
    else:
        fn = _mlp_call(dev, dtype, 4, 512, 250, 264, 392)
    assert torch.equal(fn(), fn())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,shape", [
    ("swiglu", (129, 200, 136)), ("swiglu", (1024, 1792, 7168)),
    ("routed_mlp_scatter", (3, 64, 43, 200, 136)),
    ("routed_mlp_scatter", (4, 2048, 256, 1792, 7168)),
])
def test_mlp_kernels_replay_in_a_cuda_graph(dev, dtype, kernel, shape):
    """Both GEMMs' launches (their tensor maps are kernel parameters)
    capture into a CUDA graph, and a replay gives the eager call's bits."""
    if kernel == "swiglu":
        x, w = _swiglu_inputs(dev, dtype, *shape)
        fn = lambda: SW.swiglu(x, *w)  # noqa: E731
    else:
        fn = _mlp_call(dev, dtype, *shape)
    want, got = _eager_and_replayed(fn)
    assert torch.equal(got, want)


def test_op_kernels_refuse_grads_and_bad_input(dev):
    args, kw = ragged_edge_case(dev, torch.float32, None, seed=3)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_paged_flash_attention(args[0].clone().requires_grad_(True), *args[1:], **kw)
    with pytest.raises(ValueError, match="head_dim"):
        KRG.ragged_paged_flash_attention(args[0][..., :48].contiguous(),
                                         *(t[..., :48].contiguous() for t in args[1:3]),
                                         *args[3:], **kw)
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    w = torch.zeros(8, 6, device=dev)
    with pytest.raises(ValueError, match="gradient"):
        SW.swiglu(x, w, w, w.T.contiguous())


# ---------------------------------------------------------------------------
# MoE (models/moe.py: torch ops; the staged-MoDE fused block's kernels)
# ---------------------------------------------------------------------------

MOE_CASES = {  # (n_experts, top_k, capacity_factor, n_noop_experts, d_model, d_ff_expert, B, S)
    "e4k2": (4, 2, 1.25, 0, 64, 32, 2, 64),
    "e64k8-binding": (64, 8, 0.5, 0, 256, 128, 2, 256),
    "noop2-binding": (8, 2, 0.5, 2, 128, 64, 3, 100),
    "decode": (64, 8, 1.25, 0, 256, 128, 8, 1),
}


def _moe_case(case, dtype="float32"):
    E, k, cf, noop, D, F, B, S = MOE_CASES[case]
    cfg = TC.ModelConfig(family="moe", d_model=D, dtype=dtype, moe=TC.MoEConfig(
        enabled=True, n_experts=E, top_k=k, capacity_factor=cf, n_noop_experts=noop,
        d_ff_expert=F))
    params = TMOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(1)).to(params["w_up"].dtype)
    return cfg, params, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_on_the_card_matches_the_cpu(dev, case):
    cfg, params, x = _moe_case(case)
    want, want_aux = TMOE.moe_mlp(params, x, cfg)
    p_dev = {n: t.to(dev) for n, t in params.items()}
    r_cpu, r_dev = TMOE.route(params, x, cfg), TMOE.route(p_dev, x.to(dev), cfg)
    for name in ("sel", "pos", "keep", "disp"):
        assert torch.equal(getattr(r_dev, name).cpu(), getattr(r_cpu, name)), name
    got, aux = TMOE.moe_mlp(p_dev, x.to(dev), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert sorted(aux) == sorted(want_aux)
    for key in want_aux:
        if key.endswith("frac"):
            assert float(aux[key]) == float(want_aux[key]), key
        else:
            torch.testing.assert_close(aux[key].cpu(), want_aux[key], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combine", ["float32", "bfloat16"])
def test_moe_combine_gives_the_same_bits_twice(dev, dtype, combine):
    """No scatter-add (``index_add_`` adds with atomics in a run-dependent
    order): two calls on the card agree to the bit."""
    cfg, params, x = _moe_case("e64k8-binding", dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, combine_dtype=combine))
    p_dev = {n: t.to(dev) for n, t in params.items()}
    xd = x.to(dev)
    first, _ = TMOE.moe_mlp(p_dev, xd, cfg)
    for _ in range(3):
        assert torch.equal(TMOE.moe_mlp(p_dev, xd, cfg)[0], first)


def test_staged_mode_fused_forward_launches_per_routed_layer(dev):
    """olmoe-1b-7b smoke, pallas_fused: each routed layer's block runs
    routed_attention (the gather in its prologue) and the expert combine
    through scatter_add_rows, once each; the full layers' attention runs
    flash; nothing runs gather_rows."""
    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("olmoe-1b-7b")), "pallas_fused")
    params = TAPI.init_model(cfg, device=dev, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(2))
    n_mod = sum(1 for grp in params["groups"] if "mod" in grp)
    build.reset_counters()
    logits, aux = TAPI.model_forward(params, cfg, {"tokens": toks.to(dev)})
    counts = build.launch_counts()
    assert n_mod == 2 and bool(torch.isfinite(logits).all())
    assert counts["routed_attention"] == n_mod and counts["scatter_add_rows"] == n_mod
    assert counts["gather_rows"] == 0 and counts["routed_mlp_scatter"] == 0
    assert counts["flash_attention"] == len(params["groups"])
    assert "moe/lb_loss" in aux and "full/moe/lb_loss" in aux


def test_overload_adaptive_lifecycle_card_equals_cpu(dev):
    """13a (i) on the card: levels, outcomes, counters and the rejection's
    reason equal the CPU run's, and the launches include the paged gather
    and scatter and flash."""
    from chip_smoke import _to

    cfg = TC.with_mod_backend(dataclasses.replace(TC.get_config("mod-paper-60m"),
                                                  dtype="float32"), "pallas")
    p_cpu = TAPI.init_model(cfg, device="cpu", seed=3)
    want = adaptive_lifecycle("cpu", p_cpu, cfg)
    build.reset_counters()
    got = adaptive_lifecycle(dev, _to(p_cpu, dev), cfg)
    assert got == want
    counts = build.launch_counts()
    assert all(counts[k] > 0 for k in ("paged_gather", "paged_scatter_rows", "flash_attention",
                                      "gather_rows", "scatter_add_rows"))


@pytest.mark.parametrize("engine", list(FAULT_ENGINES_60M) + ["vanilla"])
def test_faults_soak_card_equals_cpu(dev, engine):
    """13a (ii)-(iii) on the card: FaultInjector.seeded(0) gives the CPU's
    fired log, outcomes and counters, and JAX's contract holds."""
    from chip_smoke import _to

    name = "mod-paper-60m-vanilla" if engine == "vanilla" else "mod-paper-60m"
    cfg = TC.with_mod_backend(dataclasses.replace(TC.get_config(name), dtype="float32"), "pallas")
    p_cpu = TAPI.init_model(cfg, device="cpu", seed=3)
    kw = {} if engine == "vanilla" else FAULT_ENGINES_60M[engine]
    assert fault_soak(dev, _to(p_cpu, dev), cfg, 0, kw) == fault_soak("cpu", p_cpu, cfg, 0, kw)



# ---------------------------------------------------------------------------
# Partitioned routing and the mesh engine (phase 16 of chip_smoke.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_batch_select_on_the_card_matches_the_cpu(dev, d):
    """The partitioned top-k per slot group, ties and -inf rows included."""
    import numpy as np

    from repro_torch.core import router as TR

    rng = np.random.default_rng(d)
    for _ in range(8):
        s = rng.integers(0, 4, 32).astype(np.float32)
        s[rng.random(32) < 0.3] = -np.inf
        for kb in (0, 1, 2, 32 // d):
            want = TR.batch_select(torch.as_tensor(s), kb, d)
            got = TR.batch_select(torch.as_tensor(s, device=dev), kb, d)
            assert torch.equal(got.cpu(), want)


def test_mesh_one_rank_nccl_equals_data_shards_1(dev, tmp_path):
    """16b at 60m (4 layers, f32): the contiguous engine over a one-rank
    NCCL mesh gives the unsharded engine's streams and decode logits, bit
    for bit."""
    import numpy as np
    from torch import distributed as dist

    from chip_smoke import _mesh_60m_serve
    from repro_torch.launch import mesh as M

    ref_streams, ref_logits, ref_kb, _, _ = _mesh_60m_serve(dev)
    M.init_process_group("nccl", rank=0, world_size=1,
                         store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        streams, logits, kb, rows, _ = _mesh_60m_serve(dev, mesh=M.auto_mesh())
    finally:
        M.destroy_process_group()
    assert streams == ref_streams and kb == ref_kb and rows == 8
    np.testing.assert_array_equal(logits, ref_logits)


@contextlib.contextmanager
def _one_rank_nccl(tmp_path):
    from torch import distributed as dist

    from repro_torch.launch import mesh as M

    M.init_process_group("nccl", rank=0, world_size=1,
                         store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield M
    finally:
        M.destroy_process_group()


def test_autograd_collectives_one_rank_nccl(dev, tmp_path):
    from torch import distributed as dist

    from repro_torch.distributed import collectives as C

    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((4, 6), generator=g).to(dev).requires_grad_(True)
    w = torch.randn((4, 6), generator=g).to(dev)
    with _one_rank_nccl(tmp_path):
        group = dist.group.WORLD
        outs = [C.copy_to(x, group), C.reduce_from(x, group), C.gather_from(x, 1, group),
                C.gather_params(x, 0, group), C.sum_over(x, (group,))]
        for y in outs:
            assert y.is_cuda
            torch.testing.assert_close(y, x, rtol=0, atol=0)
            (gx,) = torch.autograd.grad((y * w).sum(), x)
            torch.testing.assert_close(gx, w, rtol=0, atol=0)
        assert torch.equal(C.reduce_scatter(w, 1, group), w)
        assert torch.equal(C.all_gather(w, 0, group), w)


def test_compressed_all_reduce_cuda_equals_cpu(dev, tmp_path):
    from torch import distributed as dist

    from repro_torch.optim.compression import compressed_all_reduce, init_error_feedback

    g = torch.Generator(device="cpu").manual_seed(1)
    # leaves at many scales: a reciprocal multiply in place of the divide
    # by 127 is an ulp off for a share of them
    grads = [torch.randn((1000,), generator=g), torch.randn((33, 7), generator=g) * 1e-3]
    grads += [torch.randn((64,), generator=g) * float(torch.rand((), generator=g)) * 10.0 ** e
              for e in range(-4, 4) for _ in range(8)]
    err = [torch.randn(t.shape, generator=g) * 1e-2 for t in grads]
    with _one_rank_nccl(tmp_path):
        cpu_group = dist.new_group(backend="gloo")
        want, want_e = compressed_all_reduce(grads, cpu_group, err)
        got, got_e = compressed_all_reduce([t.to(dev) for t in grads], dist.group.WORLD,
                                           [t.to(dev) for t in err])
        zeros = init_error_feedback([t.to(dev) for t in grads])
    for a, b in zip(got + got_e, want + want_e):
        assert torch.equal(a.cpu(), b)
    assert all(z.is_cuda and not z.any() for z in zeros)


@pytest.mark.parametrize("fsdp", [False, True])
def test_mesh_train_step_one_rank_launches(dev, tmp_path, fsdp):
    """60m at 4 layers, f32, pallas_fused: the (1, 1) mesh step's loss is
    the single-process step's (of the gather/scatter backend under FSDP)
    bit for bit; DP launches the fused kernels, FSDP the fallback."""
    from chip_smoke import parity_60m_config
    from repro_torch.config import MeshConfig, OptimConfig, TrainConfig, with_mod_backend
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.train.loop import make_train_state, make_train_step

    cfg = with_mod_backend(parity_60m_config(), "pallas_fused")
    tcfg = TrainConfig(global_batch=4, seq_len=64, optim=OptimConfig(lr=1e-3, warmup_steps=1))
    toks = torch.randint(0, cfg.vocab, (4, 65), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    ref_cfg = with_mod_backend(cfg, "pallas") if fsdp else cfg
    ref_state = make_train_state(ref_cfg, dev, params=api.init_model(cfg, device=dev, seed=0))
    _, m_ref = make_train_step(ref_cfg, tcfg)(ref_state, batch)
    with _one_rank_nccl(tmp_path) as M:
        spmd = M.mesh_ctx(MeshConfig(data=1, model=1, fsdp=fsdp))
        state = make_train_state(cfg, dev, params=api.init_model(cfg, device=dev, seed=0),
                                 spmd=spmd)
        step = make_train_step(cfg, tcfg, spmd)
        build.reset_counters()
        _, m = step(state, batch)
        counts = build.launch_counts()
    assert float(m["loss"]) == float(m_ref["loss"])
    fused = ("routed_attention", "routed_mlp_scatter")
    dispatch = ("gather_rows", "scatter_add_rows")
    on, off = (dispatch, fused) if fsdp else (fused, dispatch)
    assert all(counts[k] > 0 for k in on + ("flash_attention",)), counts
    assert not any(counts[k] for k in off), counts


# ---------------------------------------------------------------------------
# The hybrid from quantized pages; remat "selective" on the card
# ---------------------------------------------------------------------------

# zamba2-2.7b's shared block: 32 kv heads of 80, one ring per site; 18 layers
# in 3 segments (chip_smoke.py's HYBRID_QUANT_LAYERS), 8 slots of 16-token pages
HYBRID_SITES, HYBRID_NKV, HYBRID_HD = 3, 32, 80


@pytest.mark.parametrize("narrow,gran", [(torch.int8, "page"), (torch.float8_e4m3fn, "head")])
@pytest.mark.parametrize("site", range(HYBRID_SITES))
def test_paged_gather_dequant_at_the_hybrid_shapes(dev, narrow, gran, site):
    """A site's K or V ring widened from narrow pages: G 1 (page) or the
    site's 32 of the leaf's 3·32 scale columns (head), 80-byte groups."""
    F = HYBRID_NKV * HYBRID_HD
    G = 1 if gran == "page" else HYBRID_SITES * HYBRID_NKV
    pages, _ = _narrow_pages(dev, narrow, 130, 16, F, 1, 31 + site)
    g = torch.Generator(device=dev).manual_seed(32)
    scales = 2.0 ** torch.randint(-8, 4, (130, 16, G), generator=g, device=dev).float()
    cols = slice(0, 1) if gran == "page" else slice(site * HYBRID_NKV, (site + 1) * HYBRID_NKV)
    _, _, table = _paged_inputs(dev, torch.float32, 130, 1, 1, 8, 16, 33)
    table[0, -1] = 0  # an unmapped (NULL) logical page
    build.reset_counters()
    out = KP.paged_gather_dequant(pages, scales[:, :, cols], table, torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (8, 16 * 16, F)
    assert torch.equal(out, KP.paged_gather_dequant_plain(pages, scales[:, :, cols], table,
                                                          torch.bfloat16))
    assert build.launch_counts()["paged_gather_dequant"] == 1


@pytest.mark.parametrize("quant", [dict(kv="int8"), dict(kv="fp8", granularity="head"),
                                   dict(weights="int8")], ids=["int8-page", "fp8-head", "w8"])
def test_hybrid_quantized_paged_engine_on_the_card(dev, quant):
    """Smoke zamba2 (hd 80, f32) through the stepped paged engine on the
    card: the CPU engine's greedy streams; narrow KV widened by the
    dequantizing gather (k and v of every site a step) beside the plain
    gather of the positions."""
    import numpy as np

    from repro_torch.serve import EngineConfig, Request, ServingEngine
    from repro_torch.serve.quant import QuantConfig
    from repro_torch.utils import tree_map

    cfg = TC.smoke_config(TC.get_config("zamba2-2.7b"))
    cfg = dataclasses.replace(cfg, dtype="float32", attn=dataclasses.replace(cfg.attn,
                                                                             head_dim=80))
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    rng = np.random.default_rng(0)
    prompts = [rng.choice(cfg.vocab, n, replace=False) for n in (3, 10, 6, 13)]
    streams = {}
    weights = TAPI.init_model(cfg, device="cpu", seed=0)
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), weights)
        eng = ServingEngine(params, cfg, EngineConfig(batch_size=2, ctx=24, page_size=4,
                                                      quant=QuantConfig(**quant)), device=d)
        build.reset_counters()
        outs = eng.run_stream([Request(tokens=p, max_new_tokens=5) for p in prompts], 1)
        streams[str(d)] = {o.uid: o.tokens.tolist() for o in outs}
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert streams["cpu"] == streams[str(dev)]
    steps = eng.stats()["steps"]
    if "kv" in quant:
        assert counts["paged_gather_dequant"] == 2 * n_seg * steps
        assert counts["paged_gather"] == n_seg * steps
    else:
        assert counts["paged_gather_dequant"] == 0
        assert counts["paged_gather"] == 3 * n_seg * steps


def test_selective_remat_step_equals_full_on_the_card(dev):
    """Two 60m pallas_fused steps (f32): "selective" keeps the products that
    "full" recomputes; losses and grad norms equal bit for bit."""
    from chip_smoke import parity_60m_config
    from repro_torch.config import OptimConfig, TrainConfig, with_mod_backend
    from repro_torch.train.loop import make_train_state, make_train_step

    cfg = with_mod_backend(parity_60m_config(), "pallas_fused")
    tcfg = TrainConfig(global_batch=4, seq_len=64, optim=OptimConfig(lr=1e-3, warmup_steps=1))
    toks = torch.randint(0, cfg.vocab, (4, 65), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    out = {}
    for remat in ("full", "selective"):
        c = dataclasses.replace(cfg, remat=remat)
        state = make_train_state(c, dev, params=TAPI.init_model(c, device=dev, seed=0))
        step = make_train_step(c, tcfg)
        build.reset_counters()
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[remat] = (metrics, build.launch_counts())
    assert out["selective"][0] == out["full"][0]
    # the fused kernels are no products the policy sees: recomputed as under full
    for k in ("routed_attention", "routed_mlp_scatter", "flash_attention"):
        assert out["selective"][1][k] == out["full"][1][k] > 0, k
