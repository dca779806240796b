"""The port's ragged paged flash attention against the JAX package, on the
CPU.

On CPU tensors ``repro_torch.kernels.ragged.ragged_paged_flash_attention``
(re-exported as ``ops.ragged_attention_op``) runs its plain version: one
dense masked softmax per segment over the slot's pages, gathered through
the table. It is held against the Pallas kernel in interpret mode
(``repro.kernels.ops.ragged_attention_op``) and the segment-loop oracle
(``ref.ragged_attention_ref``):

- wide pages, f32 and bf16, window 0 and 5, GQA (4 query heads on 2 kv
  heads), an empty segment, query rows with position -1 inside segments,
  a segment of exactly ``seg_cap`` rows, a flat tail behind the last
  segment, and slots whose pages are shared or out of order in the table;
  f32 within 1e-6 (JAX's own tolerance for its kernel against the oracle,
  ``tests/test_ragged.py``: both sum in another order), bf16 within 2e-2
  (``p`` rounds to bf16 against the running maximum in the Pallas kernel,
  against the row's maximum here);
- int8 and e4m3 pages with pow2 scales against
  ``ref.ragged_attention_quant_ref`` and the Pallas quantized kernel,
  within 1e-5 (JAX's tolerance for its quantized kernel);
- rows behind ``row_offsets[-1]`` are exactly 0, and a query row with no
  valid key is exactly 0;
- phase 10's mixed step at a small size (decode rows, a segment whose
  keys cross key 64, an invalid tail, GQA 4 on 2, shared prefix pages) on
  wide, int8 and e4m3 pages, at the same tolerances.

What the CUDA wrapper decides before a launch is tested here too:
``ragged_attention_plan`` (path by type, fixed key chunks, one launch in
one chunk, rows per tile, grid, shared memory and scratch, refusals) and
the plan reaching the C entry point and the launch counter.

Torch runs on one thread in this module (ROADMAP Queue 3: a torch worker
thread beside XLA sometimes computes ``exp`` off by ~1e-4 relative).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
NARROW = {"int8": (jnp.int8, torch.int8, 127.0), "fp8": (jnp.float8_e4m3fn,
                                                         torch.float8_e4m3fn, 448.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def attn_case(seed=0, lens=(3, 1, 0, 5, 8), B=5, P=3, p=4, nq=4, nkv=2, hd=8, cap=8,
              tail=3, invalid=(1, 9)):
    """Inputs as numpy arrays, after ``tests/test_ragged.py::_attn_case``:
    each segment continues its own slot's cache (the cache holds its first
    ``ctx_len`` positions, the segment queries the last ``L``); the table
    maps each slot's pages in a shuffled order and slots 0 and 1 share
    their first page (a prefix page); the flat rows ``invalid`` get
    position -1."""
    rng = np.random.default_rng(seed)
    n_seg = len(lens)
    N = 2 + B * P
    k_pages = rng.standard_normal((N, p, nkv, hd)).astype(np.float32)
    v_pages = rng.standard_normal((N, p, nkv, hd)).astype(np.float32)
    table = (2 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    table[1, 0] = table[0, 0]
    pos_pages = np.full((N, p), -1, np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T = int(offs[-1]) + tail
    q = rng.standard_normal((T, nq, hd)).astype(np.float32)
    q_pos = np.full((T,), -1, np.int32)
    seg_slot = np.arange(n_seg, dtype=np.int32)
    ctx_lens = [P * p] + [int(rng.integers(max(L, 1), P * p + 1)) for L in lens[1:]]
    for s, L in enumerate(lens):
        if s == 1:  # shares slot 0's first page: its prefix is slot 0's
            for t in range(p, ctx_lens[s]):
                pos_pages[table[s, t // p], t % p] = t
        else:
            for t in range(ctx_lens[s]):
                pos_pages[table[s, t // p], t % p] = t
        q_pos[offs[s]: offs[s + 1]] = np.arange(ctx_lens[s] - L, ctx_lens[s])
    q_pos[list(invalid)] = -1
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages, table=table,
                row_offsets=offs, seg_slot=seg_slot, q_pos=q_pos), cap


ORDER = ("q", "k_pages", "v_pages", "pos_pages", "table", "row_offsets", "seg_slot", "q_pos")


def _run(case, jdt, tdt, **kw):
    jargs = [jnp.asarray(case[n], jdt if n in ("q", "k_pages", "v_pages") else None)
             for n in ORDER]
    targs = [torch.as_tensor(case[n]).to(tdt) if n in ("q", "k_pages", "v_pages")
             else torch.as_tensor(case[n]) for n in ORDER]
    return jargs, targs


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ragged_attention_plain_matches_pallas_and_oracle(dt, window):
    case, cap = attn_case()
    jargs, targs = _run(case, JDT[dt], TDT[dt])
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, window=window)
    assert got.dtype == TDT[dt] and got.shape == case["q"].shape
    pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, window=window, interpret=True)
    oracle = JREF.ragged_attention_ref(*jargs, window=window)
    tol = 1e-6 if dt == "f32" else 2e-2
    g = got.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol, atol=tol)
    end = int(case["row_offsets"][-1])
    assert (g[end:] == 0).all() and end < g.shape[0]
    assert (g[list((1, 9))] == 0).all()  # rows with position -1: no valid key


def test_ragged_attention_without_causality_and_with_a_scale():
    case, cap = attn_case(seed=3)
    jargs, targs = _run(case, jnp.float32, torch.float32)
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, causal=False, scale=0.3)
    want = JOPS.ragged_attention_op(*jargs, seg_cap=cap, causal=False, scale=0.3, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_ragged_attention_narrow_pages_match_the_quantized_oracle(kind):
    jdt, tdt, qmax = NARROW[kind]
    case, cap = attn_case(seed=6)
    rng = np.random.default_rng(6)
    N, p, nkv, hd = case["k_pages"].shape
    narrow, scales = {}, {}
    for name in ("k_pages", "v_pages"):
        vals = rng.integers(-127, 128, size=(N, p, nkv, hd)).astype(np.float32)
        if kind == "fp8":
            vals = vals * 3.5  # e4m3 rounds these; both sides read the same bytes
        narrow[name] = jnp.asarray(vals, jdt)
        scales[name] = np.asarray(JREF.pow2_scale_ref(rng.uniform(0.05, 2.0, (N, p, nkv)), qmax),
                                  np.float32)
    jargs = [narrow.get(n, jnp.asarray(case[n])) for n in ORDER]
    targs = [torch.as_tensor(np.array(narrow[n].astype(jnp.float32))).to(tdt)
             if n in narrow else torch.as_tensor(case[n]) for n in ORDER]
    jks, jvs = jnp.asarray(scales["k_pages"]), jnp.asarray(scales["v_pages"])
    tks, tvs = torch.as_tensor(scales["k_pages"]), torch.as_tensor(scales["v_pages"])
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, k_scales=tks, v_scales=tvs).numpy()
    oracle = JREF.ragged_attention_quant_ref(jargs[0], jargs[1], jks, jargs[2], jvs, *jargs[3:])
    pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, interpret=True, k_scales=jks,
                                      v_scales=jvs)
    for want in (oracle, pallas):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[int(case["row_offsets"][-1]):] == 0).all()


def test_ragged_attention_no_segments_and_all_empty():
    case, cap = attn_case(lens=(0, 0), tail=4, invalid=())
    _, targs = _run(case, jnp.float32, torch.float32)
    got = KRG.ragged_paged_flash_attention(*targs, seg_cap=cap)
    assert (got == 0).all() and got.shape == case["q"].shape


def test_ragged_attention_refuses_what_it_does_not_take():
    case, cap = attn_case()
    _, targs = _run(case, jnp.float32, torch.float32)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_paged_flash_attention(targs[0].clone().requires_grad_(True), *targs[1:],
                                         seg_cap=cap)
    with pytest.raises(TypeError, match="int32"):
        KRG.ragged_paged_flash_attention(*targs[:4], targs[4].long(), *targs[5:], seg_cap=cap)
    with pytest.raises(TypeError, match="wide pages"):
        KRG.ragged_paged_flash_attention(targs[0].bfloat16(), *targs[1:], seg_cap=cap)
    with pytest.raises(ValueError, match="k_scales"):
        KRG.ragged_paged_flash_attention(*targs, seg_cap=cap,
                                         k_scales=torch.ones(case["pos_pages"].shape))
    with pytest.raises(ValueError, match="seg_cap"):
        KRG.ragged_paged_flash_attention(*targs, seg_cap=0)


def mixed_case(seed=0, B=3, P=12, p=8, nq=4, nkv=2, hd=8, prefill=20, tail=4, shared=2):
    """Phase 10's mixed step at a small size, as numpy arrays: ``B`` slots
    whose first ``shared`` pages are one prefix run, slot b holding
    positions [0, n_b) with n_b > 64 (its pages shuffled, NULL past its
    length); one decode row per slot at n_b - 1, a ``prefill``-row segment
    re-reading slot 0's last positions (its keys cross key 64), then
    ``tail`` rows at position -1."""
    rng = np.random.default_rng(seed)
    N = 2 + B * P
    n = rng.integers(65, P * p + 1, B)
    table = (2 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    table[:, :shared] = table[0, :shared]
    table[np.arange(P)[None] * p >= n[:, None]] = 0
    pos_pages = np.full((N, p), -1, np.int32)
    for b in range(B):
        for t in range(n[b]):
            pos_pages[table[b, t // p], t % p] = t
    q_pos = np.concatenate([n - 1, np.arange(n[0] - prefill, n[0]), np.full(tail, -1)])
    offs = np.asarray(list(range(B + 1)) + [B + prefill], np.int32)
    seg_slot = np.asarray(list(range(B)) + [0], np.int32)
    return dict(q=rng.standard_normal((len(q_pos), nq, hd)).astype(np.float32),
                k_pages=rng.standard_normal((N, p, nkv, hd)).astype(np.float32),
                v_pages=rng.standard_normal((N, p, nkv, hd)).astype(np.float32),
                pos_pages=pos_pages, table=table, row_offsets=offs, seg_slot=seg_slot,
                q_pos=q_pos.astype(np.int32)), prefill


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "fp8"])
def test_ragged_attention_mixed_step_matches_pallas(kind):
    """The plain version the kernel is held to on the card, against the
    Pallas kernel in interpret mode and the oracles, on phase 10's mixed
    step at a small size."""
    case, cap = mixed_case(seed=4)
    if kind in ("f32", "bf16"):
        jargs, targs = _run(case, JDT[kind], TDT[kind])
        got = TOPS.ragged_attention_op(*targs, seg_cap=cap).float().numpy()
        pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, interpret=True)
        oracle = JREF.ragged_attention_ref(*jargs)
        tol = 1e-6 if kind == "f32" else 2e-2
    else:
        jdt, tdt, qmax = NARROW[kind]
        rng = np.random.default_rng(5)
        N, p, nkv, hd = case["k_pages"].shape
        narrow = {name: jnp.asarray(rng.integers(-127, 128, (N, p, nkv, hd)).astype(np.float32)
                                    * (3.5 if kind == "fp8" else 1.0), jdt)
                  for name in ("k_pages", "v_pages")}
        scales = [np.asarray(JREF.pow2_scale_ref(rng.uniform(0.05, 2.0, (N, p, nkv)), qmax),
                             np.float32) for _ in range(2)]
        jargs = [narrow.get(n, jnp.asarray(case[n])) for n in ORDER]
        targs = [torch.as_tensor(np.array(narrow[n].astype(jnp.float32))).to(tdt)
                 if n in narrow else torch.as_tensor(case[n]) for n in ORDER]
        jks, jvs = (jnp.asarray(x) for x in scales)
        got = TOPS.ragged_attention_op(*targs, seg_cap=cap, k_scales=torch.as_tensor(scales[0]),
                                       v_scales=torch.as_tensor(scales[1])).numpy()
        pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, interpret=True, k_scales=jks,
                                          v_scales=jvs)
        oracle = JREF.ragged_attention_quant_ref(jargs[0], jargs[1], jks, jargs[2], jvs,
                                                 *jargs[3:])
        tol = 1e-5
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)
    end = int(case["row_offsets"][-1])
    assert (got[end:] == 0).all() and np.abs(got[:end]).max() > 0.1


# ---------------------------------------------------------------------------
# ragged_attention_plan: how the CUDA kernel runs a call, before launch
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# phase 10's calls: 8 slots of 62 pages of 16 rows, 498 pages, mod-paper-1b's 14x128
DECODE = dict(T=8, nq=14, nkv=14, hd=128, N=498, p=16, B=8, P=62, n_seg=8, seg_cap=1)
MIXED = dict(DECODE, T=272, n_seg=9, seg_cap=256)


def _plan(q=BF16, kv=BF16, **kw):
    return KRG.ragged_attention_plan(**{**DECODE, **kw}, q_dtype=q, kv_dtype=kv)


@pytest.mark.parametrize("q,kv,path", [
    (BF16, BF16, "mma"), (BF16, torch.int8, "mma"), (BF16, torch.float8_e4m3fn, "mma"),
    (F32, F32, "f32"), (F32, torch.int8, "f32"), (F32, torch.float8_e4m3fn, "f32")])
def test_ragged_attention_plan_picks_the_path_by_type(q, kv, path):
    assert _plan(q, kv).path == path


@pytest.mark.parametrize("hd,chunk", [(32, 128), (64, 128), (128, 128), (256, 64)])
def test_ragged_attention_plan_splits_by_a_fixed_chunk(hd, chunk):
    """The chunk is two key tiles, set by the head dim alone: not by the
    rows, the pool, the batch or the grid; the chunks cover P*p keys."""
    plans = [_plan(hd=hd, T=T, N=N, B=B, P=P, n_seg=n_seg, seg_cap=cap)
             for T, N, B, P, n_seg, cap in ((8, 498, 8, 62, 8, 1), (272, 498, 8, 62, 9, 256),
                                            (3, 40, 2, 7, 1, 3), (9, 2000, 1, 500, 3, 7))]
    for plan, P in zip(plans, (62, 62, 7, 500)):
        assert (plan.key_tile, plan.chunk) == (chunk // 2, chunk)
        assert plan.n_chunks == -(-(P * 16) // chunk)


@pytest.mark.parametrize("P,kernels", [(4, 1), (8, 1), (9, 2), (62, 2)])
def test_ragged_attention_plan_one_launch_when_the_keys_fit_one_chunk(P, kernels):
    """P*p <= 128 keys: one launch writes the output (its grid has a
    zero-row plane, no scratch); past it a merge launch and its f32
    scratch (n_chunks, T, nq) twice and (n_chunks, T, nq, hd)."""
    plan = _plan(P=P)
    assert plan.kernels == kernels and plan.merge == (kernels == 2)
    n = plan.n_chunks
    if kernels == 1:
        assert n == 1 and plan.scratch == () and plan.grid[2] == 2
    else:
        assert plan.scratch == ((n, 8, 14), (n, 8, 14), (n, 8, 14, 128))
        assert plan.grid[2] == 1


@pytest.mark.parametrize("call,q,kv,want", [
    (DECODE, BF16, BF16, (16, (8 * 8, 14, 1), 70720)),
    (DECODE, BF16, torch.int8, (16, (8 * 8, 14, 1), 71744)),
    # 9 segments of seg_cap 256 in T = 272 rows: 13 tiles of 64, not 9 x 4
    (MIXED, BF16, BF16, (64, (13 * 8, 14, 1), 70912)),
    (MIXED, BF16, torch.float8_e4m3fn, (64, (13 * 8, 14, 1), 71936)),
    (dict(MIXED, nkv=2, hd=256), BF16, BF16, (64, (38 * 16, 2, 1), 68352)),
    (dict(DECODE, nq=16, nkv=1, hd=64), BF16, BF16, (16, (8 * 8, 1, 1), 37952)),
    (dict(DECODE, nq=16, nkv=1, hd=64, seg_cap=2), BF16, BF16, (64, (8 * 8, 1, 1), 38144)),
    (dict(DECODE, P=4), BF16, BF16, (16, (8, 14, 2), 70720)),
    (MIXED, F32, F32, (16, (16, 14, 10), 40960)),
    (dict(MIXED, hd=256), F32, torch.int8, (8, (32, 14, 10), 40960)),
])
def test_ragged_attention_plan_rows_grid_and_shared_memory(call, q, kv, want):
    """Rows per tile: one m16 tile when seg_cap x group fits it (a decode
    row of up to 16 query heads), else 64; grid (tile-list entries x
    chunks, kv heads, 1 or, in one launch, 2): at most seg_cap's tiles a
    segment and at most one partial tile a segment past T rows' worth;
    shared memory: two stages of K and V tiles in bf16 rows of hd + 8
    (Q stays in global memory and registers), the chunk's positions, page
    rows and (narrow) scales, the rows' positions. f32: the CUDA-core kernel's (tiles of 16 query
    rows, 8 at head dim 256; query heads, segments + the zero rows)."""
    plan = KRG.ragged_attention_plan(**call, q_dtype=q, kv_dtype=kv)
    assert (plan.rows, plan.grid, plan.smem) == want


@pytest.mark.parametrize("kw,err", [
    (dict(hd=48), ValueError), (dict(hd=512), ValueError), (dict(nq=14, nkv=4), ValueError),
    (dict(q=F32, kv=F32, n_seg=70000), ValueError), (dict(nq=70000, nkv=70000), ValueError),
    (dict(T=2 ** 26, n_seg=2 ** 26, P=2 ** 16), ValueError),
    (dict(seg_cap=2 ** 30, nq=28), ValueError), (dict(T=0), ValueError), (dict(P=0), ValueError),
    (dict(q=BF16, kv=F32), TypeError), (dict(q=F32, kv=BF16), TypeError),
    (dict(q=torch.float16, kv=torch.float16), TypeError)])
def test_ragged_attention_plan_refuses_what_the_kernel_does_not_take(kw, err):
    """Head dims outside 32/64/128/256, a group that does not divide, grids
    past CUDA's limits (65535 kv heads, or segments on the f32 path; 2^31 - 1
    blocks), no rows or pages, and pages that are not q's type or narrow."""
    with pytest.raises(err):
        _plan(**kw)


class _FakeEntry:
    """Stands in for the C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("P,kv", [(3, None), (40, None), (40, "int8")])
def test_ragged_attention_passes_its_plan_to_the_entry_point(monkeypatch, P, kv):
    """The plan ragged_attention_plan makes is what the C entry point gets
    (path code, rows, key tile, chunk, chunks, grid, shared memory), with
    scratch pointers exactly when the chunks merge, and the launch counter
    records it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(KRG.build, "bind", lambda *a: entry)
    monkeypatch.setattr(KRG.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    case, cap = attn_case(P=P, hd=32)
    _, targs = _run(case, jnp.bfloat16, torch.bfloat16)
    scales = {}
    if kv == "int8":
        targs[1:3] = [t.to(torch.int8) for t in targs[1:3]]
        scales = {name: torch.ones(targs[1].shape[:3]) for name in ("k_scales", "v_scales")}
    T, nq, hd = targs[0].shape
    N, p, nkv, _ = targs[1].shape
    plan = KRG.ragged_attention_plan(T, nq, nkv, hd, N, p, 5, P, 5, cap, torch.bfloat16,
                                     targs[1].dtype)
    KRG.build.reset_counters()
    out = KRG._attention_launch(*targs, scales.get("k_scales"), scales.get("v_scales"),
                                torch.empty_like(targs[0]), cap, True, 0, 0.5)
    assert out.shape == targs[0].shape
    assert all(a is not None for a in entry.args[11:14]) == plan.merge
    assert all(a is None for a in entry.args[11:14]) == (not plan.merge)
    # (..., n_rows, nq, nkv, hd, N, p, B, P, n_seg, seg_cap, q_dtype, kv_kind, path, rows,
    # key_tile, chunk, n_chunks, grid x, y, z, smem, scale, causal, window, stream)
    assert entry.args[14:35] == (T, nq, nkv, hd, N, p, 5, P, 5, cap, 1,
                                 2 if kv else 1, 1, plan.rows, plan.key_tile, plan.chunk,
                                 plan.n_chunks, *plan.grid, plan.smem)
    assert KRG.RAGGED_PAGED_FLASH_ATTENTION.by_call == {
        ("mma", T, 5, cap, nq, nkv, hd, kv or "bf16", plan.n_chunks, plan.kernels): 1}
    KRG.build.reset_counters()
