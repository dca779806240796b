"""The port's quantized paged-KV serving path against the JAX package, on
the CPU.

- Quant math (``repro_torch.serve.quant``): pow2 scales, row
  quantize/dequantize, the leaf round trip and the weight quantization are
  the JAX functions' bits: int8 and e4m3fn bytes compared through a uint8
  view, f32 values through their bit patterns; a second round trip changes
  no bit.
- Kernels: the plain version of the dequantizing gather (what the wrapper
  runs for CPU tensors) equals the Pallas kernel in interpret mode and the
  XLA reference, bit for bit; the quantizing decode scatter and ragged
  write-back equal the JAX ops with ``scales``, on the narrow pages and
  on the scales, for one leaf and for the layers of one stacked leaf.
- Engine: the port's quantized paged (chunked prefill), prefix-cached and
  ragged engines give the JAX engine's greedy streams, with equal steps,
  prefill tokens, prefix hit rate and ``kv_bytes``, for int8/page and
  fp8/head KV and for int8 weights; the unquantized twin stays within the
  JAX package's drift bound; config validation and the CLI flags.

The JAX engine runs ``paged_backend="xla"`` (its ``pallas`` variant is held
bit-identical to it by ``tests/test_quant.py``).
"""
import argparse
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import paged as JPG  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro_torch.kernels import paged as KP  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine, add_engine_args  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.cache import NULL_PAGE, SCRATCH_PAGE, PagedCachePool, flatten  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.test_torch_paged import model_pair, shared_prefix_prompts  # noqa: E402

KINDS = ["int8", "fp8"]
QMAX_INT8 = 127.0
GRANS = ["page", "head"]
TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _bits(a):
    """Bit pattern of a JAX array or torch tensor, as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.element_size() == 1:
            return a.view(torch.uint8).numpy()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.uint32 if a.element_size() == 4 else np.uint64)
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    if a.dtype.itemsize == 2:
        return a.view(np.int16)
    return a.view(np.uint32)


def _assert_bits(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _qcs(kind, gran="page", weights="none"):
    return (TQ.QuantConfig(kv=kind, granularity=gran, weights=weights),
            JQ.QuantConfig(kv=kind, granularity=gran, weights=weights))


# ---------------------------------------------------------------------------
# Quant math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qmax", [127.0, 448.0])
def test_pow2_scale_matches_jax_bitwise(qmax):
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        np.float32([0.0, 1.0, 127.0, 448.0, 0.5, 2.0, 2.0 ** -126, 2.0 ** 100]),
        (2.0 ** rng.integers(-149, 128, 64)).astype(np.float32),  # exact powers of two
        np.float32([1e-42, 1e-40, 5e-39, 1e-45, 3e-38]),  # ratios below the normal range
        # near the top of the f32 range, and inf (the only absmax above qmax·2^127)
        np.float32([3.4e38, 3.0e38, np.inf]),
        rng.uniform(1e-6, 1e4, 256).astype(np.float32),
    ])
    got = TQ.pow2_scale(torch.from_numpy(vals), qmax)
    want = JQ.pow2_scale(jnp.asarray(vals), qmax)
    _assert_bits(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_dequant_rows_match_jax_and_are_idempotent(kind, gran):
    tq, jq = _qcs(kind, gran)
    x = (np.random.default_rng(1).standard_normal((5, 3, 16)) * 3.0).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1.0
    G = 1 if gran == "page" else 4
    q, s = TQ.quantize_rows(torch.from_numpy(x), G, tq)
    jqv, js = JQ.quantize_rows(jnp.asarray(x), G, jq)
    assert q.dtype == TDT[kind] and s.dtype == torch.float32
    _assert_bits(q, jqv)
    _assert_bits(s, js)
    rt = TQ.dequant_rows(q, s)
    _assert_bits(rt, JQ.dequant_rows(jqv, js))
    # a second round trip reproduces the values bit for bit
    q2, s2 = TQ.quantize_rows(rt, G, tq)
    _assert_bits(TQ.dequant_rows(q2, s2), rt)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_leaf_matches_jax(kind, gran, masked):
    """Port layout (B, ctx, nkv, hd), batch axis 0, and the stacked layout
    of the JAX cache leaves (L, B, ctx, nkv, hd), batch axis 1."""
    tq, jq = _qcs(kind, gran)
    rng = np.random.default_rng(2)
    for shape, ax in (((3, 8, 2, 4), 0), ((2, 3, 8, 2, 4), 1)):
        x = (rng.standard_normal(shape) * 4.0).astype(np.float32)
        mask = rng.integers(0, 2, size=(3, 8)).astype(bool) if masked else None
        got = TQ.roundtrip_leaf(torch.from_numpy(x), ax, tq,
                                mask=None if mask is None else torch.from_numpy(mask))
        want = JQ.roundtrip_leaf(jnp.asarray(x), ax, jq,
                                 mask=None if mask is None else jnp.asarray(mask))
        _assert_bits(got, want)
        again = TQ.roundtrip_leaf(got, ax, tq)
        _assert_bits(TQ.roundtrip_leaf(again, ax, tq), again)
    assert TQ.leaf_groups((2, 3, 8, 2, 4), tq, 1) == JQ.leaf_groups((2, 3, 8, 2, 4), jq, 1)


def _subnormal_rows(qmax):
    """Rows whose scale is the smallest normal power of two, 2^-126 (absmax
    qmax·2^-126), with subnormal elements beside it: XLA flushes those to
    zero before it divides, so the JAX package quantizes them to 0 (a
    divide without the flush gives 1 / -1 in int8, 0.9375 / -0.5 in e4m3).
    Columns 0-7 and 8-15 are the two head blocks of the per-head case."""
    x = np.zeros((3, 16), np.float32)
    x[:, 0] = x[:, 8] = np.float32(qmax * 2.0 ** -126)
    x[:, 1], x[:, 2] = np.float32(1.1e-38), np.float32(-6e-39)
    x[:, 9], x[:, 10], x[:, 11] = np.float32(5e-39), np.float32(-1e-45), np.float32(-1e-40)
    x[1] *= np.float32(-1.0)
    x[2, 4] = np.float32(2.0 ** -126)  # the smallest normal itself is kept
    return x


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", KINDS)
def test_subnormal_elements_quantize_as_jax_flushes_them(kind, gran):
    """Bit for bit against the JAX functions on subnormal elements:
    quant_rows at scale 2^-126, quantize_rows, dequant_rows and the leaf
    round trip (page and head granularity)."""
    tq, jq = _qcs(kind, gran)
    x = _subnormal_rows(TQ.QMAX[kind])
    s = np.full((3, 1), 2.0 ** -126, np.float32)
    got = TQ.quant_rows(torch.from_numpy(x), torch.from_numpy(s), tq)
    _assert_bits(got, JQ.quant_rows(jnp.asarray(x), jnp.asarray(s), jq))
    assert not got[:, [1, 2, 9, 10, 11]].float().any()
    G = 1 if gran == "page" else 2
    q, sc = TQ.quantize_rows(torch.from_numpy(x), G, tq)
    jqv, js = JQ.quantize_rows(jnp.asarray(x), G, jq)
    _assert_bits(sc, js)
    _assert_bits(q, jqv)
    _assert_bits(TQ.dequant_rows(q, sc), JQ.dequant_rows(jqv, js))
    leaf = x.reshape(1, 3, 2, 8)  # (B, ctx, nkv, hd)
    _assert_bits(TQ.roundtrip_leaf(torch.from_numpy(leaf), 0, tq),
                 JQ.roundtrip_leaf(jnp.asarray(leaf), 0, jq))


def test_subnormal_weights_quantize_as_jax_flushes_them():
    """int8 weights: a leaf whose scale is 2^-126 holds subnormal elements;
    the narrow bytes, the scale and the widened leaf are JAX's."""
    w = _subnormal_rows(QMAX_INT8)
    tq = TQ.quantize_params({"w": torch.from_numpy(w)})
    jqp = JQ.quantize_params({"w": jnp.asarray(w)})
    _assert_bits(tq["w"]["__q8__"], jqp["w"]["__q8__"])
    _assert_bits(tq["w"]["__scale__"], jqp["w"]["__scale__"])
    _assert_bits(TQ.dequantize_params(tq)["w"], JQ.dequantize_params(jqp)["w"])
    assert not tq["w"]["__q8__"][:, [1, 2, 9, 10, 11]].any()


@pytest.mark.parametrize("mod", [True, False])
def test_weight_quantization_matches_jax(mod):
    """quantize_params on the port's per-group tree gives the JAX stacked
    tree's scales (one per stacked leaf) and bytes; the widened tree is
    the JAX one, and a second round trip changes no bit."""
    _, jp, _, tp = model_pair(mod)
    tq = TQ.quantize_params(tp)
    jqp = JQ.quantize_params(jp)
    jwide = from_jax_params(JQ.dequantize_params(jqp), device="cpu")
    twide = TQ.dequantize_params(tq)
    tl, jl = tree_leaves(twide), tree_leaves(jwide)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        _assert_bits(a, b)
    # the int8 bytes and scales of one stacked leaf, layer by layer
    jwq = jqp["groups"]["full"]["attn"]["wq"]
    for g, grp in enumerate(tq["groups"]):
        leaf = grp["full"]["attn"]["wq"]
        _assert_bits(leaf["__q8__"], jwq["__q8__"][g])
        _assert_bits(leaf["__scale__"], jwq["__scale__"])
    again = TQ.dequantize_params(TQ.quantize_params(twide))
    for a, b in zip(tree_leaves(again), tl):
        _assert_bits(a, b)
    assert TQ.dequantize_params(tp) is not tp  # always a fresh tree
    assert tree_leaves(TQ.dequantize_params(tp))[0] is tree_leaves(tp)[0]


# ---------------------------------------------------------------------------
# Kernels: dequantizing gather, quantizing scatters
# ---------------------------------------------------------------------------


def _narrow_pages(kind, N, p, F, G, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, p, F)) * rng.uniform(0.01, 50, (N, p, 1))).astype(np.float32)
    tq, jq = _qcs(kind)
    q, s = TQ.quantize_rows(torch.from_numpy(x), G, tq)
    jqv, js = JQ.quantize_rows(jnp.asarray(x), G, jq)
    _assert_bits(q, jqv)
    return q, s, jqv, js


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_dequant_gather_plain_matches_pallas_and_xla(kind, G, out):
    N, p, F, B, P = 9, 4, 8, 3, 3
    q, s, jqv, js = _narrow_pages(kind, N, p, F, G)
    table = np.asarray([[2, 5, NULL_PAGE], [5, 5, 8], [7, SCRATCH_PAGE, 3]], np.int32)
    jt = jnp.asarray(table)
    pallas = JPG.paged_gather_dequant_pallas(jqv, js, jt, interpret=True)
    xla = JPG.paged_gather_dequant_xla(jqv, js, jt)
    _assert_bits(pallas, xla)
    odt = getattr(torch, out)
    got = KP.paged_gather_dequant(q, s, torch.from_numpy(table), odt)
    assert got.shape == (B, P * p, F) and got.dtype == odt
    _assert_bits(got, pallas.astype(getattr(jnp, out)))
    # the ops-level wrapper (JAX: cast to out_dtype) on a leaf with a tail
    leaf = q.view(N, p, 2, F // 2)
    got_op = KP.paged_gather_op(leaf, torch.from_numpy(table), scales=s, out_dtype=odt)
    want_op = JOPS.paged_gather_op(jqv.reshape(N, p, 2, F // 2), jt, scales=js,
                                   backend="pallas", interpret=True,
                                   out_dtype=getattr(jnp, out))
    assert got_op.shape == (B, P * p, 2, F // 2)
    _assert_bits(got_op, want_op)


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_gather_of_stacked_leaf_layers(kind):
    """The layers of one JAX stacked leaf share a scale tensor; each layer's
    gather reads its columns (a strided view) and gives that layer's slice
    of the JAX lead-dim gather."""
    tq, jq = _qcs(kind, "head")
    rng = np.random.default_rng(5)
    L, N, p, nkv, hd, B, P = 2, 7, 4, 2, 4, 3, 2
    x = (rng.standard_normal((L, N, p, nkv, hd)) * 3).astype(np.float32)
    G = JQ.leaf_groups((L, N, p, nkv, hd), jq, 1)
    canon = np.moveaxis(x, 0, 2).reshape(N, p, -1)  # layer-major fold
    jqv, js = JQ.quantize_rows(jnp.asarray(canon), G, jq)
    jpages = jnp.moveaxis(jqv.reshape(N, p, L, nkv, hd), 2, 0)
    table = jnp.asarray(rng.integers(0, N, size=(B, P)), jnp.int32)
    want = JOPS.paged_gather_op(jpages, table, page_axis=1, scales=js, backend="pallas",
                                interpret=True)  # (L, B, P*p, nkv, hd)
    tpages, ts = TQ.quantize_rows(torch.from_numpy(canon), G, tq)
    _assert_bits(ts, js)
    layers = tpages.view(N, p, L, nkv, hd).permute(2, 0, 1, 3, 4).contiguous()
    for layer in range(L):
        got = KP.paged_gather_op(layers[layer], torch.from_numpy(np.array(table)),
                                 scales=ts[:, :, layer * nkv:(layer + 1) * nkv])
        _assert_bits(got, want[layer])


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantizing_decode_scatter_matches_jax(kind, gran):
    tq, jq = _qcs(kind, gran)
    rng = np.random.default_rng(6)
    L, N, p, nkv, hd, B = 2, 7, 4, 2, 4, 3
    table = np.asarray([[2, 3], [4, 5], [6, 0]], np.int32)
    pos = np.asarray([1, 7, 2], np.int32)
    rows = (rng.standard_normal((L, B, nkv, hd)) * 3).astype(np.float32)
    G1 = JQ.leaf_groups((B, 8, nkv, hd), jq, 0)
    GL = JQ.leaf_groups((L, B, 8, nkv, hd), jq, 1)
    # one leaf
    jpages = jnp.zeros((N, p, nkv, hd), JDT[kind])
    jsc = jnp.ones((N, p, G1), jnp.float32)
    jnp_, jns = JOPS.paged_scatter_rows_op(jpages, jnp.asarray(table), jnp.asarray(rows[0]),
                                           jnp.asarray(pos), backend="pallas", interpret=True,
                                           scales=jsc, quant=jq)
    tpages = torch.zeros((N, p, nkv, hd), dtype=TDT[kind])
    tsc = torch.ones((N, p, G1))
    KP.paged_scatter_rows_op([tpages], torch.from_numpy(table), [torch.from_numpy(rows[0])],
                             torch.from_numpy(pos), scales=tsc, quant=tq)
    _assert_bits(tpages, jnp_)
    _assert_bits(tsc, jns)
    # the layers of one stacked leaf (JAX lead dim, page_axis 1)
    jnp_, jns = JOPS.paged_scatter_rows_op(
        jnp.zeros((L, N, p, nkv, hd), JDT[kind]), jnp.asarray(table), jnp.asarray(rows),
        jnp.asarray(pos), page_axis=1, backend="xla", scales=jnp.ones((N, p, GL)), quant=jq)
    tl = [torch.zeros((N, p, nkv, hd), dtype=TDT[kind]) for _ in range(L)]
    tsc = torch.ones((N, p, GL))
    KP.paged_scatter_rows_op(tl, torch.from_numpy(table), [torch.from_numpy(r) for r in rows],
                             torch.from_numpy(pos), scales=tsc, quant=tq)
    for layer in range(L):
        _assert_bits(tl[layer], jnp_[layer])
    _assert_bits(tsc, jns)


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", KINDS)
def test_quantizing_ragged_writeback_matches_jax(kind, gran):
    tq, jq = _qcs(kind, gran)
    rng = np.random.default_rng(7)
    L, N, p, nkv, hd, W = 2, 10, 4, 2, 4, 9
    table = np.asarray([[2, 3, 4], [5, 6, NULL_PAGE], [7, 8, 9]], np.int32)
    slot = np.asarray([0, 1, 2, 0, 0, 2, 2, 1, 1], np.int32)
    pos = np.asarray([0, 5, 11, 4, 9, 1, 2, 3, 6], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0, 1, 1, 0, 1], bool)
    rows = (rng.standard_normal((L, W, nkv, hd)) * 3).astype(np.float32)
    GL = JQ.leaf_groups((L, 3, 12, nkv, hd), jq, 1)
    jnp_, jns = JOPS.ragged_paged_scatter_rows_op(
        jnp.zeros((L, N, p, nkv, hd), JDT[kind]), jnp.asarray(table), jnp.asarray(rows),
        jnp.asarray(slot), jnp.asarray(pos), jnp.asarray(valid), page_axis=1, backend="pallas",
        dump_page=SCRATCH_PAGE, interpret=True, scales=jnp.ones((N, p, GL)), quant=jq)
    pid, off = KRG.ragged_page_targets(torch.from_numpy(table), torch.from_numpy(slot),
                                       torch.from_numpy(pos), torch.from_numpy(valid), p,
                                       SCRATCH_PAGE)
    tl = [torch.zeros((N, p, nkv, hd), dtype=TDT[kind]) for _ in range(L)]
    tsc = torch.ones((N, p, GL))
    KRG.ragged_paged_scatter_rows_op(tl, pid, off, [torch.from_numpy(r) for r in rows],
                                     scales=tsc, quant=tq)
    keep = np.ones(N, bool)
    keep[SCRATCH_PAGE] = False  # the invalid rows collide there: garbage by contract
    for layer in range(L):
        np.testing.assert_array_equal(_bits(tl[layer])[keep], _bits(jnp_[layer])[keep])
    np.testing.assert_array_equal(_bits(tsc)[keep], _bits(jns)[keep])


def test_pool_quant_layout_and_scrub():
    """Narrow K/V pages, exact int32 positions, one scale tensor per JAX
    leaf (here groups/full/k and groups/full/v), scales back to 1.0 and
    pages back to narrow zeros on recycle."""
    tc = model_pair(mod=True)[2]
    pool = PagedCachePool(tc, 2, 16, 4, torch.device("cpu"), n_pages=3,
                          quant=TQ.QuantConfig(kv="fp8", granularity="head"))
    kinds = {p.dtype for p in pool.pages}
    assert kinds == {torch.float8_e4m3fn, torch.int32}
    nkv = tc.attn.n_kv_heads
    n_groups = len(pool.spec.qleaves[0].js)
    assert [s.shape for s in pool.scales] == [(3, 4, n_groups * nkv)] * 2
    pool.acquire(0)
    assert pool.alloc_pages(0, 4)
    pid = int(pool.table_np[0, 0])
    for pages in pool.pages:
        pages.view(torch.uint8)[pid] = 7
    for s in pool.scales:
        s[pid] = 4.0
    pool.release(0)
    pool.acquire(0)
    assert pool.alloc_pages(0, 4) and int(pool.table_np[0, 0]) == pid
    for pages, tmpl in zip(pool.pages, pool._tmpl_pages):
        np.testing.assert_array_equal(_bits(pages[pid]), _bits(tmpl))
    assert all(bool((s[pid] == 1.0).all()) for s in pool.scales)
    work = pool.read_slot(0)  # widens back to the template: zeros, positions -1
    for i in pool._paged_ids:
        leaf = flatten(work)[i]
        assert bool((leaf == (-1 if leaf.dtype == torch.int32 else 0)).all())


# ---------------------------------------------------------------------------
# Engine streams against the JAX engine
# ---------------------------------------------------------------------------

ENGINES = {
    "paged": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4),
    "prefix": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4, prefix_cache=True),
    "ragged": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4, ragged=True,
                   ragged_segments=2),
}


def _run_both(prompts, news, arrival_every, quant, **engine):
    jc, jp, tc, tp = model_pair(engine.pop("mod", True))
    tq, jq = quant
    teng = ServingEngine(tp, tc, EngineConfig(quant=tq, **engine), device="cpu")
    touts = teng.run_stream([Request(tokens=p, max_new_tokens=n) for p, n in zip(prompts, news)],
                            arrival_every)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(quant=jq, **engine))
    jouts = jeng.run_stream([JRequest(tokens=np.asarray(p, np.int32), max_new_tokens=n)
                             for p, n in zip(prompts, news)], arrival_every)
    return ({o.uid: o.full_sequence.tolist() for o in touts}, teng,
            {o.uid: o.full_sequence.tolist() for o in jouts}, jeng)


@pytest.mark.parametrize("mode", [("int8", "page", "none"), ("fp8", "head", "none"),
                                  ("int8", "head", "int8")],
                         ids=["int8-page", "fp8-head", "int8-weights"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_quantized_streams_equal_jax_engine(kind, mode):
    """Staggered arrivals (one per step) into 2 slots: the ragged engine
    mixes prefill segments with decode rows; the prefix engine restores
    quantized shared pages and their scales."""
    prompts = shared_prefix_prompts()
    t, teng, j, jeng = _run_both(prompts, [5, 3, 6, 4, 5], 1, _qcs(*mode), **ENGINES[kind])
    assert t == j
    ts, js = teng.stats(), jeng.stats()
    for key in ("steps", "prefill_tokens_computed", "prefix_hit_rate", "kv_bytes", "resid_bytes",
                "quant_kv", "page_utilization_peak", "preemptions"):
        assert ts[key] == js[key], key
    assert (ts["prefix_hit_rate"] > 0) == (kind == "prefix")
    assert ts["pages_in_use"] == 0.0


def test_quantized_prefix_warm_restore_equals_cold():
    """Prefix hits restore quantized pages and their scales: warm streams
    equal cold ones while prefill compute drops."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 97, size=8)
    prompts = [np.concatenate([shared, rng.integers(0, 97, size=3)]) for _ in range(4)]
    _, _, tc, tp = model_pair(True)
    outs, engines = {}, {}
    for prefix in (False, True):
        eng = ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=24, page_size=4,
                                                 prefill_chunk=4, prefix_cache=prefix,
                                                 quant=TQ.QuantConfig(kv="int8")), device="cpu")
        outs[prefix] = {o.uid: o.full_sequence.tolist()
                        for o in eng.run_stream([Request(tokens=p, max_new_tokens=5)
                                                 for p in prompts], 0)}
        engines[prefix] = eng.stats()
    assert outs[False] == outs[True]
    assert engines[True]["prefill_tokens_computed"] < engines[False]["prefill_tokens_computed"]
    assert engines[True]["prefix_hit_rate"] > 0.0


@pytest.mark.parametrize("gran", GRANS)
def test_quantized_drift_bounded_against_unquantized_twin(gran):
    """JAX's bound (tests/test_quant.py): int8 KV cuts pool KV bytes >= 1.7x
    while greedy streams stay close to the unquantized twin."""
    _, _, tc, tp = model_pair(True)
    prompts = np.random.default_rng(10).integers(0, tc.vocab, size=(3, 8))
    kw = dict(batch_size=3, ctx=16, page_size=4, prefill_chunk=4)
    streams, stats = {}, {}
    for q in (TQ.QuantConfig(), TQ.QuantConfig(kv="int8", granularity=gran)):
        eng = ServingEngine(tp, tc, EngineConfig(quant=q, **kw), device="cpu")
        streams[q.kv] = {o.uid: o.full_sequence.tolist() for o in eng.run_stream(
            [Request(tokens=p, max_new_tokens=8) for p in prompts], 0)}
        stats[q.kv] = eng.stats()
    assert stats["none"]["kv_bytes"] / stats["int8"]["kv_bytes"] >= 1.7
    flips = []
    for u, a in streams["none"].items():
        b = streams["int8"][u]
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        flips.append(1.0 - n / max(1, len(a)))
    assert float(np.mean(flips)) <= 0.25, flips


# ---------------------------------------------------------------------------
# Config surface
# ---------------------------------------------------------------------------


def test_quant_config_validation():
    with pytest.raises(ValueError, match="kv must be one of"):
        TQ.QuantConfig(kv="int4")
    with pytest.raises(ValueError, match="granularity"):
        TQ.QuantConfig(kv="int8", granularity="tensor")
    with pytest.raises(ValueError, match="weights"):
        TQ.QuantConfig(weights="fp8")
    assert not TQ.QuantConfig().enabled
    assert TQ.QuantConfig(kv="int8").qmax == 127.0 and TQ.QuantConfig(kv="fp8").qmax == 448.0
    assert hash(TQ.QuantConfig(kv="int8")) == hash(TQ.QuantConfig(kv="int8"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        TQ.QuantConfig().kv = "int8"


@pytest.mark.parametrize("setting,match", [
    (dict(quant="int8", page_size=16), "QuantConfig"),
    (dict(quant="int8"), "QuantConfig"),
    (dict(quant=TQ.QuantConfig(kv="int8")), "paged pool"),
    (dict(quant=TQ.QuantConfig(kv="fp8", granularity="head")), "narrow"),
])
def test_engine_config_quant_validation(setting, match):
    """A quant setting that is not a QuantConfig raises (the port's earlier
    "not ported" error for it is gone), and quantized KV needs page_size,
    with the JAX package's messages."""
    with pytest.raises(ValueError, match=match):
        EngineConfig(batch_size=2, ctx=16, **setting)
    # weights alone need no paged pool, as in the JAX package
    EngineConfig(batch_size=2, ctx=16, quant=TQ.QuantConfig(weights="int8"))
    EngineConfig(batch_size=2, ctx=16, page_size=16, quant=TQ.QuantConfig(kv="int8"))


def test_cli_flags_build_the_quant_config():
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    ns = ap.parse_args(["--page-size", "16", "--quant-kv", "fp8", "--quant-scale", "head"])
    cfg = EngineConfig.from_args(ns, batch_size=2, ctx=32)
    assert cfg.quant == TQ.QuantConfig(kv="fp8", granularity="head")
    assert EngineConfig.from_args(ap.parse_args([]), batch_size=2, ctx=32).quant == \
        TQ.QuantConfig()
    with pytest.raises(SystemExit):
        ap.parse_args(["--quant-kv", "int4"])
