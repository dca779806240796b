"""The Zamba2 hybrid served from int8 / fp8 KV pages and int8 weights,
against the JAX package, on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``), f32,
at ``smoke_config(zamba2-2.7b)`` with the smoke head dim 32, with
zamba2's own 80 and the MoD-off twin (``tests/test_torch_hybrid.py``'s
variants), and a deeper cut (8 layers in 2 segments of 2 {full, mod}
pairs) where one pair's weights are 8x the others':

- ``quantize_params`` gives the JAX package's int8 values and scales bit
  for bit: a group leaf takes one scale over every segment and every pair
  (the JAX leaf stacked ``(n_seg, n_pairs)``), ``shared_attn`` one a leaf;
  the widened tree is JAX's widened tree;
- the paged pool quantizes the shared block's ``k`` / ``v`` rings, one
  narrow leaf each over its ``n_seg`` sites (``G`` 1 under ``page``,
  ``n_seg·nkv`` under ``head``), and keeps the SSM states, conv windows,
  cursors and ``pos`` rings exact;
- the stepped engine under int8/page, fp8/head and int8 weights: greedy
  streams, lifecycle steps, ``stats()``, ``cache_bytes()``, ``kv_bytes``
  and ``unquantized_kv_bytes()`` (an unquantized JAX pool's ``kv_bytes``)
  equal to the JAX engine's, and after the run every page scale and every
  position page equal to the JAX pool's bit for bit, the narrow K/V pages
  all but 0.1% of their codes (the rest one step apart: the rows are f32
  products of the two frameworks, equal within a few ulps). The SCRATCH
  page is left out of that comparison: it backs free slots' writes and is
  never read, and the JAX pool also rewrites it whenever it pads a
  fixed-size list of page ids with it (a scrub or a slot write).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro.serve.cache import PagedCachePool as JPagedCachePool  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.cache import NULL_PAGE, SCRATCH_PAGE, _leaves  # noqa: E402
from tests.test_torch_hybrid import _STATS, _cfgs, _jax_params, _requests  # noqa: E402
from tests.test_torch_quant import _assert_bits  # noqa: E402

MODES = {"int8-page": dict(kv="int8", granularity="page"),
         "fp8-head": dict(kv="fp8", granularity="head"),
         "int8-weights": dict(weights="int8")}
# 8 layers in 2 segments of 2 {full, mod} pairs: pairs a segment > 1
PAIRS = dict(n_layers=8, hybrid_attn_every=4)
SPREAD = 8.0  # one pair's weights this many times the others'


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (tests/test_torch_ssm.py
    says why: a worker thread beside JAX's has computed ``exp`` off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qleaves(tree, path=()):
    """(path, quantized leaf) of a narrow weight tree, dict and list keys."""
    if isinstance(tree, dict):
        if "__q8__" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _qleaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _qleaves(v, path + (i,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spread_one_pair(jp):
    """The JAX tree with every float group leaf of segment 1, pair 1 scaled
    by SPREAD: that pair's absmax is SPREAD times the rest's."""
    def one(a):
        if not jax.numpy.issubdtype(a.dtype, jax.numpy.floating):
            return a
        return a.at[1, 1].multiply(SPREAD)
    return dict(jp, groups=jax.tree.map(one, jp["groups"]))


@pytest.mark.parametrize("variant,layout", [("hd32", {}), ("hd80", {}), ("dense", {}),
                                            ("hd32", PAIRS)],
                         ids=["hd32", "hd80", "dense", "pairs-spread"])
def test_narrow_weight_tree_equals_jax_bitwise(variant, layout):
    jc, tc = _cfgs(variant, **layout)
    jp = _jax_params(jc)
    if layout:
        jp = _spread_one_pair(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jq, tq = jax.jit(JQ.quantize_params)(jp), TQ.quantize_params(tp)
    n_seg, n_pairs = len(tp["groups"]), len(tp["groups"][0])
    seen = 0
    for path, leaf in _qleaves(tq):
        if path[0] == "groups":
            s, p = path[1], path[2]
            jleaf = _at(jq, ("groups",) + path[3:])
            want_q = np.asarray(jleaf["__q8__"])[s, p]
        else:
            jleaf = _at(jq, path)
            want_q = np.asarray(jleaf["__q8__"])
        _assert_bits(leaf["__q8__"], want_q)
        _assert_bits(leaf["__scale__"], np.asarray(jleaf["__scale__"]))
        assert leaf["__dt__"] == torch.float32
        seen += 1
    n_jax = len(list(_qleaves(jax.tree.map(np.asarray, jq))))
    n_group = len(list(_qleaves(jax.tree.map(np.asarray, jq["groups"]))))
    assert seen == n_jax - n_group + n_group * n_seg * n_pairs
    jwide = from_jax_params(jax.tree.map(np.asarray, JQ.dequantize_params(jq)), device="cpu")
    twide = TQ.dequantize_params(tq)
    for (_, a), b in zip(_tensor_leaves(twide), [t for _, t in _tensor_leaves(jwide)]):
        _assert_bits(a, b)
    if layout:
        # the case bites: the scale of pair 0 across the segments alone (a
        # scale per pair index) is below the JAX leaf's, for every leaf that
        # is not all zeros
        bites = 0
        for path, leaf in _qleaves(tq["groups"][0][0]):
            pair0 = [_at(tp["groups"][s][0], path) for s in range(n_seg)]
            if any(bool(t.any()) for t in pair0):
                assert float(TQ._absmax_scale(*pair0)) < float(leaf["__scale__"]), path
                bites += 1
        assert bites >= 10


def _tensor_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("variant", ["hd32", "hd80"])
def test_paged_engine_equals_jax(variant, mode):
    jc, tc = _cfgs(variant)
    jp = _jax_params(jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _requests(jc.vocab, n=5)
    kw = dict(batch_size=2, ctx=20, page_size=4)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(quant=JQ.QuantConfig(**MODES[mode]), **kw))
    teng = ServingEngine(tp, tc, EngineConfig(quant=TQ.QuantConfig(**MODES[mode]), **kw),
                         device="cpu")
    assert teng.prefill_mode == "step"
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g) for t, g in reqs], 1)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g) for t, g in reqs], 1)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    assert {o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in jout}
    js, ts = jeng.stats(), teng.stats()
    for key in _STATS + ("quant_kv", "pages_in_use"):
        if key in js:
            assert ts[key] == js[key], key
    assert teng.pool.cache_bytes() == jeng.pool.cache_bytes()
    wide = JPagedCachePool(jc, 2, 20, 4, n_pages=jeng.pool.n_pages)
    assert teng.pool.unquantized_kv_bytes() == wide.cache_bytes()["kv_bytes"]
    n_seg = tc.n_layers // tc.hybrid_attn_every
    qc = teng.quant
    if qc is None:  # int8 weights: the pool is the wide one
        assert teng.pool.scales == [] and jeng.pool.scales == []
        assert ts["kv_bytes"] == teng.pool.unquantized_kv_bytes()
        return
    # one narrow leaf each for k and v, over the n_seg sites; pos stays int32
    assert [ql.js for ql in teng.pool.spec.qleaves] == [
        tuple(range(0, 3 * n_seg, 3)), tuple(range(1, 3 * n_seg, 3))]
    G = 1 if qc.granularity == "page" else n_seg * tc.attn.n_kv_heads
    assert [tuple(s.shape)[2] for s in teng.pool.scales] == [G, G]
    assert {p.dtype for p in teng.pool.pages} == {qc.kv_dtype(), torch.int32}
    assert ts["kv_bytes"] < teng.pool.unquantized_kv_bytes()
    keep = [i for i in range(teng.pool.n_pages) if i != SCRATCH_PAGE]
    jpages = _jax_paged_leaves(jeng.pool, jc)
    tkeys = [keys for keys, _ in _leaves(teng.pool._template)]
    for j, i in enumerate(teng.pool.spec.paged_ids):
        _, site, name = tkeys[i]  # ("attn", site, "k" | "v" | "pos")
        got, want = teng.pool.pages[j][keep], jpages[name][site][keep]
        if name == "pos":
            _assert_bits(got, want)
        else:
            _narrow_close(got, want)
    for t, j in zip(teng.pool.scales, jeng.pool.scales):
        _assert_bits(t[keep], np.asarray(j)[keep])
        assert bool((t[NULL_PAGE] == 1.0).all())
        assert bool((t[keep] != 1.0).any())  # the run wrote scales


def _narrow_close(got, want):
    """Narrow K/V pages: the rows quantized are f32 products of the two
    frameworks, equal within a few ulps, so an element on a rounding edge
    may take the neighbouring code: all but 0.1% of the elements equal, the
    rest one int8 step or one e4m3 step (2^-3 relative) apart."""
    a = got.float().numpy()
    b = torch.from_numpy(np.asarray(want).view(np.uint8)).view(got.dtype).float().numpy()
    diff = np.abs(a - b)
    step = 1.0 if got.dtype == torch.int8 else np.maximum(np.abs(a), np.abs(b)) * 2.0**-3 + 2.0**-9
    assert (diff <= step).all(), diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def _jax_paged_leaves(pool, jc):
    """{"k" | "v" | "pos": the JAX pool's page tensor of that leaf, stacked
    over the sites: (n_seg, N, p) + tail}."""
    paths = jax.tree_util.tree_flatten_with_path(
        JAPI.make_caches(jc, pool.batch_size, pool.ctx, specs=True))[0]
    out = {}
    for j, i in enumerate(pool._paged_ids):
        keys = [getattr(k, "key", None) for k in paths[i][0]]
        assert keys[0] == "attn", keys
        out[keys[-1]] = np.asarray(pool.pages[j])
    return out
