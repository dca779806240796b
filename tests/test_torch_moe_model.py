"""The port's MoE family (token-choice MoE, staged and integrated MoDE)
against the JAX package, on the CPU, torch on one thread, f32.

Configs: ``olmoe-1b-7b`` smoke (staged MoDE: every other block routed at
12.5%, its MLP the MoE), ``phi3.5-moe-imode`` smoke (integrated MoDE: two
no-op experts, no MoD routing) and ``family="moe"`` on the tiny test
config with the default ``MoEConfig`` (8 experts top-2; capacity binds in
4-token prefill chunks).

- Weights carry both ways bit for bit (bf16 expert weights, the f32
  router); ``init_model`` draws JAX's tree.
- ``model_loss``: logits within 1e-5, the loss within 1e-5 relative, the
  same aux keys, ``drop_frac``/``noop_frac`` exactly and the rest within
  1e-5, under the backends xla, pallas and pallas_fused (JAX's Pallas
  kernels in interpret mode); every gradient leaf within 2e-5 of that
  leaf's largest JAX entry (``tests/test_torch_train.py``'s bound).
- A padded query row (position -1: a chunk's tail, a short segment's
  rows in the flat forward) takes expert capacity beside the real rows,
  so in an MoE model its attention output is JAX's (the mean of V from
  its dense path; the dense family keeps flash's 0, which no valid row
  sees).
- Prefill, chunked prefill, decode (routed rows reach the MoE as
  ``(kb, 1, D)``) and the flat ragged forward on unequal segments
  (stream-global capacity buckets, as JAX's) within 1e-5.
- Greedy streams and engine stats equal the JAX engine's on the padded,
  paged, prefix-cached and ragged engines, self-speculative rounds at the
  capacity ratio (fused) and at 0.0, int8/page KV and int8 weights.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from tests.helpers import tiny_cfg  # noqa: E402
from tests.test_torch_paged import port_cfg  # noqa: E402

TOL = 1e-5
GRAD_TOL = 2e-5  # of the leaf's largest |grad|
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-imode", "tiny-moe"]
BACKENDS = ["xla", "pallas", "pallas_fused"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(arch, backend="xla", dtype="float32"):
    if arch == "tiny-moe":
        jc = dataclasses.replace(tiny_cfg(), family="moe")
    else:
        jc = JC.smoke_config(JC.get_config(arch))
    return JC.with_mod_backend(dataclasses.replace(jc, dtype=dtype), backend)


@functools.lru_cache(maxsize=None)
def model_pair(arch, backend="xla", dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params): the same weights in
    both packages."""
    jc = _jax_cfg(arch, backend, dtype)
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    tc = port_cfg(jc)
    if arch != "tiny-moe":  # the port's own registered copy gives the same config
        assert tc == TC.with_mod_backend(dataclasses.replace(
            TC.smoke_config(TC.get_config(arch)), dtype=dtype), backend)
    return jc, jp, tc, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _np(t):
    return t.detach().float().numpy()


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-imode"])
def test_weights_carry_both_ways_bit_for_bit(arch):
    jc, jp, tc, tp = model_pair(arch, dtype="bfloat16")
    block = tp["groups"][0]["full"]
    E = jc.moe.n_experts
    assert "mlp" not in block and block["moe"]["router_w"].dtype == torch.float32
    assert block["moe"]["router_w"].shape == (jc.d_model, E + jc.moe.n_noop_experts)
    for name in ("w_up", "w_gate", "w_down"):
        assert block["moe"][name].dtype == torch.bfloat16 and block["moe"][name].shape[0] == E
    if jc.mod.enabled:
        assert "moe" in tp["groups"][0]["mod"]["block"]
    back = to_numpy_tree(tp)
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_model_draws_the_jax_tree(arch):
    jc, jp, tc, _ = model_pair(arch)
    tp = to_numpy_tree(TAPI.init_model(tc, device="cpu", seed=0))
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.25, atol=1e-6)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _assert_aux(ta, ja):
    assert sorted(ta) == sorted(ja)
    for key in ja:
        if key.endswith(("drop_frac", "noop_frac")):
            np.testing.assert_array_equal(_np(ta[key]), np.asarray(ja[key]), err_msg=key)
        else:
            np.testing.assert_allclose(_np(ta[key]), np.asarray(ja[key]), atol=TOL, rtol=TOL,
                                       err_msg=key)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_matches_jax(arch, backend):
    jc, jp, tc, tp = model_pair(arch, backend)
    toks = _tokens(jc.vocab, (2, 33), seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, ja = jax.jit(lambda p, b: JAPI.model_loss(p, jc, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    tl, ta = TAPI.model_loss(tp, tc, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    _assert_aux(ta, ja)
    assert any(k.endswith("moe/lb_loss") for k in ta)
    if jc.moe.n_noop_experts:
        assert float(ta["full/moe/noop_frac"]) > 0
    jlog, _ = jax.jit(lambda p, t: JAPI.model_forward(p, jc, {"tokens": t}))(
        jp, jnp.asarray(batch["tokens"]))
    tlog, _ = TAPI.model_forward(tp, tc, {"tokens": tbatch["tokens"]})
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,backend", [("olmoe-1b-7b", "xla"), ("olmoe-1b-7b", "pallas_fused"),
                                          ("phi3.5-moe-imode", "xla"), ("tiny-moe", "pallas")])
def test_model_grads_match_jax(arch, backend):
    jc, jp, tc, tp = model_pair(arch, backend)
    toks = _tokens(jc.vocab, (2, 33), seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jg = jax.jit(jax.grad(lambda p, b: JAPI.model_loss(p, jc, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, _ = TAPI.model_loss(tp, tc, {k: torch.as_tensor(v).long() for k, v in batch.items()})
    loss.backward()
    got = to_numpy_tree(tree_map(lambda t: t.grad, tp))
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    gl, gdef = jax.tree.flatten(got)
    assert jdef == gdef
    n_moe = 0
    for path, a, b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], jl, gl):
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b, a, atol=GRAD_TOL * max(scale, 1e-6), rtol=0,
                                   err_msg=jax.tree_util.keystr(path[0]))
        n_moe += "router_w" in jax.tree_util.keystr(path[0]) and scale > 0
    assert n_moe >= 1, "the MoE routers must get a gradient"


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-imode"])
def test_prefill_then_decode_match_jax(arch):
    jc, jp, tc, tp = model_pair(arch)
    B, S, ctx = 4, 20, 32
    toks = _tokens(jc.vocab, (B, S), seed=3)
    jl, jcache = jax.jit(lambda p, t: JAPI.model_prefill(p, jc, {"tokens": t}, ctx))(
        jp, jnp.asarray(toks))
    tl, tcache = TAPI.model_prefill(tp, tc, {"tokens": torch.as_tensor(toks).long()}, ctx)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    jdec = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    active = np.array([True, True, False, True])
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        jl2, jcache, jaux = jdec(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(active))
        tl2, tcache, taux = TAPI.model_decode(tp, tcache, tc, torch.as_tensor(tok).long(),
                                              torch.as_tensor(pos), torch.as_tensor(active))
        np.testing.assert_allclose(_np(tl2), np.asarray(jl2), atol=TOL, rtol=TOL)
        assert sorted(taux) == sorted(jaux)
        for key in ("mod/decode_routed", "mod/decode_routed_frac"):
            if key in jaux:
                np.testing.assert_array_equal(_np(taux[key]), np.asarray(jaux[key]))
        tok = np.asarray(jnp.argmax(jl2, axis=-1)).astype(np.int32)[:, None]


def test_prefill_chunk_matches_jax():
    jc, jp, tc, tp = model_pair("olmoe-1b-7b")
    C, L, ctx = 8, 21, 32  # three chunks, the last one padded
    toks = _tokens(jc.vocab, (1, L), seed=4)
    jchunk = jax.jit(lambda p, c, t, s, n: JAPI.model_prefill_chunk(p, jc, c, t, s, n))
    jcache = JAPI.make_caches(jc, 1, ctx)
    tcache = TAPI.make_caches(tc, 1, ctx, device="cpu")
    for off in range(0, L, C):
        nv = min(C, L - off)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :nv] = toks[0, off:off + nv]
        jl, jcache = jchunk(jp, jcache, jnp.asarray(chunk), jnp.int32(off), jnp.int32(nv))
        tl, tcache = TAPI.model_prefill_chunk(tp, tc, tcache, torch.as_tensor(chunk).long(),
                                              off, nv)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
        np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "tiny-moe"])
def test_forward_ragged_unequal_segments_match_jax(arch):
    jc, jp, tc, tp = model_pair(arch)
    lens, tail = (7, 3, 11, 5), 2
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    toks = _tokens(jc.vocab, int(offs[-1]) + tail, seed=5)
    jl, ja = jax.jit(lambda p, t, o: JAPI.model_forward_ragged(p, jc, t, o, max(lens)))(
        jp, jnp.asarray(toks), jnp.asarray(offs))
    tl, ta = TAPI.model_forward_ragged(tp, tc, torch.from_numpy(toks).long(),
                                       torch.from_numpy(offs), max(lens))
    assert tl.shape == tuple(jl.shape)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_aux(ta, ja)


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_padded_query_rows_attend_as_jax(family):
    jc = dataclasses.replace(tiny_cfg(), family=family)
    tc = port_cfg(jc)
    rng = np.random.default_rng(9)
    B, Sq, Skv, nq, nkv, hd = 2, 6, 16, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for S, h in ((Sq, nq), (Skv, nkv), (Skv, nkv)))
    q_pos = np.array([[8, 9, 10, -1, -1, -1], [3, 4, 5, 6, 7, -1]], np.int32)
    kv_pos = np.where(np.arange(Skv) < 11, np.arange(Skv), -1)[None].repeat(B, 0).astype(np.int32)
    want = np.asarray(JA.attend_auto(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), jc))
    got = _np(TA.attend_auto(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), tc))
    valid = q_pos >= 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-6, rtol=1e-5)
    if family == "moe":
        np.testing.assert_allclose(got[~valid], want[~valid], atol=1e-6, rtol=1e-5)
    else:
        assert (got[~valid] == 0).all()


def test_every_entry_point_takes_the_moe_family():
    _, _, tc, tp = model_pair("tiny-moe")
    assert tc.family == "moe" and not tc.moe.enabled and tc.uses_moe
    toks = torch.as_tensor(_tokens(tc.vocab, (2, 8), seed=6)).long()
    logits, caches = TAPI.model_prefill(tp, tc, {"tokens": toks}, 16)
    assert logits.shape == (2, 8, tc.vocab)
    out, caches, _ = TAPI.model_decode(tp, caches, tc, toks[:, :1], torch.full((2,), 8))
    assert out.shape == (2, tc.vocab) and bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(tp))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _prompts(n=5, prefix=8, seed=7, tails=(3, 5, 2, 6, 4)):
    """Shared prefixes (the prefix cache hits) and unequal tails."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 96, size=prefix)
    return [np.concatenate([shared, rng.integers(1, 96, size=tails[i])]) for i in range(n)]


def _run_both(arch, prompts, news, arrival_every, tq=None, jq=None, **engine):
    jc, jp, tc, tp = model_pair(arch)
    tkw = {} if tq is None else {"quant": tq}
    jkw = {} if jq is None else {"quant": jq}
    teng = ServingEngine(tp, tc, EngineConfig(**engine, **tkw), device="cpu")
    touts = teng.run_stream([Request(tokens=p, max_new_tokens=n) for p, n in zip(prompts, news)],
                            arrival_every)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(**engine, **jkw))
    jouts = jeng.run_stream([JRequest(tokens=np.asarray(p, np.int32), max_new_tokens=n)
                             for p, n in zip(prompts, news)], arrival_every)
    return ({o.uid: o.full_sequence.tolist() for o in touts}, teng,
            {o.uid: o.full_sequence.tolist() for o in jouts}, jeng)


PAGED = dict(batch_size=2, ctx=32, page_size=4, prefill_chunk=4)
ENGINES = {
    "padded": dict(batch_size=2, ctx=32),
    "chunked": dict(batch_size=2, ctx=32, prefill_chunk=4),
    "paged": PAGED,
    "prefix": dict(PAGED, prefix_cache=True),
    "ragged": dict(PAGED, ragged=True, ragged_segments=2),
}
STATS = ("steps", "prefill_tokens_computed", "prefix_hit_rate", "page_utilization_peak",
         "preemptions", "kv_bytes", "resid_bytes", "generated_tokens")


@pytest.mark.parametrize("kind", list(ENGINES))
@pytest.mark.parametrize("arch", ["tiny-moe", "olmoe-1b-7b"])
def test_engine_streams_equal_jax(arch, kind):
    """Staggered arrivals (one per step) into 2 slots."""
    t, teng, j, jeng = _run_both(arch, _prompts(), [5, 3, 6, 4, 5], 1, **ENGINES[kind])
    assert t == j
    ts, js = teng.stats(), jeng.stats()
    for key in STATS:
        if key in js:
            assert ts[key] == js[key], key
    assert (ts.get("prefix_hit_rate", 0) > 0) == (kind == "prefix")


@pytest.mark.parametrize("ratio", ["capacity", 0.0])
@pytest.mark.parametrize("arch", ["tiny-moe", "olmoe-1b-7b"])
def test_speculative_streams_equal_jax_and_the_plain_engine(arch, ratio):
    jc, _, tc, _ = model_pair(arch)
    ratio = tc.mod.capacity_ratio if ratio == "capacity" else ratio
    prompts = [np.random.default_rng(8).integers(1, 96, size=L) for L in (5, 9, 3, 12)]
    engine = dict(batch_size=4, ctx=32, page_size=4, prefill_chunk=4)
    base, _, _, _ = _run_both(arch, prompts, [8] * 4, 0, **engine)
    t, teng, j, jeng = _run_both(arch, prompts, [8] * 4, 0, speculate=3, draft_ratio=ratio,
                                 **engine)
    assert t == j == base
    ts, js = teng.stats(), jeng.stats()
    assert ts["speculative_rounds"] > 0
    for key in ("steps", "speculative_rounds", "speculative_accept_rate", "generated_tokens"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("mode", [("int8", "page", "none"), ("int8", "page", "int8")],
                         ids=["int8-page", "int8-weights"])
@pytest.mark.parametrize("kind", ["paged", "prefix", "ragged"])
def test_quantized_streams_equal_jax(kind, mode):
    kv, gran, weights = mode
    tq = TQ.QuantConfig(kv=kv, granularity=gran, weights=weights)
    jq = JQ.QuantConfig(kv=kv, granularity=gran, weights=weights)
    t, teng, j, jeng = _run_both("tiny-moe", _prompts(), [5, 3, 6, 4, 5], 1, tq, jq,
                                 **ENGINES[kind])
    assert t == j
    ts, js = teng.stats(), jeng.stats()
    for key in ("steps", "kv_bytes", "quant_kv", "prefill_tokens_computed"):
        assert ts[key] == js[key], key
