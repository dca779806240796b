"""The port's serving engine against the JAX engine (CPU).

Same weights, same 8 greedy requests with mixed prompt lengths, arriving
one every two engine steps into 4 slots: the token streams must be
identical, with whole-prompt and with chunked prefill. The JAX engine runs
backend ``xla`` (its ``xla`` and ``pallas`` backends are bitwise equal,
tests/test_routing_backends.py); the port runs ``pallas``, whose wrappers
take their plain versions on the CPU. Also: a ``mesh`` that is not a
``DeviceMesh`` raises, as do invalid speculative and overload settings (the quantized path's checks are
in tests/test_torch_quant.py). Sampled tokens are keyed by (seed, token
index), as JAX keys them by ``fold_in(key, i)``: a re-draw gives the same
token. The pools' byte counts equal the JAX pools' at ``mod-paper-60m``
(int32 ring cursors, as JAX's).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import cache as JCACHE  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve import cache as TCACHE  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.scheduler import Slot  # noqa: E402


def _requests(vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.choice([5, 9, 14], n)
    gens = rng.choice([4, 7], n)
    return [(rng.integers(0, vocab, L).astype(np.int32), int(g)) for L, g in zip(lens, gens)]


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_greedy_streams_identical_to_jax_engine(prefill_chunk):
    arch = "mod-paper-60m"
    jc = JC.with_mod_backend(
        dataclasses.replace(JC.smoke_config(JC.get_config(arch)), dtype="float32"), "xla")
    tc = TC.with_mod_backend(
        dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype="float32"), "pallas")
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _requests(jc.vocab)
    ctx = 24
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(
        batch_size=4, ctx=ctx, prefill_chunk=prefill_chunk))
    teng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=ctx, prefill_chunk=prefill_chunk),
                         device="cpu")
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g) for t, g in reqs], 2)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g) for t, g in reqs], 2)
    jstreams = {o.uid: o.tokens.tolist() for o in jout}
    tstreams = {o.uid: o.tokens.tolist() for o in tout}
    assert tstreams == jstreams
    assert {o.uid: (o.admitted_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.finished_step) for o in jout}
    for o in tout:
        assert o.ok and len(o.tokens) == reqs[o.uid][1]
    js, ts = jeng.stats(), teng.stats()
    assert ts["steps"] == js["steps"]
    assert ts["mean_routed_frac"] == js["mean_routed_frac"]


def test_generate_and_sampling_are_per_request():
    # the vanilla twin: MoD decode routing couples rows by design, so only
    # a dense model's logits are independent of the batch's other rows
    tc = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m-vanilla")),
                             dtype="float32")
    from repro_torch.models import api as TAPI

    params = TAPI.init_model(tc, device="cpu", seed=1)
    prompts = np.random.default_rng(0).integers(0, tc.vocab, (3, 6))
    eng = ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16), device="cpu")
    out = eng.generate(prompts, 5)
    assert out.shape == (3, 11) and (out[:, :6] == prompts).all()
    # a sampled request's stream depends on its seed, not on its neighbours
    alone = ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16), device="cpu")
    a = alone.generate(prompts[:1], 5, temperature=1.0, seed=11)
    crowd = ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16), device="cpu")
    b = crowd.generate(prompts, 5, temperature=1.0, seed=11)
    assert (a[0] == b[0]).all()
    s = crowd.stats()
    assert s["generated_tokens"] == 15 and s["finished_requests"] == 3


@pytest.mark.parametrize(
    "setting",
    [dict(speculate=0, page_size=16), dict(speculate=2), dict(mesh="data"),
     dict(capacity_levels=(1.0, 0.5)), dict(spec_verify_budget=8)],
)
def test_later_engine_paths_raise(setting):
    """A ``mesh`` that is not a ``DeviceMesh`` over ("data", "model")
    raises (the mesh engine: tests/test_torch_spmd.py,
    tests/test_torch_mesh.py); the speculative and overload paths run, and
    raise for their invalid settings (a window under 1, no paged pool, a
    ladder or a verify budget without the path that reads it). ``adaptive_capacity`` and
    ``fault_injector`` build working engines (tests/test_torch_overload.py,
    tests/test_torch_faults.py)."""
    name = next(iter(setting))
    with pytest.raises(ValueError, match=name):
        EngineConfig(batch_size=2, ctx=16, **setting)


def test_engine_config_validates():
    with pytest.raises(ValueError):
        EngineConfig(batch_size=0, ctx=16)
    with pytest.raises(ValueError):
        EngineConfig(batch_size=2, ctx=16, prefill="sideways")
    with pytest.raises(ValueError):
        Request(tokens=np.zeros(0, np.int64), max_new_tokens=3)


def _sampling_engine():
    tc = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m-vanilla")),
                             dtype="float32")
    from repro_torch.models import api as TAPI

    params = TAPI.init_model(tc, device="cpu", seed=1)
    return ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16), device="cpu")


def test_sampled_token_is_keyed_by_its_index():
    """The same logits row at the same token index gives the same token, and
    a draw of token i, then i+1, then i again repeats the first: the
    property the JAX engine's speculative round relies on (tokens sampled
    past the cap are re-sampled from the same logits the next round)."""
    eng = _sampling_engine()
    slot = Slot(idx=0)
    slot.req = Request(tokens=np.arange(3), max_new_tokens=8, temperature=1.0, seed=11, uid=0)
    row = np.zeros(512, np.float32)  # uniform over 512 tokens: any repeat by chance is rare
    slot.generated = [7, 7, 7]
    first = eng._sample(slot, row)
    assert eng._sample(slot, row) == first
    slot.generated.append(first)
    nxt = eng._sample(slot, row)
    slot.generated.pop()
    assert eng._sample(slot, row) == first
    slot.generated.append(first)
    assert eng._sample(slot, row) == nxt

    def draws(n):
        slot.generated = []
        out = []
        for _ in range(n):
            out.append(eng._sample(slot, row))
            slot.generated.append(out[-1])
        return out

    seed11 = draws(20)
    assert len(set(seed11)) > 10  # the index moves the draw
    slot.req = Request(tokens=np.arange(3), max_new_tokens=8, temperature=1.0, seed=12, uid=0)
    assert draws(20) != seed11
    # greedy ignores the key
    slot.req = Request(tokens=np.arange(3), max_new_tokens=8, uid=2)
    row[5] = 1.0
    assert eng._sample(slot, row) == 5


POOLS = {"contiguous": None, "paged": dict(), "int8-page": dict(kv="int8", granularity="page"),
         "fp8-head": dict(kv="fp8", granularity="head")}


@pytest.mark.parametrize("pool", list(POOLS))
def test_pool_bytes_equal_jax_pools_at_mod_paper_60m(pool):
    """cache_bytes() of the port's pools (hence stats()' kv_bytes and
    resid_bytes) equal the JAX pools' at mod-paper-60m's full width: the
    ring cursors are int32 in both."""
    jc, tc = JC.get_config("mod-paper-60m"), TC.get_config("mod-paper-60m")
    B, ctx, page = 2, 64, 16
    q = POOLS[pool]
    if q is None:
        jp, tp = JCACHE.CachePool(jc, B, ctx), TCACHE.CachePool(tc, B, ctx, torch.device("cpu"))
    else:
        jp = JCACHE.PagedCachePool(jc, B, ctx, page, quant=JQ.QuantConfig(**q))
        tp = TCACHE.PagedCachePool(tc, B, ctx, page, torch.device("cpu"),
                                   quant=TQ.QuantConfig(**q))
    jb, tb = jp.cache_bytes(), tp.cache_bytes()
    for key in ("total", "mod", "full", "kv_bytes", "resid_bytes"):
        assert tb[key] == jb[key], (key, tb[key], jb[key])
    assert tb["resid_bytes"] > 0
