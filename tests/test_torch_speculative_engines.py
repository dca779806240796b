"""Self-speculative rounds of the port's ragged, prefix-cached and quantized
engines against the JAX engine (CPU, f32, ``tests/helpers.tiny_cfg``'s
model, torch on one thread).

Greedy speculative streams equal the JAX engine's speculative streams and,
where requests are submitted upfront (as the JAX package's speculative
tests submit them: a round advances ``step_count`` by its accepted window,
so staggered arrivals join another batch than in the plain engine, and MoD
``batch_capacity`` routing couples a batch's rows), the port's own
non-speculative streams; the ``speculative_*`` stats,
``padded_token_fraction``, ``steps`` and the page books equal JAX's, on:
the ragged engine (rounds only while no slot is mid-prompt; the mixed step
otherwise), the prefix cache, a pool small enough to preempt, the verify-token budget (which caps concurrent slots) and
``run_stream``'s arrivals. Sampled streams are held against the port's own
non-speculative engine (the two packages' samplers draw differently by
design; ``tests/test_torch_speculative.py``). The quantized engines are in
``tests/test_torch_speculative_quant.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.scheduler import PREFILL  # noqa: E402
from tests.test_torch_paged import model_pair, run_both, shared_prefix_prompts  # noqa: E402
from tests.test_torch_speculative import assert_stats_equal  # noqa: E402

PAGE_STATS = ("page_utilization_peak", "preemptions", "prefix_hit_rate", "pages_in_use")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(prompts, news, arrival_every=0, quant=None, mod=True, **engine):
    """(port streams, port engine, JAX streams, JAX engine) of greedy
    requests; ``quant`` = (kv, granularity, weights) or None."""
    jc, jp, tc, tp = model_pair(mod)
    tq = TQ.QuantConfig(*quant) if quant else TQ.QuantConfig()
    jq = JQ.QuantConfig(*quant) if quant else JQ.QuantConfig()
    teng = ServingEngine(tp, tc, EngineConfig(quant=tq, **engine), device="cpu")
    touts = teng.run_stream([Request(tokens=p, max_new_tokens=n) for p, n in zip(prompts, news)],
                            arrival_every)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(quant=jq, **engine))
    jouts = jeng.run_stream([JRequest(tokens=np.asarray(p, np.int32), max_new_tokens=n)
                             for p, n in zip(prompts, news)], arrival_every)
    return ({o.uid: o.full_sequence.tolist() for o in touts}, teng,
            {o.uid: o.full_sequence.tolist() for o in jouts}, jeng)


def _port_only(prompts, news, arrival_every=0, quant=None, mod=True, sampled=False, **engine):
    _, _, tc, tp = model_pair(mod)
    tq = TQ.QuantConfig(*quant) if quant else TQ.QuantConfig()
    eng = ServingEngine(tp, tc, EngineConfig(quant=tq, **engine), device="cpu")
    outs = eng.run_stream([Request(tokens=p, max_new_tokens=n, seed=50 + i,
                                   temperature=0.9 if sampled and i % 2 else 0.0)
                           for i, (p, n) in enumerate(zip(prompts, news))], arrival_every)
    return {o.uid: o.full_sequence.tolist() for o in outs}, eng


def _check_against_jax_and_plain(prompts, news, arrival_every=0, quant=None, mod=True,
                                 spec=None, plain=None, **engine):
    t, teng, j, jeng = _both(prompts, news, arrival_every, quant, mod, **engine, **spec)
    assert t == j, "speculative streams differ from the JAX engine's"
    if arrival_every <= 0 if plain is None else plain:
        plain, _ = _port_only(prompts, news, arrival_every, quant, mod, **engine)
        assert t == plain, "speculative streams differ from the port's plain engine's"
    ts, js = teng.stats(), jeng.stats()
    assert ts["speculative_rounds"] > 0
    assert_stats_equal(ts, js)
    assert_stats_equal(ts, js, PAGE_STATS)
    assert teng.step_count == jeng.step_count
    assert ts["pages_in_use"] == 0.0
    return teng


RAGGED = dict(batch_size=4, ctx=32, page_size=4, prefill_chunk=4, ragged=True)


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_ragged_speculative_streams(mod):
    """Every prompt drains in the first mixed step (segments = all
    chunks); rounds then cover the pure-decode steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, size=L) for L in (5, 9, 3, 12)]
    segs = sum(-(-len(p) // 4) for p in prompts)
    eng = _check_against_jax_and_plain(prompts, [8] * 4, mod=mod,
                                       spec=dict(speculate=3, draft_ratio=0.125),
                                       **dict(RAGGED, ragged_segments=segs))
    assert eng.stats()["speculative_rounds"] < eng.step_count


def test_ragged_speculation_waits_for_draining_prompts():
    """Staggered arrivals into 2 segments: steps with a slot mid-prompt run
    the mixed step (no round), and no round ever sees a PREFILL slot."""
    prompts = shared_prefix_prompts()
    seen = []
    _, _, tc, tp = model_pair(True)
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=24, page_size=4, prefill_chunk=4,
                                             ragged=True, ragged_segments=2, speculate=3),
                        device="cpu")
    real = eng._step_ragged

    def mixed(admit=True):
        seen.append("mixed")
        return real(admit)

    eng._step_ragged = mixed
    rounds = [0]
    real_round = eng.pool.scatter_rows

    def scatter(*a):
        assert not any(s.state == PREFILL for s in eng.slots)
        rounds[0] += 1
        return real_round(*a)

    eng.pool.scatter_rows = scatter
    outs = eng.run_stream([Request(tokens=p, max_new_tokens=n)
                           for p, n in zip(prompts, [5, 3, 6, 4, 5])], 1)
    assert len(outs) == 5 and rounds[0] == eng.stats()["speculative_rounds"] > 0
    assert "mixed" in seen
    t, teng, j, _ = _both(prompts, [5, 3, 6, 4, 5], 1, batch_size=2, ctx=24, page_size=4,
                          prefill_chunk=4, ragged=True, ragged_segments=2, speculate=3)
    assert t == j == {o.uid: o.full_sequence.tolist() for o in outs}


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_ragged_sampled_speculation_equals_plain(mod):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 96, size=L) for L in (5, 9, 3, 12)]
    kw = dict(RAGGED, ragged_segments=9)
    base, _ = _port_only(prompts, [8] * 4, mod=mod, sampled=True, **kw)
    spec, eng = _port_only(prompts, [8] * 4, mod=mod, sampled=True, speculate=3,
                           draft_ratio=0.125, **kw)
    assert spec == base
    assert eng.stats()["speculative_rounds"] > 0


def test_prefix_cache_speculative_streams():
    """Shared 8-token prefix: warm restores and rolled-back tails share
    pages; truncation never frees a page a prefix entry pins."""
    for arrival_every in (0, 1):
        eng = _check_against_jax_and_plain(
            shared_prefix_prompts(), [5, 3, 6, 4, 5], arrival_every, batch_size=2, ctx=24,
            page_size=4, prefill_chunk=4, prefix_cache=True,
            spec=dict(speculate=3, draft_ratio=0.0))
        assert eng.stats()["prefix_hit_rate"] > 0


def test_speculation_under_page_pressure_preempts_as_jax():
    """A pool too small for every slot's window: rounds map n+1 positions
    up front and preempt the youngest slot, as JAX's. The dense model's rows
    do not couple, so its streams are also the plain engine's, whose
    preemptions fall on other steps."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 96, size=L) for L in (9, 11, 7, 12)]
    for mod in (True, False):
        eng = _check_against_jax_and_plain(prompts, [12] * 4, mod=mod, batch_size=4, ctx=24,
                                           page_size=4, prefill_chunk=4, n_pages=11,
                                           spec=dict(speculate=3, draft_ratio=0.0), plain=not mod)
        assert eng.stats()["preemptions"] > 0


def test_verify_budget_caps_concurrent_slots():
    """Budget 8 at n=3: every active slot spends 4 verify positions a
    round, so at most 2 of the 4 slots are active at any step."""
    _, _, tc, tp = model_pair(False)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, size=L) for L in (5, 9, 3, 12)]
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=32, page_size=4, prefill_chunk=4,
                                             speculate=3, spec_verify_budget=8), device="cpu")
    for p in prompts:
        eng.submit(Request(tokens=p, max_new_tokens=8))
    peak = 0
    while eng.has_work:
        eng.step()
        peak = max(peak, sum(1 for s in eng.slots if s.active))
    assert len(eng.finished) == 4 and peak == 2
    t, teng, j, jeng = _both(prompts, [8] * 4, mod=False, batch_size=4, ctx=32, page_size=4,
                             prefill_chunk=4, speculate=3, spec_verify_budget=8)
    assert t == j == {o.uid: o.full_sequence.tolist() for o in eng.finished}
    assert_stats_equal(teng.stats(), jeng.stats())


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_run_stream_arrivals_with_speculation(mod):
    """Rounds advance ``step_count`` by the accepted window; the arithmetic
    arrival check still submits every request, at JAX's steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, size=L) for L in (5, 9, 3, 12, 7, 4)]
    t, teng, j, jeng = run_both(prompts, 8, arrival_every=3, mod=mod, batch_size=4, ctx=32,
                                page_size=4, prefill_chunk=4, speculate=3)
    assert sorted(t) == list(range(6)) and t == j
    assert_stats_equal(teng.stats(), jeng.stats())
    touts = {o.uid: o for o in teng.finished}
    for o in jeng.finished:
        assert (touts[o.uid].submitted_step, touts[o.uid].admitted_step,
                touts[o.uid].finished_step) == (o.submitted_step, o.admitted_step,
                                                o.finished_step)
