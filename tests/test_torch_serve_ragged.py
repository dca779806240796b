"""The port's ragged mixed prefill+decode step against the JAX engine (CPU).

Mirrors ``tests/test_serve_ragged.py``: with every request admitted
upfront and enough segments to drain every prompt chunk in the first step,
the ragged engine's decode batches are the padded engine's, so the greedy
streams are identical (MoD routing included); the port's ragged streams
equal the JAX ragged engine's, also under staggered arrivals with a small
segment budget; admission is budgeted by free segments, not free slots;
prefix entries registered at boundaries crossed mid-step give warm streams
equal to cold ones; a page-gated request at the queue head is skipped, not
a barrier.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import PREFILL, Scheduler, Slot  # noqa: E402
from tests.test_torch_paged import model_pair, run_both  # noqa: E402


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=L) for L in [5, 9, 3, 12, 7, 4][:n]]


def test_ragged_stream_matches_padded_and_jax():
    prompts = _prompts()
    n_chunks = sum(-(-len(p) // 4) for p in prompts)
    kw = dict(batch_size=4, ctx=32, page_size=4, prefill_chunk=4)
    pad, _, _, _ = run_both(prompts, 6, jax_side=False, **kw)
    rag, eng, jrag, jeng = run_both(prompts, 6, ragged=True, ragged_segments=n_chunks, **kw)
    assert rag == pad
    assert rag == jrag
    assert eng.stats()["steps"] == jeng.stats()["steps"]
    assert eng.stats()["padded_token_fraction"] == jeng.stats()["padded_token_fraction"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ragged_interleaved_workload_matches_jax(backend):
    """Staggered arrivals, two segments a step: most steps carry prefill
    segments and decode rows together; the streams still equal the JAX
    ragged engine's and the pool drains clean."""
    prompts = _prompts(n=6)
    t, eng, j, _ = run_both(prompts, 4, arrival_every=2, backend=backend, batch_size=4, ctx=32,
                            page_size=4, prefill_chunk=4, ragged=True, ragged_segments=2)
    assert t == j
    st = eng.stats()
    assert 0.0 < st["padded_token_fraction"] < 1.0
    assert st["pages_in_use"] == 0.0
    eng.scheduler.check_invariants(eng.slots, len(t))


def test_ragged_token_budget_admission():
    """One segment per step: prompts serialize through prefill even though
    every slot is free."""
    _, _, tc, tp = model_pair(mod=False)
    rng = np.random.default_rng(1)
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=32, page_size=4, ragged=True,
                                             ragged_segments=1), device="cpu")
    for _ in range(4):
        eng.submit(Request(tokens=rng.integers(1, 96, size=8), max_new_tokens=3))
    max_prefilling, guard = 0, 200
    while eng.has_work and guard:
        eng.step()
        max_prefilling = max(max_prefilling, sum(1 for s in eng.slots if s.state == PREFILL))
        guard -= 1
    assert guard, "engine failed to drain"
    assert len(eng.finished) == 4
    assert max_prefilling <= 1


def test_ragged_prefix_cache_hits_mid_step_boundaries():
    """Entries are registered at every boundary a segment completes,
    including those crossed mid-step (their snapshots exist only inside the
    step); a warm request's stream equals a cold run's and the JAX
    engine's warm stream."""
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 96, size=8)
    a = np.concatenate([shared, rng.integers(1, 96, size=4)])
    b = np.concatenate([shared, rng.integers(1, 96, size=4)])
    kw = dict(batch_size=2, ctx=32, page_size=4, ragged=True, ragged_segments=4)
    cold, _, _, _ = run_both([b], 3, jax_side=False, **kw)
    # arrival every 8 steps: request A drains before B arrives
    warm, eng, jwarm, jeng = run_both([a, b], 3, arrival_every=8, prefix_cache=True, **kw)
    assert eng.stats()["prefix_entries"] >= 2.0  # mid-step ones included
    assert eng.stats()["prefix_hit_rate"] > 0.0
    assert warm[1] == cold[0]
    assert warm == jwarm
    assert eng.stats()["prefill_tokens_computed"] == jeng.stats()["prefill_tokens_computed"]


def test_scheduler_page_gate_skips_blocked_head():
    sched = Scheduler(n_slots=3, policy="fcfs")
    big = Request(tokens=np.arange(8), max_new_tokens=1)
    small1 = Request(tokens=np.arange(2), max_new_tokens=1)
    small2 = Request(tokens=np.arange(2), max_new_tokens=1)
    for i, r in enumerate((big, small1, small2)):
        r.uid = i
        sched.submit(r)
    plans = sched.plan_admissions([Slot(i) for i in range(3)], stepped_prefill=False,
                                  page_gate=lambda r: r.prompt_len <= 2)
    assert [r.uid for _, r in plans] == [1, 2]
    assert [r.uid for r in sched.queue] == [0]  # keeps the head for later waves
    assert sched.admitted == 2
    # max_admissions caps the wave below the free-slot count
    sched2 = Scheduler(n_slots=3, policy="fcfs")
    for i in range(3):
        r = Request(tokens=np.arange(2), max_new_tokens=1)
        r.uid = i
        sched2.submit(r)
    plans2 = sched2.plan_admissions([Slot(i) for i in range(3)], stepped_prefill=False,
                                    max_admissions=1)
    assert len(plans2) == 1 and len(sched2.queue) == 2
    # requeue puts a request back at the front, admission unwound
    sched2.requeue(plans2[0][1])
    assert sched2.queue[0].uid == 0 and sched2.admitted == 0


def test_ragged_requires_paged_pool():
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(batch_size=2, ctx=16, ragged=True)
    with pytest.raises(ValueError, match="ragged_segments"):
        EngineConfig(batch_size=2, ctx=16, page_size=4, ragged=True, ragged_segments=0)
    _, _, tc, tp = model_pair(mod=True)
    with pytest.raises(ValueError, match="batched prefill"):
        ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=16, page_size=4, ragged=True,
                                           prefill="step"), device="cpu")
