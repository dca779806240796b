"""The port's fault injection against the JAX package, on the CPU (f32,
greedy, ``tests/helpers.tiny_cfg``'s model, torch on one thread).

The seeded fault-matrix soak of ``tests/test_faults.py`` (NaN/Inf logits,
page exhaustion, straggler steps, preemption storms, with work kept
flowing past the fault horizon) drives a port engine and a JAX engine on
the same weights (``params.from_jax_params``) and the same request draws,
for seeds 0-2 on the padded-paged, ragged and speculative engines. The
two runs must agree exactly: the injector's ``fired`` log, every
request's finish reason, error text and tokens, the engine's step count
and its ``stats()`` counters. After every step the port's pool recounts
its books (``PagedCachePool.check_invariants``) and the JAX pool is held
by ``tests/test_paged_properties._check``; at drain both satisfy JAX's
contract (``tests/test_faults._assert_contract``: one ``FINISH_ERROR`` a
corruption step, nobody else failed, nothing held or mapped). Also the
dense non-interference case (every survivor's stream equals a fault-free
run's), a soak that must preempt, a contiguous-pool soak, the seeded
matrix itself and ``Fault`` validation. Tolerance: none, the compared
values are exact.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from tests.test_faults import _assert_contract  # noqa: E402
from tests.test_paged_properties import _check  # noqa: E402
from tests.test_torch_paged import model_pair  # noqa: E402

MAX_STEPS = 400
COUNTERS = ("steps", "generated_tokens", "finished_requests", "shed", "expired", "cancelled",
            "failed", "preemptions", "admission_aborts", "pages_held", "pages_in_use")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _leave_the_jax_jit_cache_as_found():
    """The JAX engine shares its jitted steps across engines of a process
    (``repro.serve.engine._JIT_CACHE``, keyed by config, not by shape) and
    its ``decode_compilations`` counts the entries of a capacity level's
    step from the moment the level is first used: entries this module
    left would count as a later file's compilations. Restore the cache."""
    from repro.serve import engine as JE

    before = list(JE._JIT_CACHE.items())
    yield
    JE._JIT_CACHE.clear()
    JE._JIT_CACHE.update(before)


def _requests(side, rng, n, vocab=90):
    """JAX ``tests/test_faults._requests``'s draws, as requests of ``side``."""
    out = []
    for _ in range(n):
        toks = rng.integers(1, vocab, size=int(rng.integers(2, 9)))
        new = int(rng.integers(3, 7))
        out.append(J.Request(tokens=np.asarray(toks, np.int32), max_new_tokens=new)
                   if side is J else T.Request(tokens=toks, max_new_tokens=new))
    return out


def soak(side, seed, mod=True, n_requests=10, horizon=30, injector=None, **engine):
    """JAX ``tests/test_faults._soak`` on an engine of ``side`` (``J`` or
    ``T``): returns (outputs by uid, injector, engine)."""
    jc, jp, tc, tp = model_pair(mod)
    rng = np.random.default_rng(seed)
    inj = injector or side.FaultInjector.seeded(seed, n_faults=6, horizon=horizon)
    kw = dict(dict(batch_size=4, ctx=32, page_size=4, prefill_chunk=4), fault_injector=inj,
              **engine)
    if side is J:
        eng = J.ServingEngine(jp, jc, engine=J.EngineConfig(**kw))
    else:
        eng = T.ServingEngine(tp, tc, T.EngineConfig(**kw), device="cpu")
    pending = _requests(side, rng, n_requests)
    live = []
    for _ in range(MAX_STEPS):
        while pending and len(eng.scheduler.queue) < 2:
            r = pending.pop()
            eng.submit(r)
            live.append(r)
        if not pending and not inj.exhausted and not eng.scheduler.queue:
            filler = _requests(side, rng, 1)[0]
            eng.submit(filler)
            live.append(filler)
        eng.step()
        if eng._paged:
            eng.pool.check_invariants() if side is T else _check(eng.pool)
        eng.scheduler.check_invariants(eng.slots, len(eng.finished))
        if not eng.has_work and not pending and inj.exhausted:
            break
    assert not eng.has_work and not pending, "soak did not converge"
    assert inj.exhausted, f"faults never fired: {[f.kind for f in inj.faults]} vs {inj.fired}"
    outs = {o.uid: o for o in eng.finished}
    assert sorted(outs) == sorted(r.uid for r in live)
    return outs, inj, eng


def soak_both(seed, **kw):
    """The soak on both packages, held equal; returns the port's run."""
    got = {side: soak(side, seed, **kw) for side in (J, T)}
    (jo, ji, je), (to, ti, te) = got[J], got[T]
    assert ti.fired == ji.fired, "the fault logs differ"
    assert {u: (o.finish_reason, o.error, o.tokens.tolist()) for u, o in to.items()} == \
           {u: (o.finish_reason, o.error, o.tokens.tolist()) for u, o in jo.items()}
    assert te.step_count == je.step_count
    ts, js = te.stats(), je.stats()
    for k in COUNTERS if te._paged else COUNTERS[:7]:
        assert ts[k] == js[k], (k, ts[k], js[k])
    return got[T]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", [dict(), dict(ragged=True), dict(speculate=3)],
                         ids=["padded", "ragged", "speculative"])
def test_fault_matrix_soak_equals_jax(engine, seed):
    outs, inj, eng = soak_both(seed, **engine)
    _assert_contract(outs, inj, eng)
    assert {f["kind"] for f in inj.fired} - {"release_held"} == {f.kind for f in inj.faults}


def test_fault_matrix_soak_preempts_and_recovers():
    """A pool of 6 allocatable pages for 4 slots of up to 4 pages each,
    under a matrix with two long page holds: growth preempts, and the
    preempted requests still finish normally (equal to JAX)."""
    faults = [T.Fault("page_exhaustion", step=3, pages=3, duration=4),
              T.Fault("nan_logits", step=5), T.Fault("preempt_storm", step=8),
              T.Fault("page_exhaustion", step=10, pages=2, duration=3)]
    got = {}
    for side in (J, T):
        inj = side.FaultInjector([side.Fault(f.kind, f.step, f.slot, f.pages, f.duration)
                                  for f in faults])
        got[side] = soak(side, 3, injector=inj, n_pages=8)
    (jo, ji, je), (to, ti, te) = got[J], got[T]
    assert ti.fired == ji.fired
    assert {u: (o.finish_reason, o.tokens.tolist()) for u, o in to.items()} == \
           {u: (o.finish_reason, o.tokens.tolist()) for u, o in jo.items()}
    _assert_contract(to, ti, te)
    assert te.stats()["preemptions"] == je.stats()["preemptions"] >= 1


def test_fault_matrix_on_the_contiguous_pool():
    """Without pages, ``page_exhaustion`` is a no-op and the rest fires
    (equal to JAX without storms: the JAX engine's preemption raises on a
    contiguous pool, which has no ``release``). The port also preempts
    there, and the storm's victims finish normally."""
    kinds = ("nan_logits", "inf_logits", "page_exhaustion", "slow_step")
    got = {}
    for side in (J, T):
        inj = side.FaultInjector.seeded(4, n_faults=6, horizon=20, kinds=kinds)
        got[side] = soak(side, 4, injector=inj, page_size=None, prefill_chunk=None)
    (jo, ji, _), (to, ti, te) = got[J], got[T]
    assert ti.fired == ji.fired
    assert {u: (o.finish_reason, o.tokens.tolist()) for u, o in to.items()} == \
           {u: (o.finish_reason, o.tokens.tolist()) for u, o in jo.items()}
    assert te.stats()["failed"] == len({f["step"] for f in ti.fired
                                        if f["kind"].endswith("_logits")})
    inj = T.FaultInjector([T.Fault("preempt_storm", 2), T.Fault("preempt_storm", 6)])
    outs, inj, eng = soak(T, 4, injector=inj, page_size=None, prefill_chunk=None)
    assert [f["kind"] for f in inj.fired] == ["preempt_storm"] * 2
    assert eng.preemptions >= 2 and all(o.ok for o in outs.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_unaffected_streams_bit_identical_dense(seed):
    """Non-interference: with routing off, a greedy stream depends on its
    own prompt alone, so every request the matrix did not kill decodes the
    tokens of a fault-free engine."""
    _, _, tc, tp = model_pair(False)
    reqs = _requests(T, np.random.default_rng(seed), 8)
    clean = T.ServingEngine(tp, tc, T.EngineConfig(batch_size=4, ctx=32, page_size=4,
                                                   prefill_chunk=4), device="cpu")
    for r in reqs:
        clean.submit(r)
    baseline = {tuple(o.prompt.tolist()): o.tokens.tolist() for o in clean.run()}
    outs, _, _ = soak_both(seed, mod=False, n_requests=8)
    survivors = [o for o in outs.values() if o.finish_reason != T.FINISH_ERROR]
    assert survivors
    compared = 0
    for o in survivors:
        want = baseline.get(tuple(o.prompt.tolist()))
        if want is None:  # a filler the baseline never saw
            continue
        compared += 1
        assert o.tokens.tolist() == want, f"uid={o.uid} stream diverged under faults"
    assert compared >= len(baseline) - (len(outs) - len(survivors))


def test_seeded_matrix_equals_jax_and_faults_validate():
    for seed in range(5):
        for kw in (dict(), dict(n_faults=9, horizon=12, sleep_s=0.5)):
            j = J.FaultInjector.seeded(seed, **kw)
            t = T.FaultInjector.seeded(seed, **kw)
            assert [vars(f) for f in t.faults] == [vars(f) for f in j.faults]
    inj = T.FaultInjector.seeded(7)
    assert len(inj.faults) == 6 and all(f.step >= 1 for f in inj.faults)
    assert inj.fired == [] and not inj.exhausted
    assert T.FaultInjector().exhausted
    with pytest.raises(ValueError, match="unknown fault kind") as terr:
        T.Fault(kind="cosmic_ray", step=1)
    with pytest.raises(ValueError) as jerr:
        J.Fault(kind="cosmic_ray", step=1)
    assert str(terr.value) == str(jerr.value)


def test_corrupt_logits_targets_a_decoding_row_of_either_layout():
    """(B, V) and (n+1, B, V) host logits: the lowest decoding slot's row
    (or the fault's own slot when it decodes), copied when read-only, and
    deferred while no slot decodes."""
    from repro_torch.serve.scheduler import GENERATE, PREFILL, Slot

    class Eng:
        step_count = 4
        slots = [Slot(0, state=PREFILL), Slot(1, state=GENERATE), Slot(2, state=GENERATE)]

    inj = T.FaultInjector([T.Fault("nan_logits", 2), T.Fault("inf_logits", 3, slot=2),
                           T.Fault("nan_logits", 9)])
    x = np.zeros((4, 3, 5), np.float32)
    x.flags.writeable = False
    y = inj.corrupt_logits(Eng, x)
    assert y is not x and np.isnan(y[:, 1]).all() and np.isinf(y[:, 2]).all()
    assert np.isfinite(y[:, 0]).all() and np.isfinite(x).all()
    assert [f["slot"] for f in inj.fired] == [1, 2] and not inj.exhausted
    Eng.step_count, Eng.slots = 9, [Slot(0, state=PREFILL)]
    z = inj.corrupt_logits(Eng, np.zeros((3, 5), np.float32))
    assert np.isfinite(z).all() and len(inj.fired) == 2  # deferred: nothing decodes
