"""The port's overload control against the JAX package, on the CPU (f32,
greedy, ``tests/helpers.tiny_cfg``'s model, torch on one thread).

The port's counterpart of every case of ``tests/test_overload.py``: the
capacity ladder, the controller's hysteresis and p99 signal, the
scheduler's priority order, batch-tier cap, bounded queue and ``drop``,
deadlines (queued and mid-decode), cancellation, the robustness counters,
degrade and restore, the latency-tier exemption (streams bitwise equal to
an uncontrolled engine), the ragged engine under pressure and the
unsupported combinations. Every engine case runs the JAX engine beside the
port's on the same weights (``params.from_jax_params``) and requests, step
by step, and holds them equal: token streams, finish reasons, error
texts, the step of each lifecycle event, the ``last_step_level`` of every
step and the ``stats()`` counters. Messages of refused settings are JAX's,
word for word. Also: ``PagedCachePool.hold_pages`` / ``release_held``
against the JAX pool, and ``train/serve.py``'s ``greedy_generate`` against
JAX's. Tolerance: none; everything compared is exact (the streams are
greedy argmaxes of logits that agree within 1e-5, and no tie is near).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.core.routing import capacity_ladder as jax_capacity_ladder  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serve.scheduler import Slot as JSlot  # noqa: E402
from repro_torch.core.routing import capacity_ladder  # noqa: E402
from repro_torch.serve.overload import default_levels  # noqa: E402
from repro_torch.serve.scheduler import FREE, PREFILL, Scheduler, Slot  # noqa: E402
from tests.test_torch_paged import model_pair  # noqa: E402

# the stats() keys both engines must agree on (wall times and the p99 of
# wall-clock step latencies are not compared)
COUNTERS = ("steps", "generated_tokens", "finished_requests", "shed", "expired", "cancelled",
            "failed", "prefill_tokens_computed", "mean_occupancy")
CONTROLLER = ("degraded_decode_steps", "capacity_level", "capacity_level_max",
              "capacity_level_changes", "degraded_steps")
PAGED = ("preemptions", "admission_aborts", "pages_in_use", "pages_free", "pages_held",
         "page_utilization_peak", "prefix_hit_rate")


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


class StepClock:
    """A deterministic engine clock: the engine's own step count."""

    def __init__(self):
        self.engine = None

    def __call__(self) -> float:
        return float(self.engine.step_count)


def _prompts(n, L=4, seed=0):
    """Prompts of distinct tokens: a prompt that opens with one token twice
    gives its first two positions hidden states equal to a rounding error at
    the first routed layer, and the two packages break that near-tie of
    the router's top-k differently (router logits one ulp apart, in either
    order); no other input is near a tie."""
    rng = np.random.default_rng(seed)
    return [rng.choice(np.arange(1, 90), size=L, replace=False) for _ in range(n)]


def _request(side, tokens, new, **kw):
    if side is J:
        return J.Request(tokens=np.asarray(tokens, np.int32), max_new_tokens=new, **kw)
    return T.Request(tokens=tokens, max_new_tokens=new, **kw)


def _engine(side, mod=True, ctrl=None, clock=False, **engine):
    """One engine of ``side`` (the JAX package ``J`` or the port ``T``) on
    model_pair's weights; ``ctrl`` = CapacityController kwargs (a fresh
    controller for each engine); ``clock`` = a StepClock bound to it."""
    jc, jp, tc, tp = model_pair(mod)
    if ctrl is not None:
        engine["capacity_controller"] = side.CapacityController(**ctrl)
    if clock:
        engine["clock"] = StepClock()
    if side is J:
        eng = J.ServingEngine(jp, jc, engine=J.EngineConfig(**engine))
    else:
        eng = T.ServingEngine(tp, tc, T.EngineConfig(**engine), device="cpu")
    if clock:
        engine["clock"].engine = eng
    return eng


def _run(eng, actions=None, max_steps=400):
    """Step ``eng`` to drain; ``actions[step]`` runs before that step.
    Returns (the ``last_step_level`` of every step, outputs by uid)."""
    levels = []
    actions = dict(actions or {})
    for _ in range(max_steps):
        if eng.step_count in actions:
            actions.pop(eng.step_count)(eng)
        if not eng.has_work and not actions:
            break
        eng.step()
        levels.append(eng.last_step_level)
        eng.scheduler.check_invariants(eng.slots, len(eng.finished))
    assert not eng.has_work, "engine did not drain"
    outs = {o.uid: (o.finish_reason, o.error, o.tokens.tolist(), o.submitted_step,
                    o.admitted_step, o.first_token_step, o.finished_step)
            for o in eng.finished}
    return levels, outs


def _both(scenario, **kw):
    """Run ``scenario(side, engine)`` on a JAX and a port engine built with
    ``kw`` and hold the two runs equal; returns the port's engine and its
    trace (levels, outputs, whatever the scenario returned)."""
    got = {}
    for side in (J, T):
        eng = _engine(side, **kw)
        got[side] = (eng, scenario(side, eng))
    (jeng, jt), (teng, tt) = got[J], got[T]
    assert tt == jt, "the port's run differs from the JAX engine's"
    ts, js = teng.stats(), jeng.stats()
    keys = COUNTERS + (CONTROLLER if "capacity_level" in js else ()) + (
        PAGED if "preemptions" in js else ())
    for k in keys:
        assert ts[k] == js[k], (k, ts[k], js[k])
    assert teng.last_step_level == jeng.last_step_level
    return teng, tt


def _submit_all(side, eng, prompts, new, **kw):
    return [eng.submit(_request(side, p, new, **kw)) for p in prompts]


# ---------------------------------------------------------------------------
# capacity_ladder (core/routing)
# ---------------------------------------------------------------------------


def test_capacity_ladder_scales_ratio_only():
    jc, _, tc, _ = model_pair(True)
    levels = capacity_ladder(tc, (1.0, 0.5, 0.25))
    assert levels[0] == tc
    assert [lv.mod.capacity_ratio for lv in levels] == [
        lv.mod.capacity_ratio for lv in jax_capacity_ladder(jc, (1.0, 0.5, 0.25))]
    assert [lv.mod.capacity_ratio for lv in levels] == pytest.approx([0.25, 0.125, 0.0625])
    for lv in levels[1:]:
        assert dataclasses.replace(
            lv, mod=dataclasses.replace(lv.mod, capacity_ratio=tc.mod.capacity_ratio)) == tc


def test_capacity_ladder_dense_is_identity():
    tc = model_pair(False)[2]
    assert all(lv == tc for lv in capacity_ladder(tc, default_levels()))
    assert default_levels() == J.overload.default_levels()


@pytest.mark.parametrize("scales", [(), (0.5, 0.25), (1.0, 0.5, 0.5), (1.0, 0.0)],
                         ids=["empty", "not-full", "not-descending", "zero"])
def test_capacity_ladder_validates_scales(scales):
    jc, _, tc, _ = model_pair(True)
    with pytest.raises(ValueError) as jerr:
        jax_capacity_ladder(jc, scales)
    with pytest.raises(ValueError) as terr:
        capacity_ladder(tc, scales)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# CapacityController (host only)
# ---------------------------------------------------------------------------


def test_controller_degrades_after_patience_and_is_bounded():
    c = T.CapacityController(n_levels=3, queue_high=4, queue_low=1,
                             degrade_patience=2, restore_patience=4)
    assert c.observe(10, 0.0) == 0
    assert c.observe(10, 0.0) == 1
    for _ in range(10):
        c.observe(10, 0.0)
    assert c.level == 2 and c.max_level_seen == 2 and c.degraded_steps > 0


def test_controller_hysteresis_band_holds_level():
    c = T.CapacityController(n_levels=3, queue_high=4, queue_low=1,
                             degrade_patience=1, restore_patience=2)
    c.observe(5, 0.0)
    assert c.level == 1
    for _ in range(20):
        assert c.observe(2, 0.0) == 1
    for depth in (0, 2, 0):  # calm, band, calm: the streak is not consecutive
        c.observe(depth, 0.0)
    assert c.level == 1
    c.observe(0, 0.0)
    assert c.level == 0


def test_controller_restore_is_slower_than_degrade():
    c = T.CapacityController(n_levels=2, queue_high=4, queue_low=1,
                             degrade_patience=1, restore_patience=6)
    c.observe(9, 0.0)
    assert c.level == 1
    for i in range(5):
        c.observe(0, 0.0)
        assert c.level == 1, i
    c.observe(0, 0.0)
    assert c.level == 0 and c.level_changes == 2


def test_controller_p99_slo_signal():
    c = T.CapacityController(n_levels=2, queue_high=100, queue_low=1,
                             p99_high_s=0.5, window=8, degrade_patience=1)
    for _ in range(8):
        c.observe(0, 1.0)
    assert c.level == 1 and c.p99() >= 0.5 and c.stats()["step_p99_s"] >= 0.5


@pytest.mark.parametrize("kw", [dict(n_levels=0, queue_high=2, queue_low=1),
                                dict(n_levels=2, queue_high=1, queue_low=1),
                                dict(n_levels=2, queue_high=2, queue_low=1, degrade_patience=0)],
                         ids=["levels", "band", "patience"])
def test_controller_validates(kw):
    with pytest.raises(ValueError) as jerr:
        J.CapacityController(**kw)
    with pytest.raises(ValueError) as terr:
        T.CapacityController(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_walk_equals_jax(seed):
    """A random walk of queue depths and step latencies (an SLO set, a
    short window): every level and the stats equal the JAX controller's."""
    rng = np.random.default_rng(seed)
    kw = dict(n_levels=4, queue_high=6, queue_low=2, p99_high_s=0.7, window=5,
              degrade_patience=2, restore_patience=3)
    j, t = J.CapacityController(**kw), T.CapacityController(**kw)
    for depth, lat in zip(rng.integers(0, 10, 300), rng.exponential(0.3, 300)):
        assert t.observe(int(depth), float(lat)) == j.observe(int(depth), float(lat))
    assert t.stats() == j.stats()


# ---------------------------------------------------------------------------
# Scheduler: priority classes, bounded queue, shedding
# ---------------------------------------------------------------------------


def _sched_reqs(side, n, seed=1, **kw):
    return [_request(side, p, 8, **kw) for p in _prompts(n, seed=seed)]


def test_scheduler_priority_class_orders_admission():
    sched = Scheduler(4, policy="fcfs")
    for i, r in enumerate(_sched_reqs(T, 3)):
        r.uid = i
        sched.submit(r)
    lat = _sched_reqs(T, 1, seed=2, priority=T.PRIORITY_LATENCY)[0]
    lat.uid = 99
    sched.submit(lat)
    plans = sched.plan_admissions([Slot(i) for i in range(4)], stepped_prefill=False)
    assert [r.uid for _, r in plans] == [99, 0, 1, 2]


def test_scheduler_batch_cap_spares_latency_tier():
    sched = Scheduler(4, policy="fcfs")
    for i, r in enumerate(_sched_reqs(T, 3)):
        r.uid = i
        sched.submit(r)
    lat = _sched_reqs(T, 1, seed=2, priority=T.PRIORITY_LATENCY)[0]
    lat.uid = 99
    sched.submit(lat)
    plans = sched.plan_admissions([Slot(i) for i in range(4)], stepped_prefill=False, batch_cap=1)
    assert [r.uid for _, r in plans] == [99, 0]
    assert [r.uid for r in sched.queue] == [1, 2]


def test_scheduler_queue_full_and_drop_balance_invariants():
    sched = Scheduler(2, max_queue=2)
    r0, r1 = _sched_reqs(T, 2)
    sched.submit(r0)
    sched.submit(r1)
    assert sched.queue_full
    sched.drop(r0)
    sched.check_invariants([Slot(0), Slot(1)], finished=1)
    assert not sched.queue_full
    with pytest.raises(ValueError, match="not queued"):
        sched.drop(r0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_waves_equal_jax(seed):
    """Random submissions (latency and batch tiers, a bounded queue), waves
    under page gates, batch-tier caps and the mod_aware prefill cap,
    requeues of running requests and drops: every wave's plan, the queue's
    order and the books equal the JAX scheduler's."""
    rng = np.random.default_rng(seed)
    scheds = {J: JScheduler(6, policy="mod_aware", routed_capacity=2, max_queue=9),
              T: Scheduler(6, policy="mod_aware", routed_capacity=2, max_queue=9)}
    slots = {J: [JSlot(i) for i in range(6)], T: [Slot(i) for i in range(6)]}
    dropped, uid = 0, 0
    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            for _ in range(int(rng.integers(1, 4))):
                prio = "latency" if rng.random() < 0.3 else "batch"
                toks = rng.integers(1, 90, size=int(rng.integers(1, 9)))
                full = {side: scheds[side].queue_full for side in (J, T)}
                assert full[T] == full[J]
                if not full[T]:
                    for side in (J, T):
                        r = _request(side, toks, 4, priority=prio)
                        r.uid = uid
                        scheds[side].submit(r)
                    uid += 1
        elif op == 1:
            cap = None if rng.random() < 0.5 else int(rng.integers(0, 3))
            stepped = bool(rng.random() < 0.5)
            limit = int(rng.integers(1, 9))
            plan = {}
            for side in (J, T):
                got = scheds[side].plan_admissions(
                    slots[side], stepped_prefill=stepped,
                    page_gate=lambda r: r.prompt_len <= limit, batch_cap=cap)
                for s, r in got:
                    s.state, s.req = (PREFILL if stepped else "generate"), r
                plan[side] = [(s.idx, r.uid) for s, r in got]
            assert plan[T] == plan[J]
        elif op == 2:
            busy = [s.idx for s in slots[T] if s.state != FREE]
            if busy:
                i = int(rng.choice(busy))
                for side in (J, T):
                    scheds[side].requeue(slots[side][i].req)
                    slots[side][i].state, slots[side][i].req = FREE, None
        elif scheds[T].queue:
            k = int(rng.integers(0, len(scheds[T].queue)))
            for side in (J, T):
                scheds[side].drop(scheds[side].queue[k])
            dropped += 1
        assert [r.uid for r in scheds[T].queue] == [r.uid for r in scheds[J].queue]
        assert (scheds[T].admitted, scheds[T].submitted) == (scheds[J].admitted,
                                                              scheds[J].submitted)
        scheds[T].check_invariants(slots[T], dropped)


# ---------------------------------------------------------------------------
# Engine: backpressure, deadlines, cancellation, counters
# ---------------------------------------------------------------------------


def test_submit_rejects_elapsed_deadline_and_bad_priority():
    for deadline in (0.0, -1.0):
        errs = []
        for side in (J, T):
            eng = _engine(side, batch_size=2, ctx=16)
            with pytest.raises(ValueError, match="deadline") as err:
                eng.submit(_request(side, [1, 2, 3], 4, deadline_s=deadline))
            errs.append(str(err.value))
        assert errs[0] == errs[1]
    errs = []
    for side in (J, T):
        with pytest.raises(ValueError, match="priority") as err:
            _request(side, [1, 2], 1, priority="vip")
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_submit_backpressure_rejects_with_reason():
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(3), 8)
        with pytest.raises(side.EngineOverloaded, match="max_queue") as err:
            eng.submit(_request(side, _prompts(1, seed=9)[0], 8))
        assert eng.stats()["shed"] == 1.0
        eng.scheduler.check_invariants(eng.slots, len(eng.finished))
        trace = _run(eng)
        assert len(trace[1]) == 3 and all(o[0] in ("eos", "length") for o in trace[1].values())
        return str(err.value), err.value.reason, trace

    _both(scenario, batch_size=2, ctx=16, max_queue=3)


def test_deadline_expiry_queued_vs_mid_decode():
    """Expiry while queued sheds without prefill (no tokens, first token
    step -1, admitted == finished); expiry mid-decode keeps the partial
    stream."""
    def queued(side, eng):
        eng.submit(_request(side, _prompts(1, seed=3)[0], 12))
        doomed = eng.submit(_request(side, _prompts(1, seed=4)[0], 4, deadline_s=4.0))
        trace = _run(eng)
        reason, error, toks, _, adm, first, fin = trace[1][doomed]
        assert reason == "expired" and toks == [] and first == -1 and adm == fin
        assert "queued" in error
        return trace

    def mid(side, eng):
        uid = eng.submit(_request(side, _prompts(1, seed=5)[0], 20, deadline_s=6.0))
        trace = _run(eng)
        reason, _, toks, *_ = trace[1][uid]
        assert reason == "expired" and 0 < len(toks) < 20
        assert eng.stats()["expired"] == 1.0
        return trace

    _both(queued, batch_size=1, ctx=32, clock=True)
    _both(mid, batch_size=1, ctx=32, clock=True)


def test_cancellation_queued_and_running():
    def scenario(side, eng):
        running, queued = _submit_all(side, eng, _prompts(2, seed=6), 10)
        eng.step()
        assert eng.cancel(running) and eng.cancel(queued)
        assert not eng.cancel(12345)
        trace = _run(eng)
        assert trace[1][running][0] == "cancelled" and len(trace[1][running][2]) > 0
        assert trace[1][queued][0] == "cancelled" and trace[1][queued][2] == []
        st = eng.stats()
        assert st["cancelled"] == 2.0 and st["shed"] == 1.0
        assert not eng.cancel(running)  # finished: cancellation races completion
        return trace

    _both(scenario, batch_size=1, ctx=32)


def test_stats_counters_always_present_and_monotone():
    def scenario(side, eng):
        st = eng.stats()
        assert all(st[k] == 0.0 for k in ("shed", "expired", "cancelled", "failed"))
        _submit_all(side, eng, _prompts(2), 2)
        trace = _run(eng)
        st2 = eng.stats()
        assert all(st2[k] >= st[k] for k in ("shed", "expired", "cancelled", "failed"))
        assert "degraded_decode_steps" not in st2 and "capacity_level" not in st2
        return trace

    _both(scenario, batch_size=2, ctx=16)


def test_request_output_error_surfaces_in_ok():
    _, _, tc, tp = model_pair(True)
    eng = T.ServingEngine(tp, tc, T.EngineConfig(batch_size=1, ctx=16), device="cpu")
    eng.submit(T.Request(tokens=_prompts(1)[0], max_new_tokens=2))
    out = eng.run()[0]
    assert out.ok and out.error is None and out.finish_reason in (T.FINISH_EOS, T.FINISH_LENGTH)
    bad = dataclasses.replace(out, finish_reason=T.FINISH_ERROR, error="non-finite logits")
    assert not bad.ok
    assert not dataclasses.replace(out, error="set beside a success reason").ok


# ---------------------------------------------------------------------------
# Engine: the adaptive capacity ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", [dict(), dict(page_size=4, prefix_cache=True)],
                         ids=["padded", "paged-prefix"])
def test_adaptive_engine_degrades_and_restores(engine):
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(12, seed=7), 10)
        trace = _run(eng)
        assert len(trace[1]) == 12 and all(o[0] in ("eos", "length") for o in trace[1].values())
        st = eng.stats()
        assert st["capacity_level_max"] >= 1.0 and st["degraded_decode_steps"] >= 1.0
        assert st["capacity_level"] == 0.0
        assert max(trace[0]) >= 1 and trace[0][-1] == 0
        return trace

    ctrl = dict(n_levels=3, queue_high=4, queue_low=1, degrade_patience=1, restore_patience=3)
    _both(scenario, batch_size=2, ctx=32, ctrl=ctrl, **engine)


def test_adaptive_level_picks_the_ladder_kb():
    """At 8 slots and ratio 0.25, levels 0/1/2 decode with kb 2/1/1: the
    routed fraction of every step is kb/B of its level."""
    seen = []
    _, _, tc, tp = model_pair(True)
    ctrl = T.CapacityController(n_levels=3, queue_high=4, queue_low=1, degrade_patience=1,
                                restore_patience=2)
    eng = T.ServingEngine(tp, tc, T.EngineConfig(batch_size=8, ctx=32, capacity_controller=ctrl),
                          device="cpu")
    real = eng._advance

    def advance(slots, logits_np, aux_np):
        seen.append((eng.last_step_level, float(aux_np["mod/decode_routed"].sum())))
        return real(slots, logits_np, aux_np)

    eng._advance = advance
    for p in _prompts(30, seed=2):
        eng.submit(T.Request(tokens=p, max_new_tokens=6))
    eng.run()
    kb = {lvl: max(1, round(0.25 * s * 8)) for lvl, s in enumerate(default_levels())}
    # decode_routed is the mean over the routed groups of each row's flag
    assert {lvl for lvl, _ in seen} == {0, 1, 2}
    assert all(n == pytest.approx(kb[lvl]) for lvl, n in seen)


def test_adaptive_latency_tier_streams_bit_identical():
    """Latency-tier requests decode at level 0 while the controller is
    degraded, so their streams equal an uncontrolled engine's exactly."""
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(6, seed=8), 8, priority="latency")
        return _run(eng)

    _, base = _both(scenario, batch_size=2, ctx=32)
    ctrl = dict(n_levels=3, queue_high=2, queue_low=0, degrade_patience=1, restore_patience=99)
    teng, got = _both(scenario, batch_size=2, ctx=32, ctrl=ctrl)
    assert {u: o[2] for u, o in got[1].items()} == {u: o[2] for u, o in base[1].items()}
    st = teng.stats()
    assert st["capacity_level_max"] >= 1.0 and st["degraded_decode_steps"] == 0.0
    assert set(got[0]) == {0}


def test_adaptive_mixed_tiers_cap_batch_admissions():
    """Latency and batch tiers interleaved on the paged + prefix engine: a
    step with a latency-tier slot active decodes at level 0, batch-tier
    admission waves shrink by the level's scale, and everything equals
    JAX."""
    def scenario(side, eng):
        for i, p in enumerate(_prompts(14, L=6, seed=11)):
            eng.submit(_request(side, p, 6, priority="latency" if i % 4 == 3 else "batch"))
        admitted = []
        real = eng.scheduler.plan_admissions

        def plan(*a, **kw):
            out = real(*a, **kw)
            admitted.append((kw.get("batch_cap"), [r.priority for _, r in out]))
            return out

        eng.scheduler.plan_admissions = plan
        trace = _run(eng)
        for cap, prios in admitted:
            if cap is not None:
                assert sum(p == "batch" for p in prios) <= cap
        return trace, admitted

    ctrl = dict(n_levels=3, queue_high=4, queue_low=1, degrade_patience=1, restore_patience=3)
    teng, (trace, admitted) = _both(scenario, batch_size=4, ctx=32, page_size=4,
                                    prefix_cache=True, ctrl=ctrl)
    assert any(cap is not None for cap, _ in admitted) and max(trace[0]) >= 1


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_adaptive_ragged_engine_serves_under_pressure(mod):
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(10, L=8, seed=9), 6)
        trace = _run(eng)
        assert len(trace[1]) == 10 and all(o[0] in ("eos", "length") for o in trace[1].values())
        assert eng.stats()["capacity_level_max"] >= 1.0
        return trace

    ctrl = dict(n_levels=2, queue_high=3, queue_low=1, degrade_patience=1, restore_patience=4)
    teng, trace = _both(scenario, mod=mod, batch_size=2, ctx=32, page_size=4, prefill_chunk=4,
                        ragged=True, ctrl=ctrl)
    if not mod:  # a MoD-less ladder degrades only the admission budget
        assert set(trace[0]) == {0} and teng.stats()["degraded_decode_steps"] == 0.0


def test_adaptive_stepped_ingestion_engine():
    """Stepped prompt ingestion (``prefill="step"``): prompts feed through
    the degraded decode step too; equal to JAX."""
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(8, L=5, seed=12), 5)
        return _run(eng)

    ctrl = dict(n_levels=3, queue_high=3, queue_low=1, degrade_patience=1, restore_patience=2)
    _, trace = _both(scenario, batch_size=2, ctx=16, prefill="step", ctrl=ctrl)
    assert max(trace[0]) >= 1


def test_default_controller_and_custom_levels():
    """``adaptive_capacity=True`` arms the default controller (queue_high
    2B, queue_low B/2) over ``capacity_levels``."""
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(16, seed=13), 4)
        return _run(eng)

    teng, trace = _both(scenario, batch_size=2, ctx=16, adaptive_capacity=True,
                        capacity_levels=(1.0, 0.6, 0.3, 0.1))
    assert teng._controller.n_levels == 4 and teng._controller.queue_high == 4
    assert max(trace[0]) >= 1


def test_adaptive_rejects_unsupported_combinations():
    jc, jp, tc, tp = model_pair(True)
    kw = dict(batch_size=2, ctx=32, page_size=4, prefill_chunk=4, speculate=2,
              adaptive_capacity=True)
    with pytest.raises(NotImplementedError, match="speculate") as jerr:
        J.ServingEngine(jp, jc, engine=J.EngineConfig(**kw))
    with pytest.raises(NotImplementedError, match="speculate") as terr:
        T.ServingEngine(tp, tc, T.EngineConfig(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="adaptive_capacity") as jerr:
        J.EngineConfig(batch_size=2, ctx=32, capacity_levels=(1.0, 0.5))
    with pytest.raises(ValueError, match="adaptive_capacity") as terr:
        T.EngineConfig(batch_size=2, ctx=32, capacity_levels=(1.0, 0.5))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="mesh"):  # not a DeviceMesh
        T.EngineConfig(batch_size=2, ctx=32, mesh="data", adaptive_capacity=True)
    with pytest.raises(ValueError, match="descend"):
        T.ServingEngine(tp, tc, T.EngineConfig(batch_size=2, ctx=32, adaptive_capacity=True,
                                               capacity_levels=(1.0, 0.5, 0.7)), device="cpu")


def test_logit_tap_sees_every_decode_step():
    def scenario(side, eng):
        _submit_all(side, eng, _prompts(5, L=6, seed=14), 5)
        return _run(eng)

    for engine in (dict(), dict(page_size=4, prefill_chunk=4, ragged=True)):
        taps = {}
        for side in (J, T):
            seen = []
            eng = _engine(side, batch_size=2, ctx=16, logit_tap=lambda x: seen.append(
                np.array(x)), **engine)
            scenario(side, eng)
            taps[side] = seen
        assert len(taps[T]) == len(taps[J]) > 0
        for a, b in zip(taps[T], taps[J]):
            assert a.shape == b.shape == (2, model_pair(True)[2].vocab)
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_mixed_lifecycle_on_the_paged_prefix_engine():
    """13a's first run at test size: the paged + prefix engine under an
    explicit controller and a step clock, latency and batch tiers, one
    deadline that expires while queued and one mid-decode, one
    cancellation and one ``max_queue`` rejection."""
    def scenario(side, eng):
        rng = np.random.default_rng(15)
        shared = rng.integers(1, 90, size=8)
        uids = []
        for i in range(9):
            toks = np.concatenate([shared, rng.integers(1, 90, size=int(rng.integers(1, 6)))])
            kw = dict(priority="latency" if i in (2, 6) else "batch")
            if i == 7:
                kw["deadline_s"] = 3.0  # expires while queued
            if i == 2:
                kw["deadline_s"] = 5.0  # admitted first, expires mid-decode
            uids.append(eng.submit(_request(side, toks, 8, **kw)))
        with pytest.raises(side.EngineOverloaded) as err:
            eng.submit(_request(side, shared, 4))
        trace = _run(eng, {2: lambda e: e.cancel(uids[4])})
        out = {u: trace[1][u] for u in uids}
        assert out[uids[7]][0] == "expired" and out[uids[7]][2] == []
        assert out[uids[2]][0] == "expired" and 0 < len(out[uids[2]][2]) < 8
        assert out[uids[4]][0] == "cancelled" and out[uids[4]][2] == []
        assert sum(o[0] in ("eos", "length") for o in out.values()) == 6
        return str(err.value), trace

    ctrl = dict(n_levels=3, queue_high=4, queue_low=1, degrade_patience=1, restore_patience=3)
    teng, _ = _both(scenario, batch_size=2, ctx=32, page_size=4, prefix_cache=True,
                    max_queue=9, clock=True, ctrl=ctrl)
    st = teng.stats()
    # shed: the rejection and the two requests that left the queue
    assert (st["shed"], st["expired"], st["cancelled"]) == (3.0, 2.0, 1.0)
    assert st["prefix_hit_rate"] > 0 and st["capacity_level_max"] >= 1.0


# ---------------------------------------------------------------------------
# Pool holds, train/serve.py
# ---------------------------------------------------------------------------


def test_hold_pages_and_release_equal_the_jax_pool():
    from repro.serve.cache import PagedCachePool as JPool
    from tests.test_paged_properties import _check

    jc, _, tc, _ = model_pair(False)
    jp = JPool(jc, 2, 16, 4, n_pages=8, prefix_chunk=4)
    tp = T.PagedCachePool(tc, 2, 16, 4, torch.device("cpu"), n_pages=8, prefix_chunk=4)
    for pool in (jp, tp):
        pool.acquire(0)
        assert pool.alloc_pages(0, 8)
    assert tp.hold_pages(3) == jp.hold_pages(3) == 3
    assert tp.available_pages() == jp.available_pages() == 1
    assert tp.allocatable_pages == jp.allocatable_pages == 6
    assert tp.hold_pages(5) == jp.hold_pages(5) == 1  # only what is obtainable
    assert tp.held == jp.held
    tp.check_invariants()
    _check(jp)
    for pool in (jp, tp):
        pool.acquire(1)
        assert not pool.alloc_pages(1, 4)
    assert tp.page_stats()["pages_held"] == jp.page_stats()["pages_held"] == 4.0
    assert tp.release_held() == jp.release_held() == 4
    assert list(tp.free) == list(jp.free) and tp.held == []
    tp.check_invariants()
    tp.held.append(tp.free[0])  # a page both held and free breaks the books
    with pytest.raises(AssertionError, match="held page still on the free list"):
        tp.check_invariants()


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_greedy_generate_equals_jax(mod):
    from repro.train.serve import greedy_generate as jax_generate
    from repro_torch.train.serve import greedy_generate

    jc, jp, tc, tp = model_pair(mod)
    prompts = np.stack(_prompts(3, L=5, seed=16))
    want = np.asarray(jax_generate(jp, jc, jax.numpy.asarray(prompts, jax.numpy.int32), 6))
    got = greedy_generate(tp, tc, prompts, 6, device="cpu")
    assert got.shape == (3, 11)
    np.testing.assert_array_equal(got, want)


def test_make_serve_step_equals_jax():
    from repro.train.serve import make_serve_step as jax_step
    from repro.models import api as JAPI
    from repro_torch.models import api as TAPI
    from repro_torch.train.serve import make_serve_step

    jc, jp, tc, tp = model_pair(True)
    tok = np.asarray([[5], [9]], np.int32)
    pos = np.asarray([0, 0], np.int32)
    jl, _, _ = jax_step(jc)(jp, JAPI.make_caches(jc, 2, 8), tok, pos)
    tl, _, _ = make_serve_step(tc)(tp, TAPI.make_caches(tc, 2, 8, "cpu"),
                                   torch.as_tensor(tok).long(), torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
