"""The port's serving engine against the JAX engine (CPU).

Same weights, same 8 greedy requests with mixed prompt lengths, arriving
one every two engine steps into 4 slots: the token streams must be
identical, with whole-prompt and with chunked prefill. The JAX engine runs
backend ``xla`` (its ``xla`` and ``pallas`` backends are bitwise equal,
tests/test_routing_backends.py); the port runs ``pallas``, whose wrappers
take their plain versions on the CPU. Also: the settings of the engine
paths the port does not run yet (speculative, SPMD, overload) raise, with
or without the paged pool they build on (the quantized path's checks are
in tests/test_torch_quant.py).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402


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
    [dict(speculate=2, page_size=16), dict(speculate=2), dict(mesh="data"),
     dict(adaptive_capacity=True), dict(fault_injector=object())],
)
def test_later_engine_paths_raise(setting):
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
