"""The port's MoD routing against the JAX package's, exactly (CPU).

Routing decisions are selections, so they must agree exactly: ``idx``,
``gate`` and ``mask`` are compared bit for bit, with forced ties (equal
scores, inactive slots at ``-inf``, identical decode rows) where
``jax.lax.top_k`` breaks ties toward the lower index. ``execute_routed``
under ``xla`` and ``pallas`` must agree bit for bit with the JAX version
given the same decision and block; every backend name dispatches through
the kernel wrappers.

Router and predictor scores are dot products, which the two frameworks sum
in different orders (a last-bit difference would say nothing about the
routing code). So the inputs here are small dyadic rationals, for which
every partial sum is exact in f32 and the scores agree bit for bit in any
order; the model tests cover routing on ordinary random weights.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402


def _cfgs(ratio=0.125, backend="xla", sampling="predictor"):
    mod = dict(enabled=True, capacity_ratio=ratio, every=2, round_to=1, sampling=sampling,
               predictor_hidden=16, backend=backend)
    jc = dataclasses.replace(JC.smoke_config(JC.get_config("mod-paper-60m")), dtype="float32",
                             mod=JC.MoDConfig(**mod))
    tc = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m")), dtype="float32",
                             mod=TC.MoDConfig(**mod))
    return jc, tc


def _dyadic(rng, shape, scale=8):
    """Values k/scale with small integer k: exact sums in f32."""
    return (rng.integers(-4, 5, shape) / scale).astype(np.float32)


def _router_params(D, h=16, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "router": {"w": _dyadic(rng, D)},
        "predictor": {"w1": _dyadic(rng, (D, h)), "b1": _dyadic(rng, h), "w2": _dyadic(rng, h)},
    }
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: {n: torch.as_tensor(a) for n, a in v.items()} for k, v in p.items()}
    return jp, tp


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _logit_cases():
    rng = np.random.default_rng(0)
    plain = rng.standard_normal((3, 40)).astype(np.float32)
    ties = rng.integers(0, 4, (3, 40)).astype(np.float32)  # many equal scores
    tail = plain.copy()
    tail[:, 29:] = -np.inf  # padded chunk tail
    tail[2, 3:] = -np.inf  # fewer valid tokens than the capacity
    return {"plain": plain, "ties": ties, "neg_inf_tail": tail}


@pytest.mark.parametrize("case", ["plain", "ties", "neg_inf_tail"])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_mod_select_exact(case, k):
    logits = _logit_cases()[case]
    jc, tc = _cfgs()
    j_idx, j_gate, j_mask = JR.mod_select(jnp.asarray(logits), k, jc.mod)
    t_idx, t_gate, t_mask = TR.mod_select(torch.as_tensor(logits), k, tc.mod)
    _eq(t_idx, j_idx)
    _eq(t_gate, j_gate)
    _eq(t_mask, j_mask)


@pytest.mark.parametrize("kb", [1, 3, 8])
def test_batch_select_exact_with_ties(kb):
    scores = np.array([0.5, 2.0, 2.0, -np.inf, 0.5, -np.inf, 2.0, 0.5], np.float32)
    _eq(TR.batch_select(torch.as_tensor(scores), kb), JR.batch_select(jnp.asarray(scores), kb))


@pytest.mark.parametrize("sampling", ["predictor", "aux_loss"])
@pytest.mark.parametrize("active", [None, "some", "few"])
def test_decide_batch_exact(sampling, active):
    jc, tc = _cfgs(ratio=0.25, sampling=sampling)
    B, D = 8, jc.d_model
    rng = np.random.default_rng(1)
    x = _dyadic(rng, (B, 1, D), scale=4)
    x[5] = x[1]  # identical rows: identical scores, a forced tie
    x[6] = x[1]
    act = {None: None,
           "some": np.array([1, 1, 0, 1, 0, 1, 1, 1], bool),
           "few": np.array([0, 0, 1, 0, 0, 0, 0, 0], bool)}[active]  # fewer live rows than kb
    jp, tp = _router_params(D)
    jd = JROUT.decide_batch(jp, jnp.asarray(x), jc, None if act is None else jnp.asarray(act))
    td = TROUT.decide_batch(tp, torch.as_tensor(x), tc, None if act is None else torch.as_tensor(act))
    _eq(td.idx, jd.idx)
    _eq(td.gate, jd.gate)
    _eq(td.mask, jd.mask)
    _eq(td.scores, jd.scores)
    assert TROUT.batch_capacity_k(tc, B) == JROUT.batch_capacity_k(jc, B)


def test_decide_tokens_exact():
    jc, tc = _cfgs(ratio=0.25)
    rng = np.random.default_rng(2)
    x = _dyadic(rng, (2, 24, jc.d_model), scale=4)
    jp, tp = _router_params(jc.d_model, seed=3)
    jd = JROUT.decide_tokens(jp, jnp.asarray(x), jc)
    td = TROUT.decide_tokens(tp, torch.as_tensor(x), tc)
    _eq(td.idx, jd.idx)
    _eq(td.gate, jd.gate)
    _eq(td.mask, jd.mask)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("ratio", [0.125, 0.5, 1.0])
def test_execute_routed_token_topk_bitwise(backend, ratio):
    jc, tc = _cfgs(ratio=ratio, backend=backend)
    B, S, D = 2, 32, jc.d_model
    rng = np.random.default_rng(4)
    x = _dyadic(rng, (B, S, D), scale=4)
    w = (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jp, tp = _router_params(D, seed=5)
    jd = JROUT.decide_tokens(jp, jnp.asarray(x), jc)
    td = TROUT.decide_tokens(tp, torch.as_tensor(x), tc)
    # the same block output on both sides: the test is about dispatch
    sub = np.asarray(jnp.take_along_axis(jnp.asarray(x), jd.idx[..., None], axis=1))
    delta = np.tanh(sub @ w).astype(np.float32)
    seen = {}

    def j_fn(xs, ps):
        seen["j"] = (np.asarray(xs), np.asarray(ps))
        return jnp.asarray(delta), {}

    def t_fn(xs, ps):
        seen["t"] = (xs.numpy(), ps.numpy())
        return torch.as_tensor(delta), {}

    jout, _ = JROUT.execute_routed(jd, jnp.asarray(x), j_fn, jc, jnp.asarray(pos))
    tout, _ = TROUT.execute_routed(td, torch.as_tensor(x), t_fn, tc, torch.as_tensor(pos))
    for a, b in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(a, b)
    _eq(tout, jout)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
def test_token_dispatch_goes_through_the_kernel_wrappers(backend, monkeypatch):
    """Every backend name dispatches through kernels/routing.py, the one
    place that picks the CUDA kernel (card) or its plain version (CPU)."""
    _, tc = _cfgs(ratio=0.25, backend=backend)
    calls = []
    for name in ("gather_rows", "scatter_add_rows"):
        real = getattr(TROUT.KR, name)
        monkeypatch.setattr(TROUT.KR, name,
                            lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    rng = np.random.default_rng(8)
    x = torch.as_tensor(_dyadic(rng, (2, 16, tc.d_model), scale=4))
    _, tp = _router_params(tc.d_model, seed=9)
    dec = TROUT.decide_tokens(tp, x, tc)
    TROUT.execute_routed(dec, x, lambda xs, ps: (torch.tanh(xs), {}), tc)
    assert calls == ["gather_rows", "scatter_add_rows"]


def test_unknown_backend_raises():
    _, tc = _cfgs(backend="triton")
    x = torch.zeros(1, 8, tc.d_model)
    _, tp = _router_params(tc.d_model)
    dec = TROUT.decide_tokens(tp, x, tc)
    with pytest.raises(ValueError, match="backend"):
        TROUT.execute_routed(dec, x, lambda xs, ps: (xs, {}), tc)


def test_route_decode_exact_and_writes_only_routed_rows():
    jc, tc = _cfgs(ratio=0.25)
    B, D = 8, jc.d_model
    rng = np.random.default_rng(6)
    x = _dyadic(rng, (B, 1, D), scale=4)
    active = np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)
    jp, tp = _router_params(D, seed=7)
    cache = {"c": rng.standard_normal((B, 3)).astype(np.float32)}
    delta = rng.standard_normal((B, 1, D)).astype(np.float32)

    def j_fn(xs, ps, cs, dec):
        return jnp.asarray(delta)[dec.idx], {"c": cs["c"] + 1.0}, {}

    def t_fn(xs, ps, cs, dec):
        return torch.as_tensor(delta)[dec.idx], {"c": cs["c"] + 1.0}, {}

    jo, jc_out, jaux = JROUT.route_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                                          j_fn, jc, None, jnp.asarray(active))
    to, tc_out, taux = TROUT.route_decode(tp, torch.as_tensor(x),
                                          {"c": torch.as_tensor(cache["c"])}, t_fn, tc, None,
                                          torch.as_tensor(active))
    _eq(to, jo)
    _eq(tc_out["c"], jc_out["c"])
    for key in ("mod/decode_routed", "mod/decode_routed_frac"):
        _eq(taux[key], jaux[key])


def test_spmd_context_raises():
    _, tc = _cfgs()
    with pytest.raises(NotImplementedError, match="SPMD"):
        TROUT.decide_tokens({}, torch.zeros(1, 4, tc.d_model), tc, spmd=object())
