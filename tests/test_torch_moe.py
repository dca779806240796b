"""The port's token-choice MoE (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU, torch on one thread.

- Routing: the same weights and inputs give JAX's top-k experts, queue
  positions, kept set and dispatch index, exactly: with and without no-op
  experts (integrated MoDE), with capacity binding (``capacity_factor``
  0.1) and not, at decode's S = 1, and with forced ties (duplicated router
  columns: the lower expert index wins, as ``jax.lax.top_k`` breaks them).
- The combine is JAX's scatter-add order bit for bit: on the same expert
  outputs and routing, the port's gather-and-sum equals
  ``zeros.at[b, disp].add(ye_g)`` (JAX ``moe.py:101-104``) in f32 and with
  ``combine_dtype="bfloat16"``.
- ``moe_mlp`` end to end: ``drop_frac`` and ``noop_frac`` exactly; out within
  1e-6 (+1e-5 relative) and ``lb_loss``/``z_loss`` within 1e-6 relative in
  f32. Not bitwise: XLA's ``exp`` and its GEMM sum order differ from
  torch's in the last f32 bit (~10% of ``exp`` results, most GEMM
  outputs), so the router probabilities and expert outputs differ by an
  ulp before the combine. With a bf16 combine the outputs round to the
  same bits. A bf16 model is held within the MLP sublayer bound of
  ``tests/test_torch_bf16.py``: 2^-6 of the largest value, at most 0.5% of
  entries differing.
- Gradients of a loss over out and both aux losses, for the router,
  the three expert weights and x, within 1e-5 of ``jax.grad``.
- ``expert_capacity`` over a table of lengths; ``n_params`` and
  ``active_params_per_token`` of the five registered MoE configs and their
  smoke sizes; the registered configs equal JAX's field for field.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

MOE_ARCHS = ["olmoe-1b-7b", "olmoe-1b-7b-dense", "phi3.5-moe-42b-a6.6b", "phi3.5-moe-imode",
             "phi3.5-moe-dense"]
ATOL, RTOL = 1e-6, 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(E=4, k=2, cf=1.25, noop=0, combine="float32", D=64, F=32, dtype="float32"):
    kw = dict(name="t", family="moe", n_layers=2, d_model=D, d_ff=128, vocab=97,
              dtype=dtype)
    moe = dict(enabled=True, n_experts=E, top_k=k, d_ff_expert=F, capacity_factor=cf,
               n_noop_experts=noop, combine_dtype=combine)
    return (JC.ModelConfig(**kw, attn=JC.AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
                           moe=JC.MoEConfig(**moe)),
            TC.ModelConfig(**kw, attn=TC.AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
                           moe=TC.MoEConfig(**moe)))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _setup(jc, B=2, S=32, seed=0, scale=0.5, params=None):
    jp = params if params is not None else JMOE.init_moe(jax.random.PRNGKey(seed), jc)
    x = (np.random.default_rng(seed).standard_normal((B, S, jc.d_model)) * scale)
    x = x.astype(ml_dtypes.bfloat16 if jc.dtype == "bfloat16" else np.float32)
    tp = {n: _to_torch(v) for n, v in jp.items()}
    return jp, jnp.asarray(x), tp, _to_torch(x)


def _jax_routing(jp, x, jc):
    """JAX ``moe_mlp``'s routing lines (moe.py:63-84) on JAX's own logits:
    top-k, choice-major positions, the kept set and the dispatch index."""
    B, S, _ = x.shape
    E, k = jc.moe.n_experts, jc.moe.top_k
    C = JMOE.expert_capacity(S, jc)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router_w"], axis=-1)
    gate, sel = jax.lax.top_k(probs, k)
    sel_f = jnp.swapaxes(sel, 1, 2).reshape(B, k * S)
    tok_f = jnp.tile(jnp.arange(S, dtype=jnp.int32), (B, k))
    onehot = jax.nn.one_hot(sel_f, E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    keep = (sel_f < E) & (pos >= 0) & (pos < C)
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    disp = jnp.full((B, E + 1, C + 1), S, jnp.int32)
    disp = disp.at[bidx, jnp.where(keep, sel_f, E), jnp.where(keep, pos, C)].set(tok_f)
    return {"sel": sel_f, "pos": pos, "keep": keep, "disp": disp[:, :E, :C]}


CASES = {
    "base": dict(),
    "noop2": dict(noop=2),
    "binding": dict(cf=0.1),
    "binding-noop2": dict(cf=0.1, noop=2),
    "unlimited": dict(cf=100.0),
    "combine-bf16": dict(combine="bfloat16"),
    "binding-bf16": dict(cf=0.1, combine="bfloat16"),
    "olmoe-shape": dict(E=64, k=8, D=128, F=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_equals_jax_exactly(case):
    jc, tc = _cfgs(**CASES[case])
    jp, jx, tp, tx = _setup(jc)
    want = _jax_routing(jp, jx, jc)
    r = TMOE.route(tp, tx, tc)
    for name in ("sel", "pos", "keep", "disp"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), np.asarray(want[name]),
                                      err_msg=name)
    if jc.moe.capacity_factor < 1:
        assert not bool(r.keep[r.sel < jc.moe.n_experts].all()), "capacity must bind here"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("S", [32, 1], ids=["train", "decode"])
def test_moe_mlp_matches_jax(case, S):
    jc, tc = _cfgs(**CASES[case])
    jp, jx, tp, tx = _setup(jc, B=4 if S == 1 else 2, S=S)
    jo, ja = jax.jit(lambda p, x: JMOE.moe_mlp(p, x, jc))(jp, jx)
    to, ta = TMOE.moe_mlp(tp, tx, tc)
    assert to.shape == tx.shape and to.dtype == tx.dtype
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL, rtol=RTOL)
    if jc.moe.combine_dtype == "bfloat16":
        np.testing.assert_array_equal(_np(to), np.asarray(jo))
    assert set(ta) == set(ja)
    for key in ("moe/drop_frac", "moe/noop_frac"):
        if key in ja:
            assert float(ta[key]) == float(ja[key]), key
    for key in ("moe/lb_loss", "moe/z_loss"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), rtol=1e-6, err_msg=key)
    assert ("moe/noop_frac" in ta) == (jc.moe.n_noop_experts > 0)


@pytest.mark.parametrize("combine", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.1, 1.25, 100.0])
def test_combine_is_the_jax_scatter_order_bitwise(combine, cf):
    """Same expert outputs, same routing: the port's per-token gather and
    ascending-expert sum gives the bits of JAX's scatter-add."""
    jc, tc = _cfgs(E=8, k=4, cf=cf, noop=1, combine=combine)
    jp, jx, tp, tx = _setup(jc, B=3, S=40)
    r = TMOE.route(tp, tx, tc)
    B, S = 3, 40
    E, C = r.disp.shape[1], r.disp.shape[2]
    ye = np.random.default_rng(5).standard_normal((B, E, C, jc.d_model)).astype(np.float32)
    # JAX moe.py:80-84 and 101-104 on the port's routing
    sel, pos, keep = (jnp.asarray(t.numpy()) for t in (r.sel, r.pos, r.keep))
    gate = jnp.asarray(r.gate.numpy())
    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    slot_gate = jnp.zeros((B, E + 1, C + 1), jnp.float32).at[
        bidx, jnp.where(keep, sel, E), jnp.where(keep, pos, C)].set(
        jnp.where(keep, gate, 0.0))[:, :E, :C]
    cdt = jnp.dtype(combine)
    ye_g = (jnp.asarray(ye) * slot_gate[..., None]).astype(cdt)
    want = jnp.zeros((B, S + 1, jc.d_model), cdt).at[
        bidx[:, :, None], jnp.asarray(r.disp.numpy())].add(ye_g)[:, :S].astype(jnp.float32)
    got = TMOE.combine(torch.from_numpy(ye).transpose(0, 1).reshape(E, B * C, -1), r, S,
                       torch.float32, getattr(torch, combine))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forced_ties_pick_the_lower_expert():
    """Duplicated router columns give exactly equal probabilities: both
    packages pick the lower index first, and the output still agrees."""
    jc, tc = _cfgs(E=6, k=2, noop=2)
    jp = dict(JMOE.init_moe(jax.random.PRNGKey(3), jc))
    w = np.asarray(jp["router_w"]).copy()
    w[:, 3] = w[:, 1]  # experts 1 and 3 always tie
    w[:, 7] = w[:, 0]  # a no-op expert ties expert 0
    jp["router_w"] = jnp.asarray(w)
    jp, jx, tp, tx = _setup(jc, params=jp)
    r = TMOE.route(tp, tx, tc)
    want = _jax_routing(jp, jx, jc)
    np.testing.assert_array_equal(r.sel.numpy(), np.asarray(want["sel"]))
    np.testing.assert_array_equal(r.disp.numpy(), np.asarray(want["disp"]))
    sel = r.sel.numpy()
    assert ((sel == 1) | (sel == 3)).any()
    both = ((sel.reshape(2, 2, -1) == 1).any(1) & (sel.reshape(2, 2, -1) == 3).any(1))
    first = sel.reshape(2, 2, -1)[:, 0]
    assert (first[both] == 1).all(), "a tie must put the lower expert first"
    jo, ja = JMOE.moe_mlp(jp, jx, jc)
    to, ta = TMOE.moe_mlp(tp, tx, tc)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=ATOL, rtol=RTOL)
    assert float(ta["moe/noop_frac"]) == float(ja["moe/noop_frac"])


@pytest.mark.parametrize("case", ["base", "noop2", "binding", "combine-bf16"])
def test_gradients_match_jax(case):
    jc, tc = _cfgs(**CASES[case])
    jp, jx, tp, tx = _setup(jc, B=2, S=16)
    wo = np.random.default_rng(1).standard_normal((2, 16, jc.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = JMOE.moe_mlp(p, x, jc)
        return jnp.sum(out * wo) + aux["moe/lb_loss"] + 0.1 * aux["moe/z_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    tx = tx.requires_grad_(True)
    out, aux = TMOE.moe_mlp(tp, tx, tc)
    (torch.sum(out * torch.from_numpy(wo)) + aux["moe/lb_loss"] + 0.1 * aux["moe/z_loss"]
     ).backward()
    for name in ("router_w", "w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(_np(tp[name].grad), np.asarray(jg[name]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
        assert float(np.abs(np.asarray(jg[name])).sum()) > 0, name
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("shape", [(4, 2, 64, 32), (64, 8, 128, 64)], ids=["e4k2", "e64k8"])
@pytest.mark.parametrize("combine", ["float32", "bfloat16"])
def test_bf16_model_within_the_sublayer_bound(shape, combine):
    E, k, D, F = shape
    jc, tc = _cfgs(E=E, k=k, D=D, F=F, combine=combine, dtype="bfloat16")
    jp, jx, tp, tx = _setup(jc, S=64, scale=1.0)
    jo, ja = jax.jit(lambda p, x: JMOE.moe_mlp(p, x, jc))(jp, jx)
    to, ta = TMOE.moe_mlp(tp, tx, tc)
    assert to.dtype == torch.bfloat16
    jo = np.asarray(jo).astype(np.float32)
    d = np.abs(_np(to) - jo)
    assert d.max() <= 2.0**-6 * np.abs(jo).max()
    assert (d > 0).mean() <= 0.005
    assert float(ta["moe/drop_frac"]) == float(ja["moe/drop_frac"])


def test_empty_batch_is_a_no_op():
    """Decode at draft ratio 0 routes no row: the routed block's MoE gets
    (0, 1, D)."""
    _, tc = _cfgs()
    tp = TMOE.init_moe(torch.Generator().manual_seed(0), tc, torch.device("cpu"))
    out, _ = TMOE.moe_mlp(tp, torch.zeros(0, 1, tc.d_model), tc)
    assert out.shape == (0, 1, tc.d_model)


LENGTHS = [0, 1, 2, 5, 7, 8, 9, 16, 31, 32, 51, 52, 64, 100, 128, 256, 512, 1000, 2048, 4096]


@pytest.mark.parametrize("arch", MOE_ARCHS + ["tiny-default"])
def test_expert_capacity_matches_jax(arch):
    if arch == "tiny-default":  # family="moe" with the default MoEConfig
        jc, tc = (dataclasses.replace(JC.ModelConfig(), family="moe"),
                  dataclasses.replace(TC.ModelConfig(), family="moe"))
    else:
        jc, tc = JC.get_config(arch), TC.get_config(arch)
    for c in (jc, JC.smoke_config(jc)):
        t = tc if c is jc else TC.smoke_config(tc)
        got = [TMOE.expert_capacity(S, t) for S in LENGTHS]
        assert got == [JMOE.expert_capacity(S, c) for S in LENGTHS]
    # olmoe: decode (S=1) gets one slot, a 256-token chunk 40, a 2048-token
    # sequence 320, its routed 256-token sub-sequence 40
    if arch == "olmoe-1b-7b":
        assert [TMOE.expert_capacity(S, tc) for S in (1, 256, 2048)] == [1, 40, 320]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_registered_configs_and_param_counts_equal_jax(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    for j, t in ((jc, tc), (JC.smoke_config(jc), TC.smoke_config(tc))):
        for f in dataclasses.fields(TC.MoEConfig):
            assert getattr(t.moe, f.name) == getattr(j.moe, f.name), f.name
        for f in dataclasses.fields(TC.MoDConfig):
            assert getattr(t.mod, f.name) == getattr(j.mod, f.name), f.name
        for name in ("name", "family", "n_layers", "d_model", "d_ff", "vocab", "dtype", "remat"):
            assert getattr(t, name) == getattr(j, name), name
        assert t.n_params() == j.n_params()
        assert t.active_params_per_token() == j.active_params_per_token()
    assert tc.uses_moe and tc.active_params_per_token() < tc.n_params()
