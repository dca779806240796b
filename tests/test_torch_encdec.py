"""The port's enc-dec family (``family="encdec"``, whisper-tiny) against the
JAX package, on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``), same
inputs from a numpy seed, in f32 unless a test says otherwise. The config
is ``smoke_config`` of whisper-tiny (4 decoder layers, MoD every 2, 2
encoder layers over 64 frames, a plain GELU MLP) and its MoD-off twin:

- the configs field for field, ``n_params()`` of the full configs equal
  JAX's (0.05643B); ``from_jax_params`` / ``to_numpy_tree`` carry
  ``enc_blocks`` (stacked over the encoder layers) and the decoder groups
  (``xattn``, ``lnx``) both ways bitwise at f32 and bf16;
- ``jax.nn.gelu`` mirrored: bit-equal at bf16 (``F.gelu`` is not), within
  XLA's ``tanh`` at f32, its gradient within 1e-5 (2e-5 absolute where
  XLA's ``tanh`` saturates);
- ``encode`` within 1e-5, the forward's logits within 1e-5 of their
  largest, routed masks exactly, aux and loss within 1e-5, every gradient
  leaf within 1e-4 of the leaf's largest |grad| under ``pallas`` (the
  port's ``xla`` runs the same path) and ``pallas_fused`` (the routed block
  falls back to gather/scatter) and remat ``none`` / ``full``; three
  Trainer steps' losses within 1e-5;
- ``prefill_cross`` (cross-KV within 1e-5, the self rings untouched) and 8
  decode steps with an ``active`` mask: logits within 1e-5, routed rows
  exactly, caches within 1e-5; cross-attention hands the flash kernel
  ``causal=False`` and all-zero positions (JAX's ``kv_pos=None``);
- the stepped engine on the contiguous and the paged pool with a seeded
  ``enc_emb`` per request: greedy streams, lifecycle steps, stats,
  ``cache_bytes()`` and ``kv_bytes`` equal to the JAX engine's (the paged
  pool pages the full blocks' self rings only); a preempted slot refills
  its cross-KV on re-admission (streams and preemptions equal JAX's); the
  capacity ladder, int8 weights and int8 / fp8 (per-head scales) KV pages
  equal JAX's streams and ``kv_bytes``;
- what the family does not take raises with JAX's messages.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.overload import CapacityController as JCapacityController  # noqa: E402
from repro.serve.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.cache import paged_leaf_ids  # noqa: E402
from repro_torch.serve.overload import CapacityController  # noqa: E402
from repro_torch.serve.quant import QuantConfig  # noqa: E402
from repro_torch.train import Trainer, make_train_state  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

ARCH = "whisper-tiny"
TOL = 1e-5  # f32, of the largest |value|
GRAD_TOL = 1e-4  # of the leaf's largest |grad|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (ROADMAP Queue 3: a
    torch worker thread beside JAX's has computed ``exp`` off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3g} of the largest |value| (limit {tol:g})"


def _np(t):
    return t.detach().float().numpy()


def _bits(a):
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _cfgs(mod=True, dtype="float32", **kw):
    arch = ARCH if mod else ARCH + "-dense"
    return tuple(dataclasses.replace(C.smoke_config(C.get_config(arch)), dtype=dtype, **kw)
                 for C in (JC, TC))


@functools.lru_cache(maxsize=None)
def _init(jc, seed):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _jax_params(jc, seed=0):
    """The JAX init (the same tree whatever the backend and remat)."""
    return _init(dataclasses.replace(jc, remat="none", mod=dataclasses.replace(
        jc.mod, backend="xla")), seed)


def _params(jc, seed=0):
    jp = _jax_params(jc, seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(jc, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    enc = (rng.standard_normal((B, jc.enc_seq_len, jc.d_model)) * 0.02).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "enc_emb": enc}


def _tb(batch):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Config, parameters, GELU
# ---------------------------------------------------------------------------


def test_configs_and_param_counts_equal_jax():
    for arch in (ARCH, ARCH + "-dense"):
        jc, tc = JC.get_config(arch), TC.get_config(arch)
        for f in dataclasses.fields(TC.ModelConfig):
            v = getattr(tc, f.name)
            want = getattr(jc, f.name)
            if dataclasses.is_dataclass(v):
                for g in dataclasses.fields(v):
                    assert getattr(v, g.name) == getattr(want, g.name), (arch, f.name, g.name)
            else:
                assert v == want, (arch, f.name)
        assert tc.n_params() == jc.n_params() == 56434560
    js, ts = _cfgs()
    assert (ts.n_enc_layers, ts.enc_seq_len) == (js.n_enc_layers, js.enc_seq_len) == (2, 64)
    assert ts.attn.mrope_sections == js.attn.mrope_sections == (4, 6, 6)


@pytest.mark.parametrize("mod,dtype", [(True, "float32"), (False, "bfloat16")])
def test_params_round_trip_bitwise(mod, dtype):
    jc, tc = _cfgs(mod, dtype)
    jp, tp = _params(jc)
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    bl, bdef = jax.tree.flatten(to_numpy_tree(tp))
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert _bits(a).dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), b)
    assert len(tp["enc_blocks"]) == tc.n_enc_layers
    np.testing.assert_array_equal(np.asarray(jp["enc_blocks"]["attn"]["wq"][1]).astype(np.float32),
                                  tp["enc_blocks"][1]["attn"]["wq"].float().numpy())
    assert set(tp["groups"][0]["full"]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    # the port's own init draws the same tree of shapes and dtypes
    tl, tdef = jax.tree.flatten(to_numpy_tree(TAPI.init_model(tc, device="cpu", seed=0)))
    assert tdef == jdef
    assert [(a.shape, _bits(a).dtype) for a in jl] == [(b.shape, b.dtype) for b in tl]


def _gelu_inputs(n=1 << 16):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    x[: n // 64] = rng.uniform(-30, 30, n // 64)
    return x


def _bf16_ordinals(a):
    bits = (a.contiguous().view(torch.int16).numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).view(np.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def test_gelu_mirrors_jax():
    x = _gelu_inputs()
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x, jnp.bfloat16))
    got = TL.gelu(torch.as_tensor(x).bfloat16())
    np.testing.assert_array_equal(_bf16_ordinals(got), _bf16_ordinals(want))
    # F.gelu rounds once: not JAX's function at bf16
    once = torch.nn.functional.gelu(torch.as_tensor(x).bfloat16(), approximate="tanh")
    assert np.mean(_bf16_ordinals(once) != _bf16_ordinals(want)) > 0.1
    # f32: XLA's tanh is its own approximation (and saturates earlier)
    want32 = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    np.testing.assert_allclose(TL.gelu(torch.as_tensor(x)).numpy(), want32, rtol=2e-6,
                               atol=1e-6)
    assert TL.activation("gelu") is TL.gelu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_gradient_is_jax(dtype):
    x = _gelu_inputs(4096)
    u = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax.nn.gelu(x) * u.astype(jd)).astype(
        jnp.float32))(jnp.asarray(x, jd)).astype(np.float32))
    xt = torch.as_tensor(x).to(td).requires_grad_(True)
    (TL.gelu(xt) * torch.as_tensor(u).to(td)).float().sum().backward()
    got = xt.grad.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        # where XLA's tanh has saturated to -1 (|u| past ~7.9) JAX's
        # gradient is exactly 0 and the port's (1 + t) a few 1e-7
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    else:  # the same ops in bf16: within two bf16 ulps of the largest gradient
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Encoder, forward, loss, gradients, training
# ---------------------------------------------------------------------------


def test_encode_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    enc = _batch(jc)["enc_emb"]
    want = jax.jit(lambda p, e: JED.encode(p, e, jc))(jp, enc)
    with torch.no_grad():
        got = TED.encode(tp, torch.as_tensor(enc), tc)
    _close(_np(got), want)


@pytest.fixture
def masks_of(monkeypatch):
    """The routed mask of every token_topk decision, in both packages."""
    seen = {"jax": [], "torch": []}
    jreal, treal = JROUT.decide_tokens, TROUT.decide_tokens

    def jrec(*a, **k):
        d = jreal(*a, **k)
        jax.debug.callback(lambda m: seen["jax"].append(np.asarray(m)), d.mask)
        return d

    def trec(*a, **k):
        d = treal(*a, **k)
        seen["torch"].append(d.mask.numpy())
        return d

    monkeypatch.setattr(JROUT, "decide_tokens", jrec)
    monkeypatch.setattr(TROUT, "decide_tokens", trec)
    return seen


@pytest.mark.parametrize("mod,backend,remat", [(True, "pallas", "full"),
                                               (True, "pallas_fused", "none"),
                                               (False, "xla", "full")])
def test_forward_loss_and_grads_match_jax(mod, backend, remat, masks_of):
    jc, tc = (JC.with_mod_backend(c, backend) if i == 0 else TC.with_mod_backend(c, backend)
              for i, c in enumerate(_cfgs(mod, remat=remat)))
    jp, tp = _params(jc)
    batch = _batch(jc)

    def jloss(p, b):  # JAPI.model_loss, with the logits kept
        logits, aux = JAPI.model_forward(p, jc, b)
        ce = JL.cross_entropy(logits, b["labels"])
        return JAPI.combine_losses(ce, aux, jc), (logits, aux)

    (jl, (jlogits, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    tlogits, taux = TAPI.model_forward(tp, tc, _tb(batch))
    tl = TAPI.combine_losses(TL.cross_entropy(tlogits, _tb(batch)["labels"]), taux, tc)
    tl.backward()
    _close(_np(tlogits), jlogits)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5, atol=1e-6)
    n = 2 if mod else 0  # (remat "full" decides again in the backward)
    assert len(masks_of["jax"]) in (n, 2 * n) and len(masks_of["torch"]) in (n, 2 * n)
    for t, j in zip(masks_of["torch"], masks_of["jax"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(tree_map(lambda p: p.grad, tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)


class _Batches:
    """The same host batches as tensors, one per step."""

    def __init__(self, batches):
        self.batches, self.step = batches, 0

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batches[self.step]
        self.step += 1
        return _tb(b)


def test_trainer_losses_match_jax_3_steps(tmp_path):
    steps = 3
    jc, tc = _cfgs()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jt = JC.TrainConfig(global_batch=4, seq_len=16, optim=JC.OptimConfig(**kw), log_every=10**6)
    tt = TC.TrainConfig(global_batch=4, seq_len=16, optim=TC.OptimConfig(**kw), log_every=10**6,
                        ckpt_dir=str(tmp_path), ckpt_every=10**6, async_ckpt=False)
    jp = _jax_params(jc, 1)
    batches = [_batch(jc, 4, 16, seed=i) for i in range(steps)]
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))
    trainer = Trainer(tc, tt, _Batches(batches), device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=from_jax_params(jax.tree.map(np.asarray, jp),
                                                               "cpu"))
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)


# ---------------------------------------------------------------------------
# Cross-KV and decode
# ---------------------------------------------------------------------------


def test_cross_attention_takes_every_key_unrotated(monkeypatch):
    seen = []
    real = TA.flash_attention

    def rec(q, k, v, q_pos, kv_pos, **kw):
        seen.append((q_pos.clone(), kv_pos.clone(), kw["causal"]))
        return real(q, k, v, q_pos, kv_pos, **kw)

    monkeypatch.setattr(TA, "flash_attention", rec)
    _, tc = _cfgs()
    p = TA.init_attention(torch.Generator().manual_seed(0), tc, torch.device("cpu"))
    x = torch.randn(2, 3, tc.d_model)
    ek, ev = (torch.randn(2, 7, tc.attn.n_kv_heads, tc.head_dim) for _ in range(2))
    out = TA.cross_attention(p, x, ek, ev, tc)
    assert out.shape == (2, 3, tc.d_model)
    ((qp, kp, causal),) = seen
    assert causal is False and qp.shape == (2, 3) and kp.shape == (2, 7)
    assert not qp.any() and not kp.any()


@pytest.mark.parametrize("mod", [True, False])
def test_prefill_cross_and_8_decode_steps_match_jax(mod):
    jc, tc = _cfgs(mod)
    jp, tp = _params(jc)
    B, ctx = 4, 24
    enc = _batch(jc, B)["enc_emb"]
    jcaches = JED.prefill_cross(jp, JAPI.make_caches(jc, B, ctx), jnp.asarray(enc), jc)
    tfresh = TAPI.make_caches(tc, B, ctx, device="cpu")
    with torch.no_grad():
        tcaches = TED.prefill_cross(tp, tfresh, torch.as_tensor(enc), tc)
    for g, grp in enumerate(tcaches["groups"]):
        for kind, c in grp.items():
            assert c["self"] is tfresh["groups"][g][kind]["self"]
            assert not tfresh["groups"][g][kind]["cross"]["k"].any()  # not written
            for name in ("k", "v"):
                _close(_np(c["cross"][name]), np.asarray(jcaches["groups"][kind]["cross"][name][g]))
    toks = np.random.default_rng(5).integers(0, jc.vocab, (8, B)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    for i in range(8):
        active = np.array([True, i % 3 != 0, True, i < 5])
        pos = np.full((B,), i, np.int32)
        jl, jcaches, jaux = jstep(jp, jcaches, toks[i][:, None], pos, active)
        with torch.no_grad():
            tl, tcaches, taux = TAPI.model_decode(
                tp, tcaches, tc, torch.as_tensor(toks[i][:, None]).long(), torch.as_tensor(pos),
                torch.as_tensor(active))
        _close(_np(tl), jl)
        assert set(taux) == set(jaux)
        for key in jaux:
            if key == "mod/decode_routed":
                np.testing.assert_array_equal(_np(taux[key]), jaux[key])
            else:
                _close(_np(taux[key]), jaux[key])
    for g, grp in enumerate(tcaches["groups"]):
        for kind, c in grp.items():
            for name, leaf in c["self"].items():
                _close(_np(leaf), np.asarray(jcaches["groups"][kind]["self"][name][g]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

_STATS = ("steps", "generated_tokens", "finished_requests", "mean_occupancy", "mean_routed_frac",
          "prefill_tokens_computed", "padded_token_fraction", "kv_cache_bytes", "kv_bytes",
          "resid_bytes", "peak_pages_in_use", "preemptions", "degraded_decode_steps")


def _requests(jc, n=6, seed=0, lens=(3, 6, 10, 13), gens=(3, 6)):
    """Prompts of distinct tokens (a token twice can tie a routed layer's
    top-k within an ulp, which the two packages break differently) and a
    seeded enc_emb each."""
    rng = np.random.default_rng(seed)
    out = []
    for L, g in zip(rng.choice(lens, n), rng.choice(gens, n)):
        enc = (rng.standard_normal((jc.enc_seq_len, jc.d_model)) * 0.02).astype(np.float32)
        out.append((rng.choice(jc.vocab, L, replace=False).astype(np.int32), int(g), enc))
    return out


def _run_both(jc, tc, reqs, arrival_every=0, ctrl=None, **engine):
    """Both engines over ``reqs``; ``ctrl``: CapacityController kwargs (a
    fresh controller on each side)."""
    jp, tp = _params(jc)
    jkw, tkw = dict(engine), dict(engine)
    if ctrl is not None:
        jkw["capacity_controller"] = JCapacityController(**ctrl)
        tkw["capacity_controller"] = CapacityController(**ctrl)
    if "quant" in engine:
        jkw["quant"] = JQuantConfig(**dataclasses.asdict(engine["quant"]))
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(**jkw))
    teng = ServingEngine(tp, tc, EngineConfig(**tkw), device="cpu")
    assert teng.prefill_mode == "step"
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g, enc_emb=e) for t, g, e in reqs],
                           arrival_every)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g, enc_emb=e) for t, g, e in reqs],
                           arrival_every)
    streams = {o.uid: o.tokens.tolist() for o in tout}
    assert streams == {o.uid: o.tokens.tolist() for o in jout}
    assert {o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in jout}
    js, ts = jeng.stats(), teng.stats()
    for key in _STATS:
        if key in js:
            assert ts[key] == pytest.approx(js[key], rel=1e-12, nan_ok=True), key
    return teng, jeng, streams


@pytest.mark.parametrize("page_size", [None, 4])
@pytest.mark.parametrize("mod", [True, False])
def test_stepped_engine_streams_and_bytes_equal_jax(mod, page_size):
    jc, tc = _cfgs(mod)
    ctx = 20
    teng, jeng, streams = _run_both(jc, tc, _requests(jc), batch_size=4, ctx=ctx,
                                    page_size=page_size)
    assert teng.pool.cache_bytes() == pytest.approx(jeng.pool.cache_bytes(), rel=1e-12)
    # the full blocks' self rings are the pageable leaves; cross-KV and the
    # MoD rings stay residual
    n_full = len(teng.pool._template["groups"])
    assert len(paged_leaf_ids(TAPI.make_caches(tc, 1, ctx, "cpu"), ctx)) == 3 * n_full
    cross = 2 * tc.enc_seq_len * tc.attn.n_kv_heads * tc.head_dim * 4
    assert teng.stats()["resid_bytes"] >= 4 * n_full * cross * (2 if mod else 1)
    # the cross-KV reaches the streams: other frames, other tokens
    rng = np.random.default_rng(9)
    other = [(t, g, rng.standard_normal(e.shape).astype(np.float32)) for t, g, e in _requests(jc)]
    eng = ServingEngine(_params(jc)[1], tc, EngineConfig(batch_size=4, ctx=ctx), device="cpu")
    outs = eng.run_stream([Request(tokens=t, max_new_tokens=g, enc_emb=e) for t, g, e in other],
                          0)
    assert {o.uid: o.tokens.tolist() for o in outs} != streams


def test_preempted_slot_refills_its_cross_kv():
    """Cross-wave overcommit on a small page pool: lazy growth exhausts it,
    the youngest slot goes back to the queue, and on re-admission its
    encoder runs again; streams and preemptions equal JAX's."""
    jc, tc = _cfgs()
    reqs = _requests(jc, n=4, seed=3, lens=(4,), gens=(12,))
    teng, jeng, streams = _run_both(jc, tc, reqs, arrival_every=2, batch_size=2, ctx=16,
                                    page_size=4, n_pages=8)
    assert teng.preemptions >= 1 and teng.preemptions == jeng.preemptions
    fills = []
    eng = ServingEngine(_params(jc)[1], tc, EngineConfig(batch_size=2, ctx=16, page_size=4,
                                                         n_pages=8), device="cpu")
    real = eng._fill_cross
    eng._fill_cross = lambda slot, e: (fills.append(slot), real(slot, e))[1]
    outs = eng.run_stream([Request(tokens=t, max_new_tokens=g, enc_emb=e) for t, g, e in reqs],
                          2)
    assert {o.uid: o.tokens.tolist() for o in outs} == streams
    assert len(fills) == len(reqs) + eng.preemptions


@pytest.mark.parametrize("setting", ["ladder", "int8 weights", "int8 kv", "fp8/head kv"])
def test_capacity_ladder_and_quantized_serving_equal_jax(setting):
    jc, tc = _cfgs()
    reqs = _requests(jc, n=8, seed=4)
    if setting == "ladder":
        teng, _, _ = _run_both(jc, tc, reqs, batch_size=4, ctx=20, ctrl=dict(
            n_levels=2, queue_high=2, queue_low=1, degrade_patience=1, restore_patience=3))
        assert teng.stats()["degraded_decode_steps"] > 0
        return
    quant = {"int8 weights": QuantConfig(weights="int8"), "int8 kv": QuantConfig(kv="int8"),
             "fp8/head kv": QuantConfig(kv="fp8", granularity="head")}[setting]
    teng, jeng, _ = _run_both(jc, tc, reqs, batch_size=4, ctx=20, page_size=4, quant=quant)
    assert teng.stats()["quant_kv"] == jeng.stats()["quant_kv"] == quant.kv


def test_what_the_family_does_not_take_raises():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="prefill for family encdec uses forward\\+decode"):
        TAPI.model_prefill(tp, tc, {"tokens": toks}, 32)
    with pytest.raises(NotImplementedError,
                       match="chunked prefill for family encdec: prompts ingest via decode"):
        TAPI.model_prefill_chunk(tp, tc, TAPI.make_caches(tc, 1, 32, "cpu"), toks, 0, 16)
    with pytest.raises(NotImplementedError,
                       match="ragged forward for family encdec: use the padded model_forward"):
        TAPI.model_forward_ragged(tp, tc, toks[0], torch.tensor([0, 16]), 16)
    for setting, msg in ((dict(prefill="batch"), "has no batched prefill"),
                         (dict(prefill_chunk=4), "ingests prompts through decode steps"),
                         (dict(page_size=4, prefix_cache=True), "prefix_cache requires"),
                         (dict(page_size=4, ragged=True), "ragged=True needs"),
                         (dict(page_size=4, speculate=2), "speculate needs")):
        with pytest.raises(ValueError, match=msg):
            JServingEngine(jp, jc, engine=JEngineConfig(batch_size=2, ctx=16, **setting))
        with pytest.raises(ValueError, match=msg):
            ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=16, **setting), device="cpu")
