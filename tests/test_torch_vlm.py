"""The port's VLM backbone (``family="vlm"``, qwen2-vl-7b: M-RoPE over
precomputed embeddings) against the JAX package, on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``, its
q/k/v biases drawn non-zero), same inputs from a numpy seed, in f32. The
config is ``smoke_config`` of qwen2-vl-7b (4 layers, MoD every 2, M-RoPE
sections (4, 6, 6) over head dim 32) and its MoD-off twin. The inputs are
laid out as Qwen2-VL lays out an image between two runs of text
(:func:`repro_torch.models.api.mrope_positions`): text, an image of
merged patches sharing one ``t`` stream, text from the largest position
+ 1 on.

- the configs field for field, ``n_params()`` of the full configs equal
  JAX's (7.6155B); the parameter tree carried both ways bitwise;
- ``apply_mrope`` within 1e-6 of JAX's on that layout (and equal to RoPE
  when the three streams are equal); the routed ``(3, B, S)`` position
  gathers (token axis and batch axis) equal to JAX's;
- the forward over ``embeds``: logits within 1e-5 of their largest,
  routed masks exactly, aux and loss within 1e-5, gradients within 1e-4
  of each leaf's largest under ``pallas`` and ``pallas_fused`` (M-RoPE
  is not fused: the routed blocks run gather/scatter, no fused kernel is
  called); three Trainer steps' losses within 1e-5;
- prefill over ``embeds`` (logits and caches within 1e-5) and 8 decode
  steps continuing from it;
- the stepped engine on the contiguous and the paged pool, the capacity
  ladder, int8 weights and int8 / fp8 (per-head scales) KV pages: greedy
  streams, lifecycle steps,
  stats and ``kv_bytes`` equal to the JAX engine's;
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
from repro_torch.models import blocks as TBLK  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.overload import CapacityController  # noqa: E402
from repro_torch.serve.quant import QuantConfig  # noqa: E402
from repro_torch.train import Trainer, make_train_state  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

ARCH = "qwen2-vl-7b"
TOL = 1e-5  # f32, of the largest |value|
GRAD_TOL = 1e-4  # of the leaf's largest |grad|
# text, an image of 3 x 4 merged patches, text: 5 + 12 + 7 = 24 positions
LAYOUT = [("text", 5), ("image", (3, 4)), ("text", 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _cfgs(mod=True, dtype="float32", backend="pallas", **kw):
    arch = ARCH if mod else ARCH + "-dense"
    jc, tc = (dataclasses.replace(C.smoke_config(C.get_config(arch)), dtype=dtype, **kw)
              for C in (JC, TC))
    return JC.with_mod_backend(jc, backend), TC.with_mod_backend(tc, backend)


@functools.lru_cache(maxsize=None)
def _init(jc, seed):
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 100)

    def bias(path, leaf):  # the init zeroes the q/k/v biases: draw them
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(0.5 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(bias, jp)


def _params(jc, seed=0):
    jp = _init(dataclasses.replace(jc, remat="none", mod=dataclasses.replace(
        jc.mod, backend="xla")), seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _positions(B):
    pos = TAPI.mrope_positions(LAYOUT).numpy()
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


def _batch(jc, B=2, seed=0):
    rng = np.random.default_rng(seed)
    pos = _positions(B)
    S = pos.shape[2]
    return {"embeds": (rng.standard_normal((B, S, jc.d_model)) * 0.02).astype(np.float32),
            "positions": pos,
            "labels": rng.integers(0, jc.vocab, (B, S)).astype(np.int32)}


def _tb(batch):
    return {k: torch.as_tensor(v).long() if k == "labels" else torch.as_tensor(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Config, parameters, M-RoPE
# ---------------------------------------------------------------------------


def test_configs_and_param_counts_equal_jax():
    for arch in (ARCH, ARCH + "-dense"):
        jc, tc = JC.get_config(arch), TC.get_config(arch)
        for f in dataclasses.fields(TC.ModelConfig):
            v, want = getattr(tc, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(v):
                for g in dataclasses.fields(v):
                    assert getattr(v, g.name) == getattr(want, g.name), (arch, f.name, g.name)
            else:
                assert v == want, (arch, f.name)
        assert tc.n_params() == jc.n_params() == 7615487488
    assert TC.smoke_config(TC.get_config(ARCH)).attn.mrope_sections == (4, 6, 6)


@pytest.mark.parametrize("mod", [True, False])
def test_params_round_trip_bitwise(mod):
    jc, tc = _cfgs(mod)
    jp, tp = _params(jc)
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    bl, bdef = jax.tree.flatten(to_numpy_tree(tp))
    assert jdef == bdef
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(_bits(a), b)
    assert tp["groups"][0]["full"]["attn"]["bq"].abs().max() > 0
    tl, tdef = jax.tree.flatten(to_numpy_tree(TAPI.init_model(tc, device="cpu", seed=0)))
    assert tdef == jdef and [a.shape for a in jl] == [b.shape for b in tl]


def test_mrope_positions_lay_out_an_image_as_qwen2_vl():
    pos = TAPI.mrope_positions(LAYOUT).numpy()
    assert pos.shape == (3, 24)
    np.testing.assert_array_equal(pos[:, :5], np.tile(np.arange(5), (3, 1)))
    np.testing.assert_array_equal(pos[0, 5:17], np.full(12, 5))  # one t for the image
    np.testing.assert_array_equal(pos[1, 5:17], 5 + np.repeat(np.arange(3), 4))  # rows
    np.testing.assert_array_equal(pos[2, 5:17], 5 + np.tile(np.arange(4), 3))  # columns
    np.testing.assert_array_equal(pos[:, 17:], np.tile(np.arange(9, 16), (3, 1)))  # max + 1


@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 10000.0), ((16, 24, 24), 1e6)])
def test_apply_mrope_matches_jax_on_an_image_layout(sections, theta):
    hd = 2 * sum(sections)
    rng = np.random.default_rng(1)
    pos = _positions(2)
    x = rng.standard_normal((2, pos.shape[2], 3, hd)).astype(np.float32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * np.abs(x).max())
    # equal streams: M-RoPE is RoPE
    same = torch.as_tensor(pos[0])[None].expand(3, -1, -1)
    np.testing.assert_allclose(TL.apply_mrope(torch.as_tensor(x), same, theta, sections).numpy(),
                               TL.apply_rope(torch.as_tensor(x), same[0], theta).numpy(),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        TL.apply_mrope(torch.as_tensor(x[..., :hd - 2]), torch.as_tensor(pos), theta, sections)


def test_routed_position_gathers_match_jax():
    pos = _positions(3)
    rng = np.random.default_rng(2)
    idx = np.sort(np.stack([rng.choice(pos.shape[2], 6, replace=False) for _ in range(3)]), 1)
    want = JROUT.gather_positions(jnp.asarray(pos), jnp.asarray(idx, jnp.int32))
    got = TROUT.gather_positions(torch.as_tensor(pos), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dec = pos[:, :, 7:8]  # (3, B, 1)
    rows = np.array([2, 0])
    want = JROUT._take_batch_positions(jnp.asarray(dec), jnp.asarray(rows))
    got = TROUT.take_batch_positions(torch.as_tensor(dec), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got2 = TROUT.take_batch_positions(torch.as_tensor(dec[0]), torch.as_tensor(rows))
    np.testing.assert_array_equal(got2.numpy(), dec[0][rows])


# ---------------------------------------------------------------------------
# Forward, loss, gradients, training
# ---------------------------------------------------------------------------


@pytest.fixture
def masks_of(monkeypatch):
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
                                               (False, "xla", "none")])
def test_forward_loss_and_grads_match_jax(mod, backend, remat, masks_of, monkeypatch):
    jc, tc = _cfgs(mod, backend=backend, remat=remat)
    # M-RoPE is not fused: under pallas_fused the routed blocks fall back
    # to gather -> block_delta -> scatter, as in JAX
    assert not TBLK.fused_dispatch_supported(tc)

    def never(*a, **k):
        raise AssertionError("a fused routed block ran for M-RoPE positions")

    monkeypatch.setattr(TBLK, "block_delta_fused", never)
    deltas = []
    real_delta = TBLK.block_delta
    monkeypatch.setattr(TBLK, "block_delta",
                        lambda *a, **k: (deltas.append(a[2].shape), real_delta(*a, **k))[1])
    jp, tp = _params(jc)
    batch = _batch(jc)

    def jloss(p, b):  # JAPI.model_loss, with the logits kept
        logits, aux = JAPI.model_forward(p, jc, b)
        ce = JL.cross_entropy(logits, b["labels"])
        return JAPI.combine_losses(ce, aux, jc), (logits, aux)

    (jl, (jlogits, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    tb = _tb(batch)
    tlogits, taux = TAPI.model_forward(tp, tc, tb)
    tl = TAPI.combine_losses(TL.cross_entropy(tlogits, tb["labels"]), taux, tc)
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
    # the embedding table is not read when embeds come in: JAX's gradient
    # is zeros there, autograd's None
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)
    # every routed block ran the gather/scatter path on (3, B, k) positions
    assert len(deltas) in (n, 2 * n) and all(p[0] == 3 for p in deltas)


class _Batches:
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
    jt = JC.TrainConfig(global_batch=2, seq_len=24, optim=JC.OptimConfig(**kw), log_every=10**6)
    tt = TC.TrainConfig(global_batch=2, seq_len=24, optim=TC.OptimConfig(**kw), log_every=10**6,
                        ckpt_dir=str(tmp_path), ckpt_every=10**6, async_ckpt=False)
    jp, tp = _params(jc, 1)
    batches = [_batch(jc, 2, seed=i) for i in range(steps)]
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))
    trainer = Trainer(tc, tt, _Batches(batches), device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=tp)
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_over_embeds_then_8_decode_steps_match_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    batch = _batch(jc, 4)
    B, S, ctx = 4, batch["positions"].shape[2], 48
    jlog, jcaches = jax.jit(lambda p, b: JAPI.model_prefill(p, jc, b, ctx))(
        jp, {"embeds": batch["embeds"], "positions": batch["positions"]})
    with torch.no_grad():
        tlog, tcaches = TAPI.model_prefill(tp, tc, {k: torch.as_tensor(batch[k])
                                                    for k in ("embeds", "positions")}, ctx)
    _close(_np(tlog), jlog)

    def caches_close():
        for g, grp in enumerate(tcaches["groups"]):
            for kind, c in grp.items():
                for name, leaf in c.items():
                    _close(_np(leaf), np.asarray(jcaches["groups"][kind][name][g]))

    caches_close()
    # decoding continues the text after the image: t = h = w = max + 1 on
    start = int(batch["positions"].max()) + 1
    toks = np.random.default_rng(5).integers(0, jc.vocab, (8, B)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    for i in range(8):
        active = np.array([True, i % 3 != 0, True, i < 5])
        pos = np.full((B,), start + i, np.int32)
        jl, jcaches, jaux = jstep(jp, jcaches, toks[i][:, None], pos, active)
        with torch.no_grad():
            tl, tcaches, taux = TAPI.model_decode(
                tp, tcaches, tc, torch.as_tensor(toks[i][:, None]).long(), torch.as_tensor(pos),
                torch.as_tensor(active))
        _close(_np(tl), jl)
        np.testing.assert_array_equal(_np(taux["mod/decode_routed"]), jaux["mod/decode_routed"])
    caches_close()
    assert S == 24


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

_STATS = ("steps", "generated_tokens", "finished_requests", "mean_occupancy", "mean_routed_frac",
          "prefill_tokens_computed", "padded_token_fraction", "kv_cache_bytes", "kv_bytes",
          "resid_bytes", "peak_pages_in_use", "preemptions", "degraded_decode_steps", "quant_kv")


def _requests(vocab, n=6, seed=0):
    """Prompts of distinct tokens (a token twice can tie a routed layer's
    top-k within an ulp, which the two packages break differently)."""
    rng = np.random.default_rng(seed)
    return [(rng.choice(vocab, L, replace=False).astype(np.int32), int(g))
            for L, g in zip(rng.choice([3, 6, 10, 13], n), rng.choice([3, 6], n))]


@pytest.mark.parametrize("setting", ["contiguous", "paged", "paged dense", "ladder",
                                     "int8 weights", "int8 kv", "fp8/head kv"])
def test_stepped_engine_streams_and_bytes_equal_jax(setting):
    jc, tc = _cfgs(mod=setting != "paged dense")
    jp, tp = _params(jc)
    engine = dict(batch_size=4, ctx=20)
    jkw, tkw = {}, {}
    if setting != "contiguous":
        engine["page_size"] = 4
    if setting == "ladder":
        del engine["page_size"]
        ctrl = dict(n_levels=2, queue_high=2, queue_low=1, degrade_patience=1, restore_patience=3)
        jkw["capacity_controller"] = JCapacityController(**ctrl)
        tkw["capacity_controller"] = CapacityController(**ctrl)
    if setting in ("int8 weights", "int8 kv", "fp8/head kv"):
        q = {"int8 weights": dict(weights="int8"), "int8 kv": dict(kv="int8"),
             "fp8/head kv": dict(kv="fp8", granularity="head")}[setting]
        jkw["quant"], tkw["quant"] = JQuantConfig(**q), QuantConfig(**q)
    reqs = _requests(jc.vocab, n=8 if setting == "ladder" else 6)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(**engine, **jkw))
    teng = ServingEngine(tp, tc, EngineConfig(**engine, **tkw), device="cpu")
    assert teng.prefill_mode == "step"
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    assert {o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in jout}
    js, ts = jeng.stats(), teng.stats()
    for key in _STATS:
        if key in js:
            assert ts[key] == pytest.approx(js[key], rel=1e-12, nan_ok=True), key
    if setting == "ladder":
        assert ts["degraded_decode_steps"] > 0
    if setting in ("contiguous", "paged"):
        assert teng.pool.cache_bytes() == pytest.approx(jeng.pool.cache_bytes(), rel=1e-12)


def test_what_the_family_does_not_take_raises():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="chunked prefill for family vlm: prompts ingest via decode"):
        TAPI.model_prefill_chunk(tp, tc, TAPI.make_caches(tc, 1, 32, "cpu"), toks, 0, 16)
    with pytest.raises(NotImplementedError,
                       match="ragged forward for family vlm: use the padded model_forward"):
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
    with pytest.raises(ValueError, match="unknown pos_emb"):
        bad = dataclasses.replace(tc, attn=dataclasses.replace(tc.attn, pos_emb="alibi"))
        TAPI.model_forward(tp, bad, _tb(_batch(jc)))
