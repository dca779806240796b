"""The port's Zamba2 hybrid (``family="hybrid"``) against the JAX package,
on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``), same
inputs from a numpy seed, in f32. The configs are ``smoke_config`` of
zamba2-2.7b (4 Mamba2 layers in 2 segments, MoD every 2: one {full, mod}
pair a segment, the shared attention block at each segment start) with
the smoke head dim 32 and with zamba2's own 80, and the MoD-off twin:

- ``from_jax_params`` / ``to_numpy_tree`` carry the ``(n_seg, n_pairs)``
  stacks and ``shared_attn`` both ways bitwise (f32 and bf16), the port's
  init draws the JAX shapes, and JAX-format checkpoints round-trip;
- the forward's logits within 1e-5 of their largest, routed masks
  exactly, aux and loss within 1e-5, every gradient leaf within 1e-4 of
  the leaf's largest |grad| (remat none and full); three Trainer steps'
  losses within 1e-5 of the JAX train loop's;
- 16 decode steps with an ``active`` mask: logits within 1e-5, routed rows
  exactly, the caches (KV rings of every site, SSM states) within 1e-5;
- the stepped engine on the contiguous and the paged pool: greedy streams,
  lifecycle steps, stats, ``cache_bytes()`` and ``kv_bytes`` equal to the
  JAX engine's; the paged pool pages the shared block's KV rings only;
- what the family does not take raises as in JAX (batched prefill,
  chunked prefill, the prefix cache, the ragged step, speculation), and
  both engines take quantized pools and int8 weights for it;
- flash attention at head dim 80: the plan (mma.sync tiles for prefill,
  split-KV decode, CUDA cores in f32; never wgmma), the plain version
  against the Pallas kernel in interpret mode (1e-5); ``routed_attention``
  and ragged paged attention keep their head dims and refuse 80.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.params import from_jax_params, stack_groups, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.cache import paged_leaf_ids  # noqa: E402
from repro_torch.serve.quant import QuantConfig  # noqa: E402
from repro_torch.train import Trainer, make_train_state  # noqa: E402
from repro_torch.train.loop import state_from_host, state_to_host  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = 1e-5  # f32, of the largest |value|
GRAD_TOL = 1e-4  # of the leaf's largest |grad|
# smoke zamba2 at the smoke head dim and at its own, and the MoD-off twin
VARIANTS = {"hd32": (ARCH, 32), "hd80": (ARCH, 80), "dense": (ARCH + "-dense", 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (tests/test_torch_ssm.py
    says why: a worker thread beside JAX's has computed ``exp`` off)."""
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


def _cfgs(variant="hd32", dtype="float32", **kw):
    arch, hd = VARIANTS[variant]
    out = []
    for C in (JC, TC):
        cfg = C.smoke_config(C.get_config(arch))
        out.append(dataclasses.replace(cfg, dtype=dtype, attn=dataclasses.replace(
            cfg.attn, head_dim=hd), **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(jc, seed=0):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _params(jc, seed=0):
    jp = _jax_params(jc, seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _bits(a):
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Config, parameters, checkpoints
# ---------------------------------------------------------------------------


def test_smoke_config_and_layout():
    jc, tc = JC.smoke_config(JC.get_config(ARCH)), TC.smoke_config(TC.get_config(ARCH))
    assert (tc.n_layers, tc.hybrid_attn_every) == (jc.n_layers, jc.hybrid_attn_every) == (4, 2)
    full = TC.get_config(ARCH)
    assert full.head_dim == 80 and full.n_params() == JC.get_config(ARCH).n_params()
    params = TAPI.init_model(dataclasses.replace(tc, dtype="float32"), device="cpu")
    assert len(params["groups"]) == 2 and all(len(s) == 1 for s in params["groups"])
    assert set(params["groups"][0][0]) == {"full", "mod"}
    assert set(params["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}
    dense = TAPI.init_model(TC.smoke_config(TC.get_config(ARCH + "-dense")), device="cpu")
    assert [len(s) for s in dense["groups"]] == [2, 2]
    assert set(dense["groups"][1][1]) == {"full"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_round_trip_bitwise(variant, dtype):
    jc, tc = _cfgs(variant, dtype)
    jp, tp = _params(jc)
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    bl, bdef = jax.tree.flatten(to_numpy_tree(tp))
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert _bits(a).dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), b)
    # segment s, group p of the port is slice [s, p] of the stacked leaves
    np.testing.assert_array_equal(
        np.asarray(jp["groups"]["full"]["ssm"]["w_x"][1, -1]).astype(np.float32),
        tp["groups"][1][-1]["full"]["ssm"]["w_x"].float().numpy())
    assert stack_groups(tp)["groups"]["full"]["ln"]["scale"].shape[:2] == \
        jp["groups"]["full"]["ln"]["scale"].shape[:2]
    # the port's own init draws the same tree of shapes and dtypes
    tl, tdef = jax.tree.flatten(to_numpy_tree(TAPI.init_model(tc, device="cpu", seed=0)))
    assert tdef == jdef
    assert [(a.shape, _bits(a).dtype) for a in jl] == [(b.shape, b.dtype) for b in tl]


def test_checkpoint_roundtrips_the_hybrid_tree_in_the_jax_format(tmp_path):
    jc, tc = _cfgs("hd80", "bfloat16")
    jp, _ = _params(jc, 2)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.asarray(5, jnp.int32)}
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(5, jstate)
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore_latest()
    state = state_from_host(tree, "cpu")
    assert step == 5 and state["params"]["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    want = jax.tree.flatten(jax.tree.map(np.asarray, jp))[0]
    got = jax.tree.flatten(to_numpy_tree(state["params"]))[0]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_bits(a), b)
    CheckpointManager(str(tmp_path / "torch"), async_save=False).save(5, state_to_host(state))
    _, jtree = JCheckpointManager(str(tmp_path / "torch")).restore_latest()
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jtree["params"]))
    wl, wdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    assert jdef == wdef
    for a, b in zip(jl, wl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# Forward, loss, gradients, training
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("variant,remat", [("hd32", "none"), ("hd32", "full"),
                                           ("hd80", "full"), ("dense", "none")])
def test_forward_loss_and_grads_match_jax(variant, remat, masks_of):
    jc, tc = _cfgs(variant, remat=remat)
    jp, tp = _params(jc)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    jlogits, jaux = jax.jit(lambda p, b: JAPI.model_forward(p, jc, b))(jp, batch)
    with torch.no_grad():
        tlogits, taux = TAPI.model_forward(tp, tc, tb)
    _close(_np(tlogits), jlogits)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5, atol=1e-6)
    n_mod = sum("mod" in g for s in tp["groups"] for g in s)
    assert len(masks_of["torch"]) == len(masks_of["jax"]) == n_mod
    for t, j in zip(masks_of["torch"], masks_of["jax"]):
        np.testing.assert_array_equal(t, j)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JAPI.model_loss(p, jc, b), has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    tl, _ = TAPI.model_loss(tp, tc, tb)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(tree_map(lambda p: p.grad, tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)


def test_trainer_losses_match_jax_3_steps(tmp_path):
    steps = 3
    jc, tc = _cfgs("hd80")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jt = JC.TrainConfig(global_batch=4, seq_len=32, optim=JC.OptimConfig(**kw), log_every=10**6)
    tt = TC.TrainConfig(global_batch=4, seq_len=32, optim=TC.OptimConfig(**kw), log_every=10**6,
                        ckpt_dir=str(tmp_path), ckpt_every=10**6, async_ckpt=False)
    jp = _jax_params(jc, 1)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    src = JSyntheticLM(jc.vocab, 32, seed=0)
    jlosses = []
    for i in range(steps):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, src.batch(i, 4)))
        jlosses.append(float(m["loss"]))
    loader = ShardedLoader(SyntheticLM(tc.vocab, 32, seed=0), 4, torch.device("cpu"))
    trainer = Trainer(tc, tt, loader, device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=from_jax_params(jax.tree.map(np.asarray, jp),
                                                               "cpu"))
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_16_steps_matches_jax(variant):
    jc, tc = _cfgs(variant)
    jp, tp = _params(jc)
    B, ctx = 4, 32
    toks = np.random.default_rng(5).integers(0, jc.vocab, (16, B)).astype(np.int32)
    jcaches = JAPI.make_caches(jc, B, ctx)
    tcaches = TAPI.make_caches(tc, B, ctx, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    for i in range(16):
        active = np.array([True, i % 3 != 0, True, i < 10])
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
    for s, site in enumerate(tcaches["attn"]):
        for name, leaf in site.items():
            _close(_np(leaf), np.asarray(jcaches["attn"][name][s]))
    for s, seg in enumerate(tcaches["groups"]):
        for p, grp in enumerate(seg):
            for kind, leaves in grp.items():
                for name, leaf in leaves.items():
                    _close(_np(leaf), np.asarray(jcaches["groups"][kind][name][s, p]))


# ---------------------------------------------------------------------------
# Serving: stepped ingestion, contiguous and paged pools
# ---------------------------------------------------------------------------

_STATS = ("steps", "decode_steps", "generated_tokens", "finished_requests", "mean_occupancy",
          "mean_routed_frac", "prefill_tokens_computed", "padded_token_fraction",
          "kv_cache_bytes", "kv_bytes", "resid_bytes", "peak_pages_in_use")


def _requests(vocab, n=6, seed=0):
    """Prompts of distinct tokens (a token twice can tie a routed layer's
    top-k within an ulp, which the two packages break differently)."""
    rng = np.random.default_rng(seed)
    lens, gens = rng.choice([3, 6, 10, 13], n), rng.choice([3, 6], n)
    return [(rng.choice(vocab, L, replace=False).astype(np.int32), int(g))
            for L, g in zip(lens, gens)]


@pytest.mark.parametrize("page_size", [None, 4])
@pytest.mark.parametrize("variant", ["hd32", "hd80"])
def test_stepped_engine_streams_and_bytes_equal_jax(variant, page_size):
    jc, tc = _cfgs(variant)
    jp, tp = _params(jc)
    reqs = _requests(jc.vocab)
    ctx = 20
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(batch_size=4, ctx=ctx,
                                                       page_size=page_size))
    teng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=ctx, page_size=page_size),
                         device="cpu")
    assert teng.prefill_mode == "step"
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    assert {o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in jout}
    js, ts = jeng.stats(), teng.stats()
    for key in _STATS:
        if key in js:
            assert ts[key] == pytest.approx(js[key], rel=1e-12), key
    assert teng.pool.cache_bytes() == pytest.approx(jeng.pool.cache_bytes(), rel=1e-12)
    # the shared block's k/v/pos rings, one per site, are the pageable leaves
    n_seg = tc.n_layers // tc.hybrid_attn_every
    assert len(paged_leaf_ids(TAPI.make_caches(tc, 1, ctx, "cpu"), ctx)) == 3 * n_seg
    site = 2 * ctx * tc.attn.n_kv_heads * tc.head_dim * 4 + ctx * 4  # k, v f32 + pos int32
    if page_size is None:
        assert ts["kv_bytes"] == 4 * n_seg * site
    else:
        assert ts["kv_bytes"] > 0 and ts["peak_pages_in_use"] > 0


def test_what_the_family_does_not_take_raises():
    jc, tc = _cfgs()
    params = TAPI.init_model(tc, device="cpu", seed=0)
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="uses forward\\+decode"):
        TAPI.model_prefill(params, tc, {"tokens": toks}, 32)
    with pytest.raises(NotImplementedError, match="prompts ingest via decode steps"):
        TAPI.model_prefill_chunk(params, tc, TAPI.make_caches(tc, 1, 32, "cpu"), toks, 0, 16)
    with pytest.raises(NotImplementedError, match="use the padded model_forward"):
        TAPI.model_forward_ragged(params, tc, toks[0], torch.tensor([0, 16]), 16)
    with pytest.raises(ValueError, match="^rnn$"):  # an unknown family, as in JAX
        TAPI.init_model(dataclasses.replace(tc, family="rnn"), device="cpu")
    jp = _jax_params(jc)
    for setting, msg in ((dict(prefill="batch"), "has no batched prefill"),
                         (dict(prefill_chunk=4), "ingests prompts through decode steps"),
                         (dict(page_size=4, prefix_cache=True), "prefix_cache requires"),
                         (dict(page_size=4, ragged=True), "ragged=True needs"),
                         (dict(page_size=4, speculate=2), "speculate needs")):
        with pytest.raises(ValueError, match=msg):
            JServingEngine(jp, jc, engine=JEngineConfig(batch_size=2, ctx=16, **setting))
        with pytest.raises(ValueError, match=msg):
            ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16, **setting),
                          device="cpu")
    # quantized pools and int8 weights: both engines take them
    # (tests/test_torch_hybrid_quant.py holds their streams against JAX's)
    for kw in (dict(kv="int8"), dict(kv="fp8", granularity="head"), dict(weights="int8")):
        JServingEngine(jp, jc, engine=JEngineConfig(batch_size=2, ctx=16, page_size=4,
                                                    quant=JQuantConfig(**kw)))
        eng = ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16, page_size=4,
                                                     quant=QuantConfig(**kw)), device="cpu")
        assert eng.prefill_mode == "step"


# ---------------------------------------------------------------------------
# Flash attention at head dim 80
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Skv,nq,nkv,dtype,path,kernels", [
    (1, 1000, 1000, 32, 32, torch.bfloat16, "mma_sync", 1),  # prefill
    (1, 2048, 2048, 32, 32, torch.bfloat16, "mma_sync", 1),  # the teacher-forced forward
    (8, 1, 1056, 32, 32, torch.bfloat16, "decode", 2),  # 9 chunks + the merge
    (8, 1, 100, 32, 32, torch.bfloat16, "decode", 1),  # one chunk, one launch
    (2, 4, 300, 8, 2, torch.bfloat16, "decode", 2),  # 16 (position, head) rows
    (2, 5, 300, 8, 2, torch.bfloat16, "mma_sync", 1),  # 20 rows
    (1, 1000, 1000, 32, 32, torch.float32, "f32", 1),
])
def test_flash_plan_at_head_dim_80(B, Sq, Skv, nq, nkv, dtype, path, kernels):
    plan = TFA.flash_plan(B, Sq, Skv, nq, nkv, 80, dtype)
    assert plan.path == path and plan.kernels == kernels
    if path == "mma_sync":
        assert (plan.key_tile, plan.key_split) == (64, 1)
    if path == "decode":
        assert (plan.chunk, plan.key_tile, plan.key_split) == (128, 32, 4)
        assert plan.n_splits == -(-Skv // 128)
        if plan.merge:
            assert plan.scratch[2] == (B, nkv, plan.n_splits, Sq * nq // nkv, 80)


def test_head_dim_80_stops_at_flash():
    assert 80 not in TFA.WGMMA_HEAD_DIMS and 80 not in TFA.ROUTED_HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        TFA.routed_attention_path(torch.bfloat16, 1, 128, 2560, 32, 32, 80, True)
    with pytest.raises(ValueError, match="head_dim"):
        KRG.ragged_attention_plan(8, 32, 32, 80, 40, 16, 8, 4, 1, 8, torch.bfloat16,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        TFA.flash_plan(1, 1, 16, 4, 4, 96, torch.bfloat16)


@pytest.mark.parametrize("Sq,Skv,nq,nkv,causal", [(32, 32, 4, 4, True), (64, 64, 4, 2, True),
                                                  (1, 64, 4, 4, True), (32, 64, 2, 1, False)])
def test_flash_plain_at_head_dim_80_matches_pallas(Sq, Skv, nq, nkv, causal):
    rng = np.random.default_rng(9)
    B, hd = 2, 80
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, nkv, hd)).astype(np.float32) for _ in range(2))
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kp[0, -5:] = -1  # empty cache slots
    want = JFA.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), causal=causal, block_q=32,
                               block_kv=32, interpret=True)
    got = TFA.flash_attention(*map(torch.as_tensor, (q, k, v, qp, kp)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_port_param_count_equals_jax():
    for variant in VARIANTS:
        jc, tc = _cfgs(variant)
        n = sum(t.numel() for t in tree_leaves(TAPI.init_model(tc, device="cpu")))
        assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(_jax_params(jc)))
