"""Partitioned ``batch_capacity`` routing of the port against the JAX package
(CPU, one device, torch on one thread).

The semantics (DESIGN.md §SPMD routed execution): the batch splits into
``d`` contiguous groups, each routing its own top ``kb_local =
round(ratio·B/d)`` rows; the global budget is ``d·kb_local``. Held here:

- ``router.batch_select`` and ``routing.batch_capacity_k`` at d in {1, 2, 4,
  8}, ratios with 0.0 and Python's ``round(0.5) == 0``, ties and inactive
  rows; ``routing.decide_batch`` group by group;
- ``api.model_decode`` under ``ShardCtx(data_shards=4)`` for all six
  families at smoke size, f32, against JAX's ``shard_ctx(None,
  data_shards=4)``: routed masks and argmax exact, logits within 1e-5;
- ``EngineConfig(data_shards=2|4)`` streams and ``routed_capacity`` equal
  to JAX ``ServingEngine(data_shards=...)`` on the contiguous, paged +
  prefix and int8-KV engines;
- every ``NotImplementedError`` of the JAX engine's SPMD settings, with
  JAX's message (the mesh cases over a one-rank gloo group beside JAX's
  one-device mesh);
- the sharding rule table: the same split dim as JAX's ``param_pspec`` for
  every leaf of the dense, MoE, ssm and enc-dec smoke trees on several mesh
  shapes, fallbacks included (a mesh shape alone, no processes), and the
  JAX tree cut into one rank's shards by it.

The mesh engine over several processes is tests/test_torch_mesh.py.
"""
import dataclasses
import functools
import re
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import blocks as JBLK  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro.utils import flatten_dict  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import blocks as TBLK  # noqa: E402
from repro_torch.params import from_jax_params, shard_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.engine import routed_capacity  # noqa: E402

FAMILIES = {"dense": "mod-paper-60m", "moe": "olmoe-1b-7b", "ssm": "mamba2-1.3b",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-tiny", "vlm": "qwen2-vl-7b"}
SHARDS = (1, 2, 4, 8)
RATIOS = (0.0, 0.0625, 0.125, 0.25, 0.5, 1.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **mod):
    out = []
    for C in (JC, TC):
        cfg = dataclasses.replace(C.smoke_config(C.get_config(arch)), dtype="float32")
        if mod:
            cfg = dataclasses.replace(cfg, mod=dataclasses.replace(cfg.mod, **mod))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(jc, seed=0):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _params(jc):
    jp = _jax_params(jc)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Selection and budgets
# ---------------------------------------------------------------------------


def _ranking(B, seed, inactive):
    """(B,) f32 scores drawn from 4 values (ties everywhere), inactive rows
    at -inf (as decide_batch demotes them)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, B).astype(np.float32)
    if inactive:
        s[rng.random(B) < 0.3] = -np.inf
    return s


@pytest.mark.parametrize("d", SHARDS)
def test_batch_select_partitioned_matches_jax(d):
    B = 16
    for seed in range(4):
        for inactive in (False, True):
            s = _ranking(B, seed, inactive)
            for kb_local in sorted({0, 1, 2, B // d}):
                got = TR.batch_select(torch.as_tensor(s), kb_local, d)
                want = np.asarray(JR.batch_select(jnp.asarray(s), kb_local, d))
                np.testing.assert_array_equal(_np(got), want)
                assert got.dtype == torch.int64
                # each group routes exactly kb_local of its own rows
                groups = _np(got) // (B // d)
                assert (np.bincount(groups, minlength=d) == kb_local).all()


@pytest.mark.parametrize("d", SHARDS)
def test_batch_capacity_k_matches_jax(d):
    _, tc = _cfgs("mod-paper-60m")
    jc, _ = _cfgs("mod-paper-60m")
    for ratio in RATIOS:
        jr = dataclasses.replace(jc, mod=dataclasses.replace(jc.mod, capacity_ratio=ratio))
        tr = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, capacity_ratio=ratio))
        for B in (8, 16, 32):
            if B % d:
                continue
            got = TROUT.batch_capacity_k(tr, B, d)
            assert got == JROUT.batch_capacity_k(jr, B, data_shards=d)
            assert routed_capacity(tr, B, d) == got
    # the round-half-to-even trap: 0.125 · 8 / d = 0.5 rounds to 0, floored at 1
    r = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, capacity_ratio=0.125))
    assert [TROUT.batch_capacity_k(r, 8, k) for k in (1, 2, 4, 8)] == [1, 2, 4, 8]
    with pytest.raises(ValueError, match="not divisible"):
        TROUT.batch_capacity_k(r, 6, 4)


def _dyadic(rng, shape, scale=8):
    """Values k/scale with small integer k: exact sums in f32, so the two
    frameworks' scores agree bit for bit (and tie often)."""
    return (rng.integers(-4, 5, shape) / scale).astype(np.float32)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("sampling", ["aux_loss", "predictor"])
def test_decide_batch_per_group_matches_jax(d, sampling):
    jc, tc = _cfgs("mod-paper-60m", sampling=sampling, capacity_ratio=0.25)
    B, D, h = 16, jc.d_model, 16
    rng = np.random.default_rng(d)
    p = {"router": {"w": _dyadic(rng, D)},
         "predictor": {"w1": _dyadic(rng, (D, h)), "b1": _dyadic(rng, h),
                       "w2": _dyadic(rng, h)}}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: {n: torch.as_tensor(a) for n, a in v.items()} for k, v in p.items()}
    x = _dyadic(rng, (B, 1, D), scale=4)
    x[3] = x[5]  # a tie between two rows of one group
    x[9] = x[1]  # and across groups
    act = np.random.default_rng(7).random(B) > 0.25
    jd = JROUT.decide_batch(jp, jnp.asarray(x), jc, jnp.asarray(act), data_shards=d)
    td = TROUT.decide_batch(tp, torch.as_tensor(x), tc, torch.as_tensor(act), data_shards=d)
    np.testing.assert_array_equal(_np(td.idx), np.asarray(jd.idx))
    np.testing.assert_array_equal(_np(td.mask), np.asarray(jd.mask))
    np.testing.assert_array_equal(_np(td.gate), np.asarray(jd.gate))
    np.testing.assert_array_equal(_np(td.scores), np.asarray(jd.scores))
    kb_local = TROUT.batch_capacity_k(tc, B // d)
    assert td.idx.numel() == d * kb_local
    for g in range(d):  # a group's routed rows: its own live rows first
        rows = _np(td.idx)[(_np(td.idx) // (B // d)) == g]
        assert len(rows) == kb_local


def test_route_decode_refuses_a_batch_the_groups_do_not_divide():
    jc, tc = _cfgs("mod-paper-60m")
    _, tp = _params(jc)
    caches = TAPI.make_caches(tc, 6, 16, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="not divisible by data_shards=4"):
        TAPI.model_decode(tp, caches, tc, torch.zeros(6, 1, dtype=torch.long),
                          torch.zeros(6, dtype=torch.int32), None,
                          spmd=TSH.ShardCtx(data_shards=4))


# ---------------------------------------------------------------------------
# The six families' decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_decode_partitioned_matches_jax(family):
    jc, tc = _cfgs(FAMILIES[family])
    jp, tp = _params(jc)
    B, ctx, steps = 8, 16, 6
    jctx, tctx = JSH.shard_ctx(None, data_shards=4), TSH.ShardCtx(data_shards=4)
    jcaches = JAPI.make_caches(jc, B, ctx)
    tcaches = TAPI.make_caches(tc, B, ctx, device="cpu")
    rng = np.random.default_rng(11)
    toks = np.stack([rng.permutation(jc.vocab)[:B] for _ in range(steps)]).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a, spmd=jctx))
    for i in range(steps):
        active = np.array([True, i % 3 != 0, True, True, i < 4, True, False, True])
        pos = np.full((B,), i, np.int32)
        jl, jcaches, jaux = jstep(jp, jcaches, toks[i][:, None], pos, active)
        with torch.no_grad():
            tl, tcaches, taux = TAPI.model_decode(
                tp, tcaches, tc, torch.as_tensor(toks[i][:, None]).long(), torch.as_tensor(pos),
                torch.as_tensor(active), spmd=tctx)
        np.testing.assert_array_equal(np.argmax(_np(tl), -1), np.argmax(np.asarray(jl), -1))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)
        assert set(taux) == set(jaux)
        if "mod/decode_routed" in jaux:
            routed = np.asarray(jaux["mod/decode_routed"])
            np.testing.assert_array_equal(_np(taux["mod/decode_routed"]), routed)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _prompts(vocab, n=12, prefix=8, length=12, seed=3):
    """``n`` prompts of distinct tokens each; groups of three share an
    8-token prefix (prefix-cache hits on the paged engine)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 0:
            perm = rng.permutation(vocab)
            shared = perm[:prefix]
        rest = rng.permutation(np.setdiff1d(np.arange(vocab), shared))[: length - prefix]
        out.append(np.concatenate([shared, rest]).astype(np.int32))
    return out


ENGINES = {
    "contiguous": (dict(), dict()),
    "paged+prefix": (dict(page_size=8, prefix_cache=True), dict(page_size=8, prefix_cache=True)),
    "int8-kv": (dict(page_size=8, prefix_cache=True,
                     quant=JQ.QuantConfig(kv="int8", granularity="page")),
                dict(page_size=8, prefix_cache=True,
                     quant=TQ.QuantConfig(kv="int8", granularity="page"))),
}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_streams_match_jax(engine, d):
    jc, tc = _cfgs("mod-paper-60m")
    tc = TC.with_mod_backend(tc, "pallas")
    jp, tp = _params(jc)
    jkw, tkw = ENGINES[engine]
    prompts = _prompts(jc.vocab)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(batch_size=8, ctx=24, data_shards=d,
                                                       **jkw))
    teng = ServingEngine(tp, tc, EngineConfig(batch_size=8, ctx=24, data_shards=d, **tkw),
                         device="cpu")
    jout = jeng.run_stream([JRequest(tokens=p, max_new_tokens=8) for p in prompts], 2)
    with torch.no_grad():
        tout = teng.run_stream([Request(tokens=p, max_new_tokens=8) for p in prompts], 2)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    assert teng.scheduler.routed_capacity == jeng.scheduler.routed_capacity
    assert teng.scheduler.routed_capacity == TROUT.batch_capacity_k(tc, 8, d)
    js, ts = jeng.stats(), teng.stats()
    assert ts["mean_routed_frac"] == js["mean_routed_frac"]
    assert ts["steps"] == js["steps"]
    assert (ts["data_shards"], ts["model_shards"], ts["routed_kb"]) == (
        d, 1, teng.scheduler.routed_capacity)
    if "prefix_cache" in tkw:
        assert ts["prefix_hit_rate"] == js["prefix_hit_rate"] > 0


# ---------------------------------------------------------------------------
# Refusals, with JAX's messages
# ---------------------------------------------------------------------------


SHARD_REFUSALS = {
    "ragged": dict(page_size=8, ragged=True),
    "speculate": dict(page_size=8, speculate=2),
    "adaptive_capacity": dict(adaptive_capacity=True),
}
MESH_REFUSALS = {
    "int8 weights": dict(quant="w8"),
    "paged": dict(page_size=8),
    **SHARD_REFUSALS,
}


def _kw(kw, jax_side):
    kw = dict(kw)
    if kw.get("quant") == "w8":
        kw["quant"] = (JQ if jax_side else TQ).QuantConfig(weights="int8")
    return kw


@pytest.mark.parametrize("setting", list(SHARD_REFUSALS))
def test_data_shards_refusals_match_jax(setting):
    jc, tc = _cfgs("mod-paper-60m")
    jp, tp = _params(jc)
    kw = dict(batch_size=4, ctx=16, data_shards=2, **SHARD_REFUSALS[setting])
    with pytest.raises(NotImplementedError) as jerr:
        JServingEngine(jp, jc, engine=JEngineConfig(**kw))
    with pytest.raises(NotImplementedError) as terr:
        ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "data_shards" in str(terr.value)


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A one-rank gloo group (a FileStore under ``tmp_path``: no port) and
    its (1, 1) mesh, destroyed afterwards."""
    from torch import distributed as dist

    from repro_torch.launch import mesh as M

    M.init_process_group("gloo", rank=0, world_size=1,
                         store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield M.auto_mesh()
    finally:
        M.destroy_process_group()


@pytest.mark.parametrize("setting", list(MESH_REFUSALS))
def test_mesh_refusals_match_jax(setting, one_rank_mesh):
    from repro.launch.mesh import single_device_mesh

    jc, tc = _cfgs("mod-paper-60m")
    jp, tp = _params(jc)
    base = dict(batch_size=4, ctx=16)
    with pytest.raises(NotImplementedError) as jerr:
        JServingEngine(jp, jc, engine=JEngineConfig(
            mesh=single_device_mesh(), **base, **_kw(MESH_REFUSALS[setting], True)))
    with pytest.raises(NotImplementedError) as terr:
        ServingEngine(tp, tc, EngineConfig(mesh=one_rank_mesh, **base,
                                           **_kw(MESH_REFUSALS[setting], False)), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_engine_config_checks_mesh_and_data_shards(one_rank_mesh):
    EngineConfig(batch_size=2, ctx=16, mesh=one_rank_mesh, data_shards=1)
    with pytest.raises(ValueError, match="DeviceMesh"):
        EngineConfig(batch_size=2, ctx=16, mesh=object())
    for bad in (0, 2.0, -1):
        with pytest.raises(ValueError, match="data_shards"):
            EngineConfig(batch_size=2, ctx=16, data_shards=bad)
    jc, tc = _cfgs("mod-paper-60m")
    _, tp = _params(jc)
    with pytest.raises(ValueError, match="mesh data degree"):
        ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=16, mesh=one_rank_mesh,
                                           data_shards=2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by data_shards=4"):
        ServingEngine(tp, tc, EngineConfig(batch_size=6, ctx=16, data_shards=4), device="cpu")


# ---------------------------------------------------------------------------
# The rule table
# ---------------------------------------------------------------------------


MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 3}, {"data": 4, "model": 16},
          {"data": 2, "model": 64})


def _jax_leaves(jc):
    return flatten_dict(jax.eval_shape(lambda: JAPI.init_model(jax.random.PRNGKey(0), jc)))


def _jax_pspec(path, shape, sizes):
    """JAX's ``param_pspec`` on a mesh shape alone, without FSDP (serving)."""
    mcfg = JC.MeshConfig(pod=1, data=sizes["data"], model=sizes["model"], fsdp=False)
    return tuple(JSH.param_pspec(path, shape, types.SimpleNamespace(shape=sizes), mcfg))


@pytest.mark.parametrize("arch", ["mod-paper-60m", "olmoe-1b-7b", "mamba2-1.3b",
                                  "whisper-tiny"])
def test_rule_table_matches_jax_param_pspec(arch):
    jc, _ = _cfgs(arch)
    leaves = _jax_leaves(jc)
    n_split = n_fallback = 0
    for sizes in MESHES:
        for path, leaf in leaves.items():
            want = _jax_pspec(path, leaf.shape, sizes)
            got = TSH.param_placement(path, leaf.shape, sizes)
            assert got == want, (path, sizes)
            n_split += any(a is not None for a in got)
            for pat, trailing in TSH._RULES:
                if re.search(pat, path):
                    n_fallback += sum(a is not None for a in trailing) > sum(
                        a is not None for a in got[-len(trailing):])
                    break
    assert n_split and n_fallback  # both cases seen


@pytest.mark.parametrize("arch", ["mod-paper-60m", "olmoe-1b-7b"])
def test_shard_jax_params_cuts_each_rank_its_share(arch):
    """A (1, 2) mesh: rank r's tree holds the r-th half of every split dim
    (query heads, kv heads, d_ff columns, experts, vocab / D) and the
    halves concatenate back into the JAX leaf."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    sizes = {"data": 1, "model": 2}
    cut = [shard_jax_params(jax.tree.map(np.asarray, jp), tc, sizes,
                            {"data": 0, "model": r}, device="cpu") for r in range(2)]
    halves = [tree for tree, _ in cut]
    assert cut[0][1] == cut[1][1]  # every rank cuts the same leaves
    full = tp["groups"][0]["full"]
    assert halves[0]["groups"][0]["full"]["attn"]["wq"].shape[1] == (
        tc.attn.n_heads * tc.head_dim // 2)
    for name in ("wq", "wk", "wv"):
        both = torch.cat([h["groups"][0]["full"]["attn"][name] for h in halves], dim=1)
        assert torch.equal(both, full["attn"][name])
    wo = torch.cat([h["groups"][0]["full"]["attn"]["wo"] for h in halves], dim=0)
    assert torch.equal(wo, full["attn"]["wo"])
    ffn = "moe" if "moe" in full else "mlp"
    dim = 0 if ffn == "moe" else 1
    both = torch.cat([h["groups"][0]["full"][ffn]["w_up"] for h in halves], dim=dim)
    assert torch.equal(both, full[ffn]["w_up"])
    tok = tp["embed"]["tok"]  # (V, D): D over the model axis
    assert torch.equal(halves[1]["embed"]["tok"], tok[:, tok.shape[1] // 2:])
    # the router stays whole on every rank
    assert torch.equal(halves[1]["groups"][0]["mod"]["router"]["w"],
                       tp["groups"][0]["mod"]["router"]["w"])


@pytest.mark.parametrize("arch", ["mod-paper-60m", "olmoe-1b-7b", "qwen2-vl-7b",
                                  "granite-20b"])
def test_split_record_matches_jax_param_pspec(arch):
    """The leaves the cut records (what the layers reduce and gather over)
    are those JAX's ``param_pspec`` puts on "model", K/V aside: the port
    cuts K/V by whole kv heads (JAX by columns, which may split a head), so
    granite-20b's one kv head stays whole on every rank."""
    jc, tc = _cfgs(arch)
    jp = jax.tree.map(np.asarray, _jax_params(jc))
    leaves = _jax_leaves(jc)
    kv = {"attn/wk", "attn/wv", "attn/bk", "attn/bv"}
    for sizes in ({"data": 1, "model": 2}, {"data": 2, "model": 2}, {"data": 1, "model": 4}):
        model = {TSH.leaf_name(p) for p, leaf in leaves.items()
                 if "model" in _jax_pspec(p, leaf.shape, sizes)}
        for r in range(sizes["model"]):
            _, split = TSH.cut_tree(jp, tc, sizes, {"data": 0, "model": r})
            assert model - kv <= split and split - model <= kv, (sizes, r)
            assert {"attn/wo", "embed/tok", "embed/unemb"} <= split
            assert ("attn/wk" in split) == (tc.attn.n_kv_heads > 1)
            assert ("moe/w_up" in split) == (tc.family == "moe")
            assert ("mlp/w_down" in split) == (tc.family != "moe")


def test_layers_reduce_only_what_the_cut_recorded():
    """Outside a model-parallel call nothing is reduced or gathered, even
    for weights whose width differs from the config's (an MLP of its own
    hidden size, a narrower table): the layers ask the record, not shapes."""
    from repro_torch.models import layers as TL

    _, tc = _cfgs("mod-paper-60m")
    g = torch.Generator().manual_seed(0)
    D, F = tc.d_model, tc.d_ff // 2
    p = {"w_up": torch.randn(D, F, generator=g), "w_gate": torch.randn(D, F, generator=g),
         "w_down": torch.randn(F, D, generator=g)}
    x = torch.randn(2, 3, D, generator=g)
    assert torch.equal(TL.mlp(p, x, tc), TL.mlp_act(p, x, tc.act))
    emb = {"tok": torch.randn(tc.vocab, D // 2, generator=g),
           "unemb": torch.randn(D // 2, tc.vocab // 2, generator=g)}
    tok = torch.tensor([[1, 5]])
    assert torch.equal(TL.embed(emb, tok), emb["tok"][tok])
    h = torch.randn(1, 2, D // 2, generator=g)
    assert torch.equal(TL.unembed(emb, h), h @ emb["unemb"])
    assert not TSH.is_split("attn/wo")


def test_fused_dispatch_matches_jax_under_mesh_contexts():
    """Fused dispatch off under a split model axis, FSDP or MoE, as in JAX
    (mesh shapes alone: ``spmd`` needs only a mesh and its data axes)."""
    for arch in ("mod-paper-60m", "olmoe-1b-7b", "qwen2-vl-7b"):
        jc, tc = _cfgs(arch, backend="pallas_fused")
        for data, model, fsdp in ((2, 1, False), (2, 2, False), (2, 1, True), (1, 1, False)):
            jm = types.SimpleNamespace(shape={"data": data, "model": model})
            tm = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                       mesh=torch.zeros(data, model))
            jctx = JSH.ShardCtx(mesh=jm, data_axes=("data",), model_axis="model",
                                data_shards=data, fsdp=fsdp)
            tctx = TSH.ShardCtx(mesh=tm, data_axes=("data",), model_axis="model",
                                data_shards=data, fsdp=fsdp)
            assert TBLK.fused_dispatch_supported(tc, tctx) == JBLK.fused_dispatch_supported(
                jc, jctx), (arch, data, model, fsdp)
        assert TBLK.fused_dispatch_supported(tc) == JBLK.fused_dispatch_supported(jc)


def test_tensor_parallel_refusals():
    """What a split model axis accepts: every family at whole heads (the
    ssm, hybrid and enc-dec families at m = 2), tied embeddings, training
    with MQA and with kv heads shared by ranks; and what still raises:
    query heads or SSM heads that do not divide the axis."""
    for arch in ("mamba2-1.3b", "zamba2-2.7b", "whisper-tiny"):
        _, tc = _cfgs(arch)
        TSH.check_tensor_parallel(tc, 2)
        TSH.check_tensor_parallel(tc, 1)
    _, tc = _cfgs("mod-paper-60m")
    with pytest.raises(NotImplementedError, match="whole query heads"):
        TSH.check_tensor_parallel(tc, 3)
    _, ssm = _cfgs("mamba2-1.3b")  # 8 SSM heads at smoke size
    with pytest.raises(NotImplementedError, match="whole SSM heads"):
        TSH.check_tensor_parallel(ssm, 3)
    TSH.check_tensor_parallel(dataclasses.replace(tc, tie_embeddings=True), 2)
    mqa = dataclasses.replace(tc, attn=dataclasses.replace(tc.attn, n_heads=8, n_kv_heads=1))
    TSH.check_tensor_parallel(mqa, 4)  # the one kv head on every rank, training too
    assert [TSH.kv_head_range(mqa, 4, r) for r in range(4)] == [(0, 1)] * 4
    assert TSH.kv_copies(mqa, 4) == 4
    gqa = dataclasses.replace(tc, attn=dataclasses.replace(tc.attn, n_heads=8, n_kv_heads=2))
    assert [TSH.kv_head_range(gqa, 4, r) for r in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert [TSH.kv_head_range(gqa, 2, r) for r in range(2)] == [(0, 1), (1, 2)]
    assert (TSH.kv_copies(gqa, 4), TSH.kv_copies(gqa, 2)) == (2, 1)


# ---------------------------------------------------------------------------
# The mesh trainer's placements: FSDP params, the train state, the batch
# ---------------------------------------------------------------------------

# one architecture of every config module, at full size (the divisibility
# fallbacks depend on the real widths)
CONFIG_ARCHS = ("mod-paper-1b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
                "zamba2-2.7b", "whisper-tiny", "qwen2-vl-7b", "granite-8b", "granite-20b",
                "mistral-nemo-12b", "qwen2-7b")
TRAIN_MESHES = ({"data": 2, "model": 2}, {"data": 4, "model": 16},
                {"pod": 2, "data": 2, "model": 4}, {"data": 3, "model": 1})


def _abstract_mesh(sizes):
    return jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))


@functools.lru_cache(maxsize=None)
def _jax_state_shapes(arch):
    jc = JC.get_config(arch)
    params = jax.eval_shape(lambda: JAPI.init_model(jax.random.PRNGKey(0), jc))
    zeros = jax.ShapeDtypeStruct((), jnp.int32)
    return {"params": params, "opt": {"m": params, "v": params, "count": zeros}, "step": zeros}


def _specs(shardings):
    return {k: tuple(v.spec) for k, v in flatten_dict(shardings).items()}


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_fsdp_param_and_state_placement_match_jax(arch):
    """``param_placement(..., fsdp=True)`` and ``state_placement`` against
    JAX's ``param_pspec`` / ``state_shardings`` on every leaf, with and
    without FSDP, on 2- and 3-axis meshes."""
    state = _jax_state_shapes(arch)
    n_data = 0
    for sizes in TRAIN_MESHES:
        mesh = _abstract_mesh(sizes)
        for fsdp in (False, True):
            mcfg = JC.MeshConfig(pod=sizes.get("pod", 1), data=sizes["data"],
                                 model=sizes["model"], fsdp=fsdp)
            want = _specs(JSH.state_shardings(state, mesh, mcfg))
            got = flatten_dict(TSH.state_placement(state, sizes, fsdp=fsdp))
            assert got == want, (sizes, fsdp)
            for path, leaf in flatten_dict(state["params"]).items():
                spec = TSH.param_placement(path, leaf.shape, sizes, fsdp=fsdp)
                assert spec == tuple(JSH.param_pspec(path, leaf.shape, mesh, mcfg))
                n_data += "data" in spec
                dim = TSH.fsdp_dim(path, len(leaf.shape))
                if "data" in spec:  # the "F" slot is the dim FSDP gathers
                    assert spec[dim] == "data"
    assert n_data  # FSDP cut something


@pytest.mark.parametrize("sizes", TRAIN_MESHES, ids=lambda s: "x".join(map(str, s.values())))
def test_batch_placement_matches_jax(sizes):
    """``batch_placement`` against JAX's ``batch_shardings``: the batch dim
    over ("pod", "data"), M-RoPE positions on dim 1, replicated where the
    batch does not divide."""
    mesh = _abstract_mesh(sizes)
    for B in (12, 7):
        batch = {"tokens": np.zeros((B, 16), np.int32), "labels": np.zeros((B, 16), np.int32),
                 "loss_mask": np.zeros((B, 16), np.float32),
                 "embeds": np.zeros((B, 16, 8), np.float32),
                 "positions": np.zeros((3, B, 16), np.int32),
                 "enc_emb": np.zeros((B, 30, 8), np.float32)}
        want = _specs(JSH.batch_shardings(batch, mesh))
        assert flatten_dict(TSH.batch_placement(batch, sizes)) == want, (sizes, B)


def test_shard_ctx_data_axes_match_jax():
    """``shard_ctx(mesh, fsdp=...)``: the batch over the mesh's ("pod",
    "data") axes and its degree, as JAX's ``shard_ctx``; ``batch_axes``."""
    for sizes in TRAIN_MESHES:
        mesh = _abstract_mesh(sizes)
        assert TSH.batch_axes(sizes) == JSH.batch_axes(mesh)
    ctx = JSH.shard_ctx(None, data_shards=4, fsdp=True)
    tctx = TSH.shard_ctx(None, data_shards=4, fsdp=True)
    assert (tctx.data_shards, tctx.fsdp, tctx.mesh) == (ctx.data_shards, ctx.fsdp, None)
