"""Tensor parallelism of the ssm, hybrid and enc-dec families over two gloo
ranks (CPU) against the JAX package's single-device training and serving.

``mamba2-1.3b``, ``zamba2-2.7b`` and ``whisper-tiny`` at smoke size cut to
2 layers (one group: a full and a routed block; one hybrid segment), f32,
the same weights (the JAX tree carried by ``from_jax_params``) and one
global batch of 8 rows with an uneven loss mask. One 2-rank spawn on the
mesh (1, 2) holds, on every rank:

- the loss within 1e-5 (relative) of JAX's ``value_and_grad(model_loss)``
  and each gradient leaf within 2e-5 of that leaf's largest |grad|, cut to
  the rank's placement: the SSM's whole leaves (``w_B``, ``w_C``,
  ``w_dt``, the B/C conv taps) are whole on the rank and hold the whole
  gradient, the sum of every rank's part (``sharding.whole_in_split``);
- two full steps (clip, cosine LR, AdamW) against JAX's
  ``make_train_step``, as tests/test_torch_mesh_train.py holds them (the
  grad norm counts each whole leaf once);
- three greedy requests through the mesh engine (stepped ingestion; the
  whisper cross-KV filled at admission, a rank its heads) with the JAX
  engine's streams, and each pool leaf of the shape ``cache_placement``
  cuts (SSM state heads and ``conv_x`` channels over "model", the B/C
  windows whole, the attention rings at the rank's kv heads);
- the loss and gradients of mamba2 and zamba2 under remat "none" and
  "selective" equal to "full"'s (the recomputation re-enters the mesh
  context with the SSM block's collectives);
- the gated RMSNorm over a rank's half of ``d_inner``: with the sum of
  squares summed over "model" it is the whole norm's half; a local
  ``rmsnorm`` of the half is not.

The 4-rank cases (kv heads shared by ranks, MQA, tied embeddings, a pod
axis) are tests/test_torch_tp_kv.py. The spawned ranks import this module
to find their function, so JAX and the JAX package are imported inside the
parent's functions only.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as TC  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.train import loop as L  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from tests.test_torch_mesh_train import (  # noqa: E402
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    M_TOL,
    P_OUTLIERS,
    P_TOL,
    V_TOL,
    B,
    S,
    _batch,
    _collect,
    _ctx,
    _jax_modules,
    _local,
    _np,
    _one_mesh,
    _start,
    _tcfg,
)

ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "whisper-tiny")
LAYERS = 2
SERVE_B, SERVE_CTX, SERVE_GEN = 4, 24, 6
NORM_WIDTH = 64  # the gated norm's d_inner in the unit case


# ---------------------------------------------------------------------------
# Configurations, batches, requests: one spec a case, both packages
# ---------------------------------------------------------------------------


def case_config(C, arch, attn=None, **kw):
    """The smoke config of ``arch`` in package ``C`` (the JAX package's
    config module or the port's), f32, ``LAYERS`` layers, ``attn``:
    AttentionConfig fields to replace. The routed blocks gather and
    scatter: the port's dispatch kernels ("pallas": their plain versions
    here), JAX's reference dispatch ("xla")."""
    cfg = C.smoke_config(C.get_config(arch))
    if attn:
        kw["attn"] = dataclasses.replace(cfg.attn, **attn)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=LAYERS, **kw)
    return C.with_mod_backend(cfg, "pallas" if C is TC else "xla")


def case_batch(cfg):
    """The global batch: tokens, labels, an uneven loss mask, and the
    enc-dec family's stub frames."""
    batch = _batch(cfg.vocab)
    if cfg.family == "encdec":
        rng = np.random.default_rng(4)
        batch["enc_emb"] = (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model))
                            * 0.02).astype(np.float32)
    return batch


def case_requests(cfg, n=3, seed=3):
    """(tokens, max_new_tokens, enc_emb or None) of ``n`` requests: prompts
    of distinct tokens (a token twice can tie a routed layer's top-k within
    an ulp, which the packages break differently)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        enc = None
        if cfg.family == "encdec":
            enc = (rng.standard_normal((cfg.enc_seq_len, cfg.d_model)) * 0.02).astype(np.float32)
        out.append((rng.permutation(cfg.vocab)[: 5 + i].astype(np.int32), SERVE_GEN, enc))
    return out


def mesh_streams(cfg, tree, mesh, **engine):
    """This rank's run of ``case_requests`` through the mesh engine: the
    streams, and each pool leaf's shape beside the one ``cache_placement``
    cuts."""
    from repro_torch.models import api
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(from_jax_params(tree, "cpu"), cfg,
                        EngineConfig(batch_size=SERVE_B, ctx=SERVE_CTX, mesh=mesh, **engine),
                        device="cpu")
    with torch.no_grad():
        outs = eng.run_stream([Request(tokens=t, max_new_tokens=g, enc_emb=e)
                               for t, g, e in case_requests(cfg)], 2)
    sizes = SH.mesh_sizes(mesh)
    full = api.make_caches(cfg, SERVE_B, SERVE_CTX, device="meta")
    placed = [tuple(n // SH._axis_size(sizes, ax) for n, ax in zip(leaf.shape, SH.cache_placement(
        SH._path(keys), leaf.shape, mesh, SERVE_B))) for keys, leaf in SH._leaves(full)]
    return dict(streams={o.uid: o.tokens.tolist() for o in outs},
                shapes=[tuple(t.shape) for t in tree_leaves(eng.pool.caches)], placed=placed,
                paths=[SH._path(k) for k, _ in SH._leaves(eng.pool.caches)],
                rows=eng.pool.rows, row0=eng.pool.row0)


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _norm_halves(spmd):
    """The gated norm of this rank's half of a (2, 3, NORM_WIDTH) input:
    through ``ssm._gated_norm`` with ``norm/scale`` split (the sum of
    squares summed over "model"), and a local ``rmsnorm`` of the half."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, NORM_WIDTH), generator=g)
    scale = torch.rand((NORM_WIDTH,), generator=g) + 0.5
    m, r = spmd.model_shards, spmd.coords()["model"]
    n = NORM_WIDTH // m
    half, p = x[..., r * n:(r + 1) * n], {"scale": scale[r * n:(r + 1) * n]}
    with SH.model_parallel(dataclasses.replace(spmd, split=frozenset({"norm/scale"}))):
        split = SSM._gated_norm(p, half, NORM_WIDTH, 1e-5)
    return split.numpy(), rmsnorm(p, half, 1e-5).numpy()


def _remat_grads(cfg, spmd, tree, batch):
    """The loss and gradients of the first step under remat "none" and
    "selective" (the config's own is "full"): the recomputation re-enters
    the mesh context, so the SSM block's collectives run again in it."""
    out = {}
    for mode in ("none", "selective"):
        c = dataclasses.replace(cfg, remat=mode)
        state = L.make_train_state(c, "cpu", params=from_jax_params(tree, "cpu"), spmd=spmd)
        loss, _, grads = L.make_grads_fn(c, _tcfg(), spmd)(state["params"], _local(batch, spmd),
                                                            0)
        out[mode] = (float(loss), _np(grads))
    return out


def _rank(trees, batches):
    out = {}
    spmd = _ctx(1, 2)
    for arch in ARCHS:
        cfg = case_config(TC, arch)
        out[arch] = _one_mesh(cfg, spmd, trees[arch], batches[arch])
        out[arch]["serve"] = mesh_streams(cfg, trees[arch], spmd.mesh)
        if cfg.family != "encdec":
            out[arch]["remat"] = _remat_grads(cfg, spmd, trees[arch], batches[arch])
    out["norm"] = _norm_halves(spmd)
    return out


# ---------------------------------------------------------------------------
# References (the parent process)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_init(arch, attn=None, **kw):
    """(JAX config, initial tree) of a case (``attn``: a tuple of
    AttentionConfig items)."""
    J = _jax_modules()
    jc = case_config(J.C, arch, dict(attn) if attn else None, **kw)
    return jc, J.jax.jit(J.api.init_model, static_argnums=1)(J.jax.random.PRNGKey(0), jc)


def host_tree(t):
    return _jax_modules().jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def jax_run(arch, attn=None, **kw):
    """JAX's loss and gradients of a case on its global batch, and its two
    train steps' metrics and state."""
    J = _jax_modules()
    jax = J.jax
    jc, jp = jax_init(arch, attn, **kw)
    batch = case_batch(jc)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: J.api.model_loss(p, jc, b)[0]))(
        jp, batch)
    jt = J.C.TrainConfig(global_batch=B, seq_len=S,
                         optim=J.C.OptimConfig(lr=LR, warmup_steps=1, total_steps=10))
    step = jax.jit(J.loop.make_train_step(jc, jt))
    state = {"params": jp, "opt": J.adamw_init(jp), "step": jax.numpy.zeros((), jax.numpy.int32)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(tree=host_tree(jp), batch=batch, loss=float(loss), grads=host_tree(grads),
                metrics=metrics, state=host_tree(state))


@functools.lru_cache(maxsize=None)
def jax_streams(arch, data_shards=None, attn=None, **kw):
    """The JAX engine's greedy streams of ``case_requests`` (``data_shards``:
    the partitioned routing a pod mesh is held to)."""
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServingEngine as JServingEngine

    jc, jp = jax_init(arch, attn, **kw)
    eng = JServingEngine(jp, jc, engine=JEngineConfig(batch_size=SERVE_B, ctx=SERVE_CTX,
                                                      data_shards=data_shards))
    outs = eng.run_stream([JRequest(tokens=t, max_new_tokens=g, enc_emb=e)
                           for t, g, e in case_requests(jc)], 2)
    return {o.uid: o.tokens.tolist() for o in outs}


def port_leaves(jtree):
    """A JAX-layout tree of numpy leaves as the port's (path, tensor) leaves."""
    port = from_jax_params(jtree, "cpu")
    return [(SH._path(keys), leaf) for keys, leaf in SH._leaves(port)]


def cut(path, full, cfg, model, coords):
    return SH.cut_leaf(path, full, cfg, {"data": 1, "model": model}, coords).numpy()


def check_loss_and_grads(got, ref, cfg, model, rank):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    for (path, full), g in zip(port_leaves(ref["grads"]), got["grads"]):
        want = cut(path, full, cfg, model, got["coords"])
        assert g.shape == want.shape, (path, rank)
        np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_TOL * np.abs(full.numpy()).max()
                                   + 1e-12, err_msg=f"{path} rank {rank}")


def check_steps(got, ref, cfg, model, rank):
    """Two steps' loss and grad norm, moments and parameters, as
    tests/test_torch_mesh_train.py holds them."""
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=LOSS_RTOL)
    want = {k: port_leaves(v) for k, v in (("params", ref["state"]["params"]),
                                           ("m", ref["state"]["opt"]["m"]),
                                           ("v", ref["state"]["opt"]["v"]))}
    for key, tol in (("m", M_TOL), ("v", V_TOL)):
        for (path, full), t in zip(want[key], got[key]):
            np.testing.assert_allclose(t, cut(path, full, cfg, model, got["coords"]), rtol=0,
                                       atol=tol * np.abs(full.numpy()).max() + 1e-12,
                                       err_msg=f"{key} {path} rank {rank}")
    for (path, full), t in zip(want["params"], got["params"]):
        err = np.abs(t - cut(path, full, cfg, model, got["coords"]))
        np.testing.assert_array_less(err, 2 * LR * 2, err_msg=f"{path} rank {rank}")
        far = int((err > 1e-5 + P_TOL * np.abs(full.numpy()).max()).sum())
        assert far <= P_OUTLIERS * err.size, (path, rank, far, err.size, err.max())
    assert got["bytes"] == got["placed"], rank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of the 2-rank spawn; the JAX references compile
    while the ranks run."""
    trees = {arch: host_tree(jax_init(arch)[1]) for arch in ARCHS}
    batches = {arch: case_batch(jax_init(arch)[0]) for arch in ARCHS}
    started = _start(tmp_path_factory.mktemp("tp_families"), 2, _rank, trees, batches)
    for arch in ARCHS:
        jax_run(arch)
        jax_streams(arch)
    return _collect(*started)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_and_grads_match_jax(runs, arch):
    cfg = case_config(TC, arch)
    for r, ranks in enumerate(runs):
        check_loss_and_grads(ranks[arch], jax_run(arch), cfg, 2, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_steps_match_jax(runs, arch):
    cfg = case_config(TC, arch)
    for r, ranks in enumerate(runs):
        check_steps(ranks[arch], jax_run(arch), cfg, 2, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_mesh_engine_streams_match_jax(runs, arch):
    want = jax_streams(arch)
    for r, ranks in enumerate(runs):
        assert ranks[arch]["serve"]["streams"] == want, f"rank {r}"


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_tp_remat_modes_agree(runs, arch):
    """Under remat "none" and "selective" a rank's loss and gradients are
    its "full" ones (within 1e-6 of the loss, GRAD_TOL of a leaf's largest
    |grad|)."""
    assert case_config(TC, arch).remat == "full"
    for r, ranks in enumerate(runs):
        got = ranks[arch]
        for mode, (loss, grads) in got["remat"].items():
            np.testing.assert_allclose(loss, got["loss"], rtol=1e-6, err_msg=f"{mode} rank {r}")
            for g, want in zip(grads, got["grads"]):
                np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max()
                                           + 1e-12, err_msg=f"{mode} rank {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_pool_holds_the_placement(runs, arch):
    """Each rank's pool: every slot (data 1), every leaf of the shape
    ``cache_placement`` cuts: SSM state heads and ``conv_x`` channels
    halved, the B/C windows whole, the rings at half the kv heads."""
    cfg = case_config(TC, arch)
    for r, ranks in enumerate(runs):
        got = ranks[arch]["serve"]
        assert (got["rows"], got["row0"]) == (SERVE_B, 0)
        assert got["shapes"] == got["placed"], r
        for path, shape in zip(got["paths"], got["shapes"]):
            leaf = path.rsplit("/", 1)[-1]
            if leaf == "state":
                assert shape[1] == cfg.ssm.n_heads(cfg.d_model) // 2, path
            elif leaf in ("conv_B", "conv_C"):
                assert shape[-1] == cfg.ssm.d_state, path
            elif leaf in ("k", "v"):
                assert shape[-2] == cfg.attn.n_kv_heads // 2, path


def test_ssm_whole_leaves_are_replicated_in_the_rule():
    """The SSM's B, C and dt projections and the B/C conv taps are
    replicated by the rule (and so by ``MeshLayout``): the clip counts each
    once, and their gradient is whole on every rank because the block sums
    it where the leaf is used. The channel leaves are cut on "model"."""
    cfg = case_config(TC, "mamba2-1.3b")
    sizes = {"data": 1, "model": 2}
    from repro_torch.models import api

    full = api.init_model(cfg, device="meta", generator=torch.Generator())
    specs = {SH._path(k): SH.rank_placement(SH._path(k), leaf.shape, cfg, sizes)
             for k, leaf in SH._leaves(full)}
    whole = {"w_B", "w_C", "w_dt", "conv_B", "conv_C", "conv_bB", "conv_bC"}
    seen = set()
    for path, spec in specs.items():
        name = path.rsplit("/", 1)[-1]
        if "/ssm/" in path and name in whole:
            assert "model" not in spec, path
            seen.add(name)
        elif "/ssm/" in path:
            assert "model" in spec, path
    assert seen == whole


def test_gated_norm_sums_the_squares_over_the_model_axis(runs):
    """With a rank's half of d_inner, the split norm equals the whole
    norm's half; a local ``rmsnorm`` of the half does not."""
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, NORM_WIDTH), generator=g)
    scale = torch.rand((NORM_WIDTH,), generator=g) + 0.5
    whole = rmsnorm({"scale": scale}, x, 1e-5).numpy()
    n = NORM_WIDTH // 2
    for r, ranks in enumerate(runs):
        split, local = ranks["norm"]
        want = whole[..., r * n:(r + 1) * n]
        np.testing.assert_allclose(split, want, rtol=0, atol=1e-6)
        assert np.abs(local - want).max() > 1e-2


def test_check_tensor_parallel_holds_ssm_heads_and_query_heads():
    cfg = case_config(TC, "mamba2-1.3b")  # 8 SSM heads; its 4 attention heads unused
    SH.check_tensor_parallel(cfg, 8)
    with pytest.raises(NotImplementedError, match="whole SSM heads"):
        SH.check_tensor_parallel(cfg, 3)
    hyb = case_config(TC, "zamba2-2.7b")  # 8 SSM heads, 4 attention heads
    SH.check_tensor_parallel(hyb, 4)
    with pytest.raises(NotImplementedError, match="whole query heads"):
        SH.check_tensor_parallel(hyb, 8)
    full = TC.get_config("whisper-tiny")  # 6 heads: 2 and 3 ranks, not 4
    SH.check_tensor_parallel(full, 3)
    with pytest.raises(NotImplementedError, match="whole query heads"):
        SH.check_tensor_parallel(full, 4)


def test_cross_attention_is_cut_as_self_attention():
    """The attention collectives ask ``is_split("attn/wo")`` (and "attn/wq",
    ...); the decoder's cross-attention leaves are ``xattn/*``. Both are cut
    by the same rule at the same heads, so the answer holds for both."""
    from repro_torch.models import api

    cfg = case_config(TC, "whisper-tiny")
    full = api.init_model(cfg, device="meta", generator=torch.Generator())
    model, _ = SH.split_names(full, cfg, {"data": 1, "model": 2})
    for leaf in ("wq", "wk", "wv", "wo"):
        assert f"attn/{leaf}" in model and f"xattn/{leaf}" in model, leaf
