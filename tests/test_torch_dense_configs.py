"""The four further dense configs (granite-8b, granite-20b, mistral-nemo-12b,
qwen2-7b) in the port against the JAX package, on the CPU.

The registered configs (and zamba2-2.7b's) equal the JAX package's field
for field, full size and smoke size, with the same parameter counts.

``smoke_config`` shrinks every config to 4 heads of 32 on ``d_model`` 128,
which hides what sets these models apart, so the model-level cases use
reduced configs that keep it (``REDUCED``): GQA with a group of 4
(granite-8b), MQA with 48 query heads on one kv head (granite-20b),
``d_model`` 160 against ``n_heads·head_dim`` 128 (mistral-nemo-12b), and a
group of 7 with q/k/v biases drawn non-zero on both sides (qwen2-7b); rope
θ is each config's own. In f32, the same weights in both packages:

- the forward's logits within 1e-4 of their largest, loss and aux within
  1e-5, every gradient leaf within 1e-4 of the leaf's largest |grad|,
  under the ``xla`` and ``pallas_fused`` backends;
- prefill, chunked prefill and decode logits within 1e-4 (atol and
  rtol), the routed masks and ring positions exactly;
- greedy streams of the paged, prefix-cached, ragged and fused
  speculative engines equal to the JAX engine's, token for token;
- the flash kernel's plain version at group 7 and MQA against the Pallas
  kernel in interpret mode (1e-5), and ``routed_attention``'s against the
  JAX host mirror at the configs' widths (1e-5): d_model != nq·hd, biases,
  MQA.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

NEW_ARCHS = ["granite-8b", "granite-8b-dense", "granite-20b", "granite-20b-dense",
             "mistral-nemo-12b", "mistral-nemo-12b-dense", "qwen2-7b", "qwen2-7b-dense",
             "zamba2-2.7b", "zamba2-2.7b-dense"]
# each dense config's smoke size with its own attention shape kept
REDUCED = {
    "granite-8b": dict(n_heads=8, n_kv_heads=2),  # GQA, a group of 4
    "granite-20b": dict(n_heads=48, n_kv_heads=1),  # MQA
    "mistral-nemo-12b": dict(n_heads=4, n_kv_heads=2, d_model=160),  # nq*hd 128 != 160
    "qwen2-7b": dict(n_heads=14, n_kv_heads=2),  # a group of 7, q/k/v biases
}
ARCHS = sorted(REDUCED)
TOL = 1e-4  # logits, of the largest |value|
GRAD_TOL = 1e-4  # of the leaf's largest |grad|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (a torch worker thread
    beside JAX's in one process has been seen to compute ``exp`` off by
    ~1e-4, tests/test_torch_ssm.py)."""
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


def _reduced(C, arch):
    kw = dict(REDUCED[arch])
    cfg = C.smoke_config(C.get_config(arch))
    d_model = kw.pop("d_model", cfg.d_model)
    return dataclasses.replace(cfg, dtype="float32", d_model=d_model,
                               attn=dataclasses.replace(cfg.attn, **kw))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params): the same weights, the
    q/k/v biases (where the config has them) drawn non-zero."""
    jc, tc = _reduced(JC, arch), _reduced(TC, arch)
    jp = jax.tree.map(np.asarray, jax.jit(JAPI.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(11)

    def biases(tree):
        if isinstance(tree, dict):
            return {k: (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k in ("bq", "bk", "bv") else biases(v) for k, v in tree.items()}
        return tree

    jp = biases(jp)
    return jc, jax.tree.map(jnp.asarray, jp), tc, from_jax_params(jp, device="cpu")


def _batch(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registered_configs_equal_jax_field_for_field(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    for j, t in ((jc, tc), (JC.smoke_config(jc), TC.smoke_config(tc))):
        for f in dataclasses.fields(TC.ModelConfig):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(tv):
                for g in dataclasses.fields(tv):
                    assert getattr(tv, g.name) == getattr(jv, g.name), (f.name, g.name)
            else:
                assert tv == jv, f.name
        assert t.n_params() == j.n_params()
        assert t.head_dim == j.head_dim


def test_reduced_configs_keep_the_features():
    g = {a: _reduced(TC, a) for a in ARCHS}
    assert g["granite-20b"].attn.n_heads // g["granite-20b"].attn.n_kv_heads == 48
    assert g["qwen2-7b"].attn.n_heads // g["qwen2-7b"].attn.n_kv_heads == 7
    assert g["qwen2-7b"].attn.qkv_bias and g["qwen2-7b"].attn.rope_theta == 1e6
    m = g["mistral-nemo-12b"]
    assert m.attn.n_heads * m.head_dim != m.d_model and m.attn.rope_theta == 1e6
    tp = _models("qwen2-7b")[3]
    assert all(float(tp["groups"][0]["full"]["attn"][k].abs().min()) > 0 for k in ("bq", "bk"))


# ---------------------------------------------------------------------------
# Forward, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas_fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, backend):
    """Under ``pallas_fused`` the routed blocks run ``routed_attention`` and
    ``routed_mlp_scatter`` (JAX: its Pallas kernels in interpret mode)."""
    jc, jp, tc, tp = _models(arch)
    jc, tc = JC.with_mod_backend(jc, backend), TC.with_mod_backend(tc, backend)
    batch = _batch(jc.vocab)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    jlogits, _ = jax.jit(lambda p, b: JAPI.model_forward(p, jc, b))(jp, batch)
    with torch.no_grad():
        tlogits, _ = TAPI.model_forward(tp, tc, tb)
    _close(_np(tlogits), jlogits)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JAPI.model_loss(p, jc, b), has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    tl, taux = TAPI.model_loss(tp, tc, tb)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]), rtol=1e-5,
                                   atol=1e-6)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(tree_map(lambda p: p.grad, tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)


# ---------------------------------------------------------------------------
# Prefill, chunked prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    jc, jp, tc, tp = _models(arch)
    B, S, ctx = 4, 20, 32
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t: JAPI.model_prefill(p, jc, {"tokens": t}, ctx))(jp, toks)
    with torch.no_grad():
        tl, tcache = TAPI.model_prefill(tp, tc, {"tokens": torch.as_tensor(toks).long()}, ctx)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    jdecode = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    active = np.array([True, False, True, True])
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        jl2, jcache, jaux = jdecode(jp, jcache, tok, pos, active)
        with torch.no_grad():
            tl2, tcache, taux = TAPI.model_decode(tp, tcache, tc, torch.as_tensor(tok).long(),
                                                  torch.as_tensor(pos), torch.as_tensor(active))
        np.testing.assert_allclose(_np(tl2), np.asarray(jl2), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(_np(taux["mod/decode_routed"]),
                                      np.asarray(jaux["mod/decode_routed"]))
        tok = np.asarray(jnp.argmax(jl2, axis=-1)).astype(np.int32)[:, None]
    for kind in ("full", "mod"):
        for g, jpos in enumerate(np.asarray(jcache["groups"][kind]["pos"])):
            np.testing.assert_array_equal(tcache["groups"][g][kind]["pos"].numpy(), jpos)
            _close(_np(tcache["groups"][g][kind]["k"]),
                   np.asarray(jcache["groups"][kind]["k"][g]), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch):
    jc, jp, tc, tp = _models(arch)
    C, L, ctx = 8, 21, 32  # three chunks, the last one padded
    toks = np.random.default_rng(3).integers(0, jc.vocab, (1, L)).astype(np.int32)
    jchunk = jax.jit(lambda p, c, t, s, n: JAPI.model_prefill_chunk(p, jc, c, t, s, n))
    jcache = JAPI.make_caches(jc, 1, ctx)
    tcache = TAPI.make_caches(tc, 1, ctx, device="cpu")
    for off in range(0, L, C):
        nv = min(C, L - off)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :nv] = toks[0, off:off + nv]
        jl, jcache = jchunk(jp, jcache, chunk, jnp.int32(off), jnp.int32(nv))
        with torch.no_grad():
            tl, tcache = TAPI.model_prefill_chunk(tp, tc, tcache, torch.as_tensor(chunk).long(),
                                                  off, nv)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
        np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)


# ---------------------------------------------------------------------------
# Engines: greedy streams equal the JAX engine's
# ---------------------------------------------------------------------------

ENGINES = {
    "paged": dict(page_size=4, prefill_chunk=4),
    "prefix": dict(page_size=4, prefill_chunk=4, prefix_cache=True),
    "ragged": dict(page_size=4, prefill_chunk=4, ragged=True, ragged_segments=2),
    "speculative": dict(page_size=4, prefill_chunk=4, speculate=3, draft_ratio=0.125),
}


def _prompts(vocab, n=5, prefix=8, seed=7, tails=(3, 5, 2, 6, 4)):
    """A shared prefix and distinct tails, no token twice in a prompt (a
    repeated token can tie a routed layer's top-k within an ulp, which the
    two packages break differently)."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(vocab)
    shared, rest = pool[:prefix], pool[prefix:]
    return [np.concatenate([shared, rng.choice(rest, tails[i], replace=False)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_jax(arch, engine):
    jc, jp, tc, tp = _models(arch)
    prompts = _prompts(jc.vocab)
    news = [5, 3, 6, 4, 5]
    kw = dict(batch_size=2, ctx=24, **ENGINES[engine])
    teng = ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")
    tout = teng.run_stream([Request(tokens=p, max_new_tokens=n) for p, n in zip(prompts, news)],
                           1)
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(**kw))
    jout = jeng.run_stream([JRequest(tokens=p, max_new_tokens=n) for p, n in zip(prompts, news)],
                           1)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    ts, js = teng.stats(), jeng.stats()
    for key in ("steps", "prefill_tokens_computed", "kv_bytes"):
        assert ts[key] == js[key], key
    if engine == "prefix":
        assert ts["prefix_hit_rate"] == js["prefix_hit_rate"] > 0
    if engine == "speculative":
        assert ts["speculative_rounds"] == js["speculative_rounds"] > 0


# ---------------------------------------------------------------------------
# Kernels' plain versions at the new shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Skv,nq,nkv", [(1, 64, 14, 2), (4, 64, 14, 2), (32, 32, 14, 2),
                                           (1, 64, 48, 1), (32, 32, 48, 1)])
def test_flash_plain_matches_pallas_at_group_7_and_mqa(Sq, Skv, nq, nkv):
    rng = np.random.default_rng(5)
    B, hd = 2, 32
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, nkv, hd)).astype(np.float32) for _ in range(2))
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kp[1, -3:] = -1  # empty cache slots
    want = JFA.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), causal=True, block_q=32,
                               block_kv=32, interpret=True)
    got = TFA.flash_attention(*map(torch.as_tensor, (q, k, v, qp, kp)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("D,nq,nkv,bias", [(160, 4, 2, False), (96, 14, 2, True),
                                           (64, 48, 1, False)])
def test_routed_attention_plain_matches_the_jax_mirror_at_the_config_widths(D, nq, nkv, bias):
    """mistral-nemo's d_model != nq·hd, qwen2's group of 7 with biases,
    granite-20b's MQA: routed rows, values and gradients."""
    B, S, k, hd = 2, 40, 13, 32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    idx = np.sort(np.stack([rng.choice(S, k, replace=False) for _ in range(B)]), 1).astype(
        np.int32)
    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    p = {"ln": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32), "wq": w(D, nq * hd),
         "wk": w(D, nkv * hd), "wv": w(D, nkv * hd), "wo": w(nq * hd, D)}
    if bias:
        for key, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[key] = (0.5 * rng.standard_normal(n * hd)).astype(np.float32)
    jspec = JFA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, 1e6, "rope", 1e-5, 128, True)
    tspec = TFA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, 1e6, "rope", 1e-5)
    ca = rng.standard_normal((B, k, D)).astype(np.float32)

    def jloss(x_, p_):
        a, h = JFA._routed_attention_host(x_, idx, idx, p_, jspec)
        return jnp.sum(a * ca) + jnp.sum(h), (a, h)

    (_, (ja, jh)), (jdx, jdp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                           has_aux=True))(x, p)
    tx = torch.tensor(x, requires_grad=True)
    tp = {key: torch.tensor(v, requires_grad=True) for key, v in p.items()}
    ta, th = TFA.routed_attention(tx, torch.as_tensor(idx).long(), torch.as_tensor(idx), tp,
                                  tspec)
    ((ta * torch.as_tensor(ca)).sum() + th.sum()).backward()
    for got, want in ((ta, ja), (th, jh), (tx.grad, jdx)):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    for key in p:
        np.testing.assert_allclose(tp[key].grad.numpy(), jdp[key], atol=1e-5, rtol=1e-5)


def test_param_counts_of_the_port_init_equal_jax():
    for arch in ARCHS:
        jc, jp, tc, _ = _models(arch)
        tinit = TAPI.init_model(tc, device="cpu", seed=0)
        assert sum(t.numel() for t in tree_leaves(tinit)) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
