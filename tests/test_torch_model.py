"""The port's dense MoD model against the JAX package, on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``), same
tokens: prefill, chunked prefill and decode logits agree within 1e-4 in
f32 (the two frameworks sum matmuls and reductions in different orders),
and the per-step routed masks of decode agree exactly. Also: the weight
carry-over keeps tree structure and bf16 bits, and the port imports
nothing of JAX or of the JAX package.
"""
import ast
import dataclasses
import functools
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import blocks as JBLK  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import blocks as TBLK  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4
ARCHS = ["mod-paper-60m", "mod-paper-60m-vanilla"]


def _cfgs(arch, dtype="float32"):
    jc = dataclasses.replace(JC.smoke_config(JC.get_config(arch)), dtype=dtype)
    tc = dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype=dtype)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(jc, seed):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _params(jc, seed=0):
    jp = _jax_params(jc, seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(jc, ctx):
    """The JAX entry points, compiled once per (config, ctx)."""
    return (
        jax.jit(lambda p, t: JAPI.model_prefill(p, jc, {"tokens": t}, ctx)),
        jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a)),
        jax.jit(lambda p, c, t, s, n: JAPI.model_prefill_chunk(p, jc, c, t, s, n)),
    )


def _np(t):
    return t.detach().float().numpy()


def test_from_jax_params_roundtrips_structure_and_bf16_bits():
    jc, tc = _cfgs("mod-paper-60m", dtype="bfloat16")
    jp, tp = _params(jc)
    assert len(tp["groups"]) == 2 and set(tp["groups"][0]) == {"full", "mod"}
    assert tp["groups"][0]["mod"]["block"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["groups"][1]["mod"]["router"]["w"].dtype == torch.float32
    back = to_numpy_tree(tp)
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # per-layer order: group i of the port is slice i of the stacked leaves
    np.testing.assert_array_equal(
        tp["groups"][1]["full"]["mlp"]["w_up"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jp["groups"]["full"]["mlp"]["w_up"][1]).view(np.uint16),
    )


def test_port_init_model_draws_the_jax_shapes_and_scales():
    jc, tc = _cfgs("mod-paper-60m")
    jp = jax.tree.map(np.asarray, _jax_params(jc, 0))
    tp = to_numpy_tree(TAPI.init_model(tc, device="cpu", seed=0))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.25, atol=1e-6)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    B, S, ctx = 4, 20, 32
    toks = _tokens(B, S, jc.vocab)
    jprefill, jdecode, _ = _jitted(jc, ctx)
    jl, jcache = jprefill(jp, jnp.asarray(toks))
    tl, tcache = TAPI.model_prefill(tp, tc, {"tokens": torch.as_tensor(toks).long()}, ctx)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=RTOL)
    if jc.mod.enabled:
        # the MoD ring holds exactly the routed tokens: same routing decision
        for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
            np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)

    active = np.array([True, True, False, True])
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        jl2, jcache, jaux = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                    jnp.asarray(active))
        tl2, tcache, taux = TAPI.model_decode(
            tp, tcache, tc, torch.as_tensor(tok).long(), torch.as_tensor(pos),
            torch.as_tensor(active),
        )
        np.testing.assert_allclose(_np(tl2), np.asarray(jl2), atol=ATOL, rtol=RTOL)
        assert set(taux) == set(jaux)
        for key in ("mod/decode_routed", "mod/decode_routed_frac"):
            if key in jaux:
                np.testing.assert_array_equal(_np(taux[key]), np.asarray(jaux[key]))
        tok = np.asarray(jnp.argmax(jl2, axis=-1)).astype(np.int32)[:, None]
    if jc.mod.enabled:
        for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
            np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    C, L, ctx = 8, 21, 32  # three chunks, the last one padded
    toks = _tokens(1, L, jc.vocab, seed=3)
    jcache = JAPI.make_caches(jc, 1, ctx)
    jchunk = _jitted(jc, ctx)[2]
    tcache = TAPI.make_caches(tc, 1, ctx, device="cpu")
    for off in range(0, L, C):
        nv = min(C, L - off)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :nv] = toks[0, off:off + nv]
        jl, jcache = jchunk(jp, jcache, jnp.asarray(chunk), jnp.int32(off), jnp.int32(nv))
        tl, tcache = TAPI.model_prefill_chunk(tp, tc, tcache, torch.as_tensor(chunk).long(), off, nv)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=RTOL)
    if jc.mod.enabled:
        for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
            np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)
    for g, jcur in enumerate(np.asarray(jcache["groups"]["full"]["cursor"])):
        np.testing.assert_array_equal(tcache["groups"][g]["full"]["cursor"].numpy(), jcur)


def test_block_delta_matches_jax():
    jc, tc = _cfgs("mod-paper-60m")
    jp, tp = _params(jc)
    x = np.random.default_rng(4).standard_normal((2, 12, jc.d_model)).astype(np.float32)
    pos = np.sort(np.random.default_rng(5).choice(40, (2, 12), replace=True), axis=1).astype(np.int32)
    jblock = jax.tree.map(lambda a: a[0], jp["groups"]["mod"]["block"])
    jd, _ = jax.jit(lambda b, x, p: JBLK.block_delta(b, x, p, jc))(
        jblock, jnp.asarray(x), jnp.asarray(pos))
    td, _ = TBLK.block_delta(tp["groups"][0]["mod"]["block"], torch.as_tensor(x),
                             torch.as_tensor(pos), tc)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL, rtol=RTOL)


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, tc = _cfgs("mod-paper-60m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TAPI.init_model(tc)


def test_other_families_raise_naming_the_roadmap():
    cfg = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m")), family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TAPI.init_model(cfg, device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
