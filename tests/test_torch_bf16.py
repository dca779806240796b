"""The port against the JAX package at bf16, on the CPU.

The f32 tests (``tests/test_torch_model.py`` and the others) hold the port
to JAX within 1e-4 and its greedy streams exactly. At bf16 the two
frameworks round at different points; this file holds what is mirrored
and bounds what is not, with the bounds measured on this CPU:

- SiLU: ``jax.nn.silu`` lowers to negate, exp, add 1, divide and multiply,
  each rounded to bf16; the port's ``layers.silu`` mirrors it:
  ``silu(g)·u`` at bf16 within one bf16 ulp of JAX's in at most 0.1% of
  entries (measured: bit-equal), within 4 f32 ulps at f32, and its
  gradient is JAX's (finite where ``exp(-x)`` overflows). Not mirrored:
  XLA on the CPU flushes a subnormal ``1 / (1 + exp(-x))`` (x in (-88.8,
  -87.3)) to zero where the port keeps it (products below 2^-110; a
  flush would cost another elementwise pass on the card).
- Sublayers on the same bf16 input (3 inputs x the 4 blocks of
  mod-paper-60m's smoke config): RMSNorm within one bf16 ulp, the port's
  dense ``attend`` (``attention.flash_attention`` swapped for it by a
  test-only patch) and the MLP within 2^-6 of their largest value, with
  0.1%, 1% and 0.5% of entries differing at most (measured 0.003%, 0.46%,
  0.14%). They are not bit-equal on every input: XLA and torch sum the
  RMSNorm mean and the bf16 GEMMs' f32 products in other orders, which
  flips a bf16 rounding in a few entries per 10^4, and attention's
  softmax and the MLP's gate carry a flip into their neighbours.
- A block's ``block_delta`` with that patch, JAX run in a child process
  under ``XLA_FLAGS=--xla_allow_excess_precision=false`` (XLA otherwise
  keeps bf16 sums in f32 across fused ops): within 2^-6 of its largest
  value, at most 5% of entries differing (measured 2.9%; 61% with XLA's
  default flags). The flag is set only in the child's environment.
- mod-paper-60m and -vanilla (smoke, bf16, the port's own flash path),
  four prompts: prefill and 8 decode steps fed the same tokens, logits
  within 0.125 of JAX's (measured at most 0.0703, logits up to ~4) while
  the routed slots agree; a near-tie of the decode router may fall the
  other way in at most one run (measured: one step of 32). Greedy streams
  are held exactly at f32 only.

Torch runs on one thread (a torch worker thread beside XLA now and then
computes ``exp`` off by ~1e-4, ROADMAP Queue 3).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JBLK  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TBLK  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

ARCHS = ["mod-paper-60m", "mod-paper-60m-vanilla"]
# (seed, B, S) of the sublayer and block inputs
INPUTS = [(4, 2, 12), (7, 4, 20), (9, 2, 64)]
# the sublayers' largest difference, relative to the largest JAX value (two
# bf16 ulps there), and the share of entries that may differ
REL = 2.0 ** -6
SHARE = {"rmsnorm": 1e-3, "attention": 1e-2, "mlp": 5e-3, "block_delta": 5e-2}
LOGITS_ATOL = 0.125


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_bits(a) -> np.ndarray:
    """Signed ordinals of bf16 bit patterns: adjacent values differ by 1."""
    bits = (a.contiguous().view(torch.int16).numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).view(np.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulps(jax_out, torch_out) -> np.ndarray:
    return np.abs(_bf16_bits(jax_out) - _bf16_bits(torch_out))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


# ---------------------------------------------------------------------------
# SiLU
# ---------------------------------------------------------------------------


def _silu_inputs(n=1 << 16):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(n) * 4).astype(np.float32)
    g[: n // 64] = rng.uniform(-120, 120, n // 64)  # exp(-x) overflows below -88.7
    return g, rng.standard_normal(n).astype(np.float32)


def _xla_flushed(g, want, got) -> np.ndarray:
    """Where XLA flushed a subnormal ``1 / (1 + exp(-x))`` (x in (-88.8,
    -87.3)) to zero and the port, which keeps subnormals, gives a product
    below 2^-110: the one place the mirror is not bit-equal."""
    got = np.abs(_np(got))
    return (g < -87) & (_np(want) == 0) & (got > 0) & (got < 2.0 ** -110)


def test_silu_times_up_matches_jax_at_bf16():
    g, u = _silu_inputs()
    want = jax.jit(lambda g, u: jax.nn.silu(g) * u)(jnp.asarray(g, jnp.bfloat16),
                                                     jnp.asarray(u, jnp.bfloat16))
    got = TL.silu(torch.as_tensor(g).bfloat16()) * torch.as_tensor(u).bfloat16()
    d = np.where(_xla_flushed(g, want, got), 0, _ulps(want, got))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (d.max(), np.mean(d > 0))
    assert np.mean(_xla_flushed(g, want, got)) < 1e-4
    # F.silu rounds once: it is not JAX's function at bf16
    once = torch.nn.functional.silu(torch.as_tensor(g).bfloat16()) * torch.as_tensor(u).bfloat16()
    assert np.mean(_ulps(want, once) > 0) > 0.1


def test_silu_within_4_ulps_of_jax_at_f32():
    g, _ = _silu_inputs()
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(g)))
    got = TL.silu(torch.as_tensor(g)).numpy()
    d = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert np.where(_xla_flushed(g, want, got), 0, d).max() <= 4, d.max()


def test_silu_gradient_is_jax_and_finite_where_exp_overflows():
    g, u = _silu_inputs(4096)
    want = np.asarray(jax.grad(lambda g: jnp.sum(jax.nn.silu(g) * u))(jnp.asarray(g)))
    x = torch.as_tensor(g).requires_grad_(True)
    (TL.silu(x) * torch.as_tensor(u)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Sublayers and one block
# ---------------------------------------------------------------------------


def _dense_attention(q, k, v, q_pos, kv_pos, causal, window, scale):
    """flash_attention's signature over the dense ``attend`` (JAX's model
    path: scores from the bf16 Q·K^T einsum, rounded, then widened)."""
    B, Sq, nq, hd = q.shape
    cfg = type("Cfg", (), {"attn": type("Attn", (), {"softmax_scale": scale})})()
    mask = TA.make_mask(q_pos, kv_pos, causal, window)
    return TA.attend(q, k, v, mask, cfg).reshape(B, Sq, nq, hd)


@functools.lru_cache(maxsize=None)
def _model(arch="mod-paper-60m"):
    jc = dataclasses.replace(JC.smoke_config(JC.get_config(arch)), dtype="bfloat16")
    tc = dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype="bfloat16")
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _blocks(jp, tp):
    """(JAX block, port block) of every block of the model."""
    for g, grp in enumerate(tp["groups"]):
        jg = jax.tree.map(lambda a: a[g], jp["groups"])
        for kind, tb in grp.items():
            yield ((jg[kind], tb) if kind == "full" else (jg[kind]["block"], tb["block"]))


def _inputs(seed, B, S, d):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    pos = np.sort(np.random.default_rng(seed + 1).choice(3 * S, (B, S)), axis=1)
    return x, pos.astype(np.int32)


def sublayer_differences(which, patch_attention):
    """{name: (largest |difference| / largest |JAX value|, share of entries
    that differ)} over INPUTS and every block, the same bf16 input to each
    side. A function of the module so the child process runs it too."""
    jc, tc, jp, tp = _model()
    fns = {
        "rmsnorm": (jax.jit(lambda p, x, ps: JL.rmsnorm(p["ln1"], x, jc.norm_eps)),
                    lambda p, x, ps: TL.rmsnorm(p["ln1"], x, tc.norm_eps)),
        "attention": (jax.jit(lambda p, x, ps: JA.self_attention(p["attn"], x, ps, jc)),
                      lambda p, x, ps: TA.self_attention(p["attn"], x, ps, tc)),
        "mlp": (jax.jit(lambda p, x, ps: JL.mlp(p["mlp"], x, jc)),
                lambda p, x, ps: TL.mlp(p["mlp"], x, tc)),
        "block_delta": (jax.jit(lambda p, x, ps: JBLK.block_delta(p, x, ps, jc)[0]),
                        lambda p, x, ps: TBLK.block_delta(p, x, ps, tc)[0]),
    }
    saved = TA.flash_attention
    if patch_attention:
        TA.flash_attention = _dense_attention
    out = {}
    try:
        for name in which:
            jf, tf = fns[name]
            worst, n_diff, n = 0.0, 0, 0
            for seed, B, S in INPUTS:
                x, pos = _inputs(seed, B, S, jc.d_model)
                for jb, tb in _blocks(jp, tp):
                    want = jf(jb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
                    got = tf(tb, torch.as_tensor(x).bfloat16(), torch.as_tensor(pos))
                    d = np.abs(_np(want) - _np(got))
                    worst = max(worst, float(d.max() / np.abs(_np(want)).max()))
                    n_diff, n = n_diff + int((d > 0).sum()), n + d.size
                    if name == "rmsnorm":
                        assert _ulps(want, got).max() <= 1
            out[name] = (worst, n_diff / n)
    finally:
        TA.flash_attention = saved
    return out


@pytest.mark.parametrize("name", ["rmsnorm", "attention", "mlp"])
def test_sublayers_match_jax_at_bf16(name):
    """The same bf16 input through JAX's sublayer and the port's, attention
    through the dense attend."""
    rel, share = sublayer_differences([name], patch_attention=True)[name]
    assert rel <= REL and share <= SHARE[name], (rel, share)


def test_block_delta_matches_jax_without_xla_excess_precision():
    """JAX's side in a child process with XLA's excess precision off (the
    flag in the child's environment only): what then separates a block is
    the score rounding of attention (mirrored here by the dense attend)
    and the sum orders above."""
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, __file__, "block_delta"], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rel, share = json.loads(proc.stdout.strip().splitlines()[-1])["block_delta"]
    assert rel <= REL and share <= SHARE["block_delta"], (rel, share)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax_at_bf16(arch):
    """The port's own path (flash attention) against JAX, four prompts of
    20 tokens each, then 8 decode steps fed the same tokens on both sides:
    logits within LOGITS_ATOL at every step whose routed slots agree. At
    bf16 a near-tie of the batch-capacity router can fall the other way
    (measured: once, in 32 MoD decode steps); a run is compared up to that
    step, and at most one of the four may part."""
    jc, tc, jp, tp = _model(arch)
    B, S, ctx = 4, 20, 32
    jprefill = jax.jit(lambda p, t: JAPI.model_prefill(p, jc, {"tokens": t}, ctx))
    jdecode = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    worst, parted = 0.0, 0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        feed = rng.integers(0, jc.vocab, (B, 8)).astype(np.int32)
        jl, jcache = jprefill(jp, jnp.asarray(toks))
        tl, tcache = TAPI.model_prefill(tp, tc, {"tokens": torch.as_tensor(toks).long()}, ctx)
        worst = max(worst, float(np.abs(_np(jl) - _np(tl)).max()))
        if jc.mod.enabled:  # the MoD rings hold the same routed tokens
            for g, jpos in enumerate(np.asarray(jcache["groups"]["mod"]["pos"])):
                np.testing.assert_array_equal(tcache["groups"][g]["mod"]["pos"].numpy(), jpos)
        active = np.ones(B, bool)
        for step in range(feed.shape[1]):
            tok, pos = feed[:, step:step + 1], np.full((B,), S + step, np.int32)
            jl, jcache, jaux = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                       jnp.asarray(active))
            tl, tcache, taux = TAPI.model_decode(tp, tcache, tc, torch.as_tensor(tok).long(),
                                                 torch.as_tensor(pos), torch.as_tensor(active))
            if "mod/decode_routed" in jaux and not np.array_equal(
                    _np(taux["mod/decode_routed"]), np.asarray(jaux["mod/decode_routed"])):
                parted += 1
                break
            worst = max(worst, float(np.abs(_np(jl) - _np(tl)).max()))
    assert worst <= LOGITS_ATOL and parted <= 1, (worst, parted)


if __name__ == "__main__":  # the child of test_block_delta_matches_jax_without_xla_excess_precision
    torch.set_num_threads(1)
    print(json.dumps(sublayer_differences(sys.argv[1:], patch_attention=True)))
