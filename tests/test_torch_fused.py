"""The fused routed-block kernels' plain versions, the kernel wrappers'
gradients and the training losses against the JAX package (CPU, f32).

On the CPU every kernel wrapper is its ``torch.autograd.Function`` with
the plain PyTorch version as forward, so these tests hold both the plain
versions and the backwards against JAX:

- ``routed_attention`` / ``routed_mlp_scatter`` against the jitted JAX host
  mirrors (``_routed_attention_host``, ``_routed_mlp_host``), values and
  gradients, over silu/gelu, GLU and plain MLPs, qkv biases, a sliding
  window, GQA, no RoPE, and k not a multiple of the Pallas kernel's 128-row
  tile; once each against the Pallas kernels in interpret mode. Tolerance
  1e-5 (atol and rtol): f32 sums in another order (largest difference
  seen on values: 7e-7);
- the backwards of ``gather_rows`` / ``scatter_add_rows`` against the JAX
  custom VJPs (Pallas in interpret mode): dx and ddelta bit for bit,
  dgate within 1e-6 (a sum over D in another order);
- the flash backward (torch ops from the saved lse) against ``jax.grad``
  of the model's dense ``attend``, 1e-5;
- ``cross_entropy``, the router BCE and the predictor BCE/accuracy, 1e-6.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.kernels import routing as JKR  # noqa: E402
from repro.kernels import swiglu as JSW  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import routing as TKR  # noqa: E402
from repro_torch.kernels import swiglu as TSW  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensors: with the suite's parallel workers, torch's default of
    one thread per core oversubscribes the machine. Two threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rows(rng, B, S, k):
    return np.sort(np.stack([rng.choice(S, k, replace=False) for _ in range(B)]), 1).astype(np.int32)


def _w(rng, *shape):
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


ATTN = [
    # B, S, D, nq, nkv, hd, k, bias, window, pos_emb
    (2, 40, 64, 4, 2, 16, 13, True, 0, "rope"),
    (1, 300, 64, 2, 2, 32, 130, False, 0, "rope"),  # k > 128, not a multiple of it
    (2, 48, 32, 4, 1, 8, 20, False, 6, "rope"),  # sliding window, GQA 4:1
    (2, 32, 32, 2, 2, 16, 9, True, 0, "none"),
]


def _attn_case(B, S, D, nq, nkv, hd, k, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    idx = _rows(rng, B, S, k)
    p = {"ln": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "wq": _w(rng, D, nq * hd), "wk": _w(rng, D, nkv * hd), "wv": _w(rng, D, nkv * hd),
         "wo": _w(rng, nq * hd, D)}
    if bias:
        for key, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[key] = (0.1 * rng.standard_normal(n * hd)).astype(np.float32)
    return x, idx, p


@pytest.mark.parametrize("B,S,D,nq,nkv,hd,k,bias,window,pos_emb", ATTN)
def test_routed_attention_matches_the_jax_mirror(B, S, D, nq, nkv, hd, k, bias, window, pos_emb):
    x, idx, p = _attn_case(B, S, D, nq, nkv, hd, k, bias)
    pos = idx.copy()
    jspec = JFA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, window, 10000.0, pos_emb, 1e-5,
                               128, True)
    tspec = TFA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, window, 10000.0, pos_emb, 1e-5)
    rng = np.random.default_rng(1)
    ca, ch = (rng.standard_normal((B, k, D)).astype(np.float32) for _ in range(2))

    def jloss(x_, p_):
        a, h = JFA._routed_attention_host(x_, idx, pos, p_, jspec)
        return jnp.sum(a * ca) + jnp.sum(h * ch), (a, h)

    (_, (ja, jh)), (jdx, jdp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        x, p)
    tx = _t(x, True)
    tp = {key: _t(v, True) for key, v in p.items()}
    ta, th = TFA.routed_attention(tx, torch.as_tensor(idx).long(), torch.as_tensor(pos), tp, tspec)
    ((ta * _t(ca)).sum() + (th * _t(ch)).sum()).backward()
    np.testing.assert_allclose(ta.detach().numpy(), ja, **TOL)
    np.testing.assert_allclose(th.detach().numpy(), jh, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jdx, **TOL)
    for key in p:
        np.testing.assert_allclose(tp[key].grad.numpy(), jdp[key], **TOL)


MLP = [
    # B, S, D, F, k, act, glu
    (2, 40, 64, 96, 13, "silu", True),
    (2, 40, 64, 96, 13, "gelu", True),
    (1, 300, 32, 64, 130, "gelu", False),
    (2, 24, 32, 48, 7, "silu", False),
]


def _mlp_case(B, S, D, F, k, glu, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    h, a = (rng.standard_normal((B, k, D)).astype(np.float32) for _ in range(2))
    idx = _rows(rng, B, S, k)
    gate = rng.standard_normal((B, k)).astype(np.float32)
    p = {"ln": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "w_up": _w(rng, D, F), "w_down": _w(rng, F, D)}
    if glu:
        p["w_gate"] = _w(rng, D, F)
    return x, h, a, idx, gate, p


@pytest.mark.parametrize("B,S,D,F,k,act,glu", MLP)
def test_routed_mlp_scatter_matches_the_jax_mirror(B, S, D, F, k, act, glu):
    x, h, a, idx, gate, p = _mlp_case(B, S, D, F, k, glu)
    jspec = JSW.RoutedMlpSpec(act, 1e-5, 256, True)
    cot = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)

    def jloss(x_, h_, a_, g_, p_):
        out = JSW._routed_mlp_host(x_, h_, a_, idx, g_, p_, jspec)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(x, h, a, gate, p)
    tin = [_t(v, True) for v in (x, h, a, gate)]
    tp = {key: _t(v, True) for key, v in p.items()}
    out = TSW.routed_mlp_scatter(tin[0], tin[1], tin[2], torch.as_tensor(idx).long(), tin[3], tp,
                                 TSW.RoutedMlpSpec(act, 1e-5))
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for t, j in zip(tin, jgrads[:4]):
        np.testing.assert_allclose(t.grad.numpy(), j, **TOL)
    for key in p:
        np.testing.assert_allclose(tp[key].grad.numpy(), jgrads[4][key], **TOL)


def test_fused_plain_versions_match_the_pallas_kernels():
    """Once each against the Pallas kernels in interpret mode (k = 20 over
    the kernel's 128-row tile: a padded tail)."""
    B, S, D, nq, hd, k, F = 2, 48, 64, 4, 16, 20, 96
    x, idx, p = _attn_case(B, S, D, nq, nq, hd, k, True, seed=4)
    jspec = JFA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5, 128, True)
    ja, jh = JFA.routed_attention(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(idx),
                                  jax.tree.map(jnp.asarray, p), jspec)
    tspec = TFA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
    ta, th = TFA.routed_attention(_t(x), torch.as_tensor(idx).long(), torch.as_tensor(idx),
                                  {key: _t(v) for key, v in p.items()}, tspec)
    np.testing.assert_allclose(ta.numpy(), ja, **TOL)
    np.testing.assert_allclose(th.numpy(), jh, **TOL)
    x, h, a, idx, gate, mp = _mlp_case(B, S, D, F, k, True, seed=5)
    jout = JSW.routed_mlp_scatter(*map(jnp.asarray, (x, h, a, idx, gate)),
                                  jax.tree.map(jnp.asarray, mp),
                                  JSW.RoutedMlpSpec("silu", 1e-5, 16, True))
    tout = TSW.routed_mlp_scatter(_t(x), _t(h), _t(a), torch.as_tensor(idx).long(), _t(gate),
                                  {key: _t(v) for key, v in mp.items()},
                                  TSW.RoutedMlpSpec("silu", 1e-5))
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def test_routing_backwards_match_the_jax_vjps():
    rng = np.random.default_rng(6)
    B, S, D, k = 2, 37, 24, 9
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    idx = _rows(rng, B, S, k)
    delta = rng.standard_normal((B, k, D)).astype(np.float32)
    gate = rng.standard_normal((B, k)).astype(np.float32)
    cs = rng.standard_normal((B, S, D)).astype(np.float32)
    cg = rng.standard_normal((B, k, D)).astype(np.float32)

    def jloss(x_, d_, g_):
        sub = JKR.gather_rows(x_, idx, interpret=True, block_s=16)
        out = JKR.scatter_add_rows(x_, idx, d_, g_, interpret=True, block_s=16)
        return jnp.sum(sub * cg) + jnp.sum(out * cs)

    jdx, jdd, jdg = jax.grad(jloss, argnums=(0, 1, 2))(x, delta, gate)
    tx, td, tg = _t(x, True), _t(delta, True), _t(gate, True)
    ti = torch.as_tensor(idx).long()
    ((TKR.gather_rows(tx, ti) * _t(cg)).sum()
     + (TKR.scatter_add_rows(tx, ti, td, tg) * _t(cs)).sum()).backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jdx)
    np.testing.assert_array_equal(td.grad.numpy(), jdd)
    np.testing.assert_allclose(tg.grad.numpy(), jdg, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("nq,nkv,window", [(4, 2, 0), (2, 2, 5)])
def test_flash_backward_matches_jax_attend(nq, nkv, window):
    rng = np.random.default_rng(7)
    B, S, hd = 2, 24, 16
    q = rng.standard_normal((B, S, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    pos = np.sort(rng.choice(60, (B, S), replace=False), 1).astype(np.int32)
    cot = rng.standard_normal((B, S, nq, hd)).astype(np.float32)
    cfg = dataclasses.replace(JC.smoke_config(JC.get_config("mod-paper-60m")), dtype="float32",
                              attn=JC.AttentionConfig(n_heads=nq, n_kv_heads=nkv, head_dim=hd,
                                                      window=window))

    def jloss(q_, k_, v_):
        mask = JA.make_mask(jnp.asarray(pos), jnp.asarray(pos), True, window)
        return jnp.sum(JA.attend(q_, k_, v_, mask, cfg).reshape(B, S, nq, hd) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    tpos = torch.as_tensor(pos)
    out = TFA.flash_attention(tq, tk, tv, tpos, tpos, causal=True, window=window)
    (out * _t(cot)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), j, **TOL)


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) < 0.6
    for m in (None, mask):
        want = JL.cross_entropy(logits, labels, None if m is None else jnp.asarray(m))
        got = TL.cross_entropy(_t(logits), torch.as_tensor(labels),
                               None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    r = (2 * rng.standard_normal((3, 40))).astype(np.float32)
    topk = rng.random((3, 40)) < 0.125
    np.testing.assert_allclose(float(TR.router_aux_loss(_t(r), torch.as_tensor(topk))),
                               float(JR.router_aux_loss(r, topk)), rtol=1e-6)
    tl, ta = TR.predictor_loss_and_acc(_t(r), torch.as_tensor(topk))
    jl, ja = JR.predictor_loss_and_acc(r, topk)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(ta) == float(ja)
    # the targets carry no gradient, the logits do
    tr = _t(r, True)
    TR.router_aux_loss(tr, torch.as_tensor(topk)).backward()
    jgr = jax.grad(lambda r_: JR.router_aux_loss(r_, topk))(r)
    np.testing.assert_allclose(tr.grad.numpy(), jgr, rtol=1e-5, atol=1e-8)
