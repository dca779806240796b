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
- ``cross_entropy``, the router BCE and the predictor BCE/accuracy, 1e-6;
- ``routed_attention_path``, the pure planner of the kernel's projection
  GEMM: wgmma for aligned bf16 with D a multiple of 8, the CUDA cores
  otherwise, a raise for what the kernel does not take, and the path it
  chose is what the C entry point receives and the launch counter records.
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


# ---------------------------------------------------------------------------
# routed_attention_path: the GEMM of the kernel's projections, before launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,k,D,nq,nkv,hd", [
    (4, 256, 1792, 14, 14, 128),  # mod-paper-1b training
    (1, 1, 72, 3, 1, 32),  # M = 1; D and nq*hd multiples of 8, not of 64
    (3, 43, 200, 3, 1, 32),
    (2, 13, 64, 4, 2, 256),
])
def test_routed_attention_path_takes_wgmma_for_aligned_bf16(B, k, D, nq, nkv, hd):
    assert TFA.routed_attention_path(torch.bfloat16, B, k, D, nq, nkv, hd, True) == "wgmma"


@pytest.mark.parametrize("dtype,B,k,D,aligned", [
    (torch.float32, 4, 256, 1792, True),  # f32 keeps the CUDA cores
    (torch.bfloat16, 2, 21, 44, True),  # D not a multiple of 8
    (torch.bfloat16, 4, 256, 1792, False),  # a weight's base off 16 bytes
    (torch.bfloat16, 2, 0, 64, True),  # no routed row: TMA takes no empty tensor
])
def test_routed_attention_path_takes_the_cuda_cores_otherwise(dtype, B, k, D, aligned):
    assert TFA.routed_attention_path(dtype, B, k, D, 2, 2, 64, aligned) == "cuda_cores"


@pytest.mark.parametrize("dtype,B,k,nq,nkv,hd,err,match", [
    (torch.float16, 1, 8, 2, 2, 64, TypeError, "dtype"),
    (torch.bfloat16, 1, 8, 2, 2, 48, ValueError, "head_dim"),
    (torch.bfloat16, 1, 8, 3, 2, 64, ValueError, "multiple"),
    (torch.bfloat16, 1, 8, 70000, 1, 64, ValueError, "at most"),  # gridDim.y
    (torch.bfloat16, 2 ** 15, 2 ** 16, 2, 2, 64, ValueError, "GEMM sizes"),  # B*k > C int
])
def test_routed_attention_path_raises_for_what_the_kernel_does_not_take(dtype, B, k, nq, nkv,
                                                                        hd, err, match):
    with pytest.raises(err, match=match):
        TFA.routed_attention_path(dtype, B, k, 64, nq, nkv, hd, True)


class _FakeEntry:
    """Stands in for the C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("dtype,offset,want", [(torch.bfloat16, 0, "wgmma"),
                                               (torch.bfloat16, 1, "cuda_cores"),
                                               (torch.float32, 0, "cuda_cores")])
def test_routed_attention_passes_the_path_to_the_entry_point(monkeypatch, dtype, offset, want):
    """The path routed_attention_path chose is the argument the C entry
    point gets, and the launch counter records it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(TFA.build, "bind", lambda *a: entry)
    monkeypatch.setattr(TFA.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    B, S, k, D, nq, nkv, hd = 2, 9, 4, 40, 3, 1, 32
    buf = torch.zeros(offset + nq * hd * D, dtype=dtype)
    params = {"ln": torch.ones(D, dtype=dtype), "wq": torch.zeros(D, nq * hd, dtype=dtype),
              "wk": torch.zeros(D, nkv * hd, dtype=dtype),
              "wv": torch.zeros(D, nkv * hd, dtype=dtype),
              "wo": buf[offset:].view(nq * hd, D)}  # contiguous; 2 or 4 bytes in at offset 1
    spec = TFA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
    idx = torch.tensor([[0, 2, 4, 6], [1, 3, 5, 7]])
    TFA.build.reset_counters()
    TFA._routed_attention_launch(torch.zeros(B, S, D, dtype=dtype), idx, idx.int(), params, spec)
    # (20 pointers, B, S, k, D, nq, nkv, hd, dtype, path, eps, ...)
    assert entry.args[20:27] == (B, S, k, D, nq, nkv, hd)
    assert entry.args[28] == TFA.GEMM_PATHS[want]
    assert TFA.ROUTED_ATTENTION.by_call == {(want, B, S, k, D, nq, nkv, hd): 1}
    TFA.build.reset_counters()
