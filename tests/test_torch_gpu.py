"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch (the repository's ``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: gather/scatter are copies and exact updates, so bitwise; the
flash kernel sums its online softmax in another order than the dense plain
version (f32 atol 2e-5), and rounds p to bf16 against another running max
before p@V (bf16 atol and rtol 8e-3: one bf16 ulp of the output is at most
2^-7 of its value). The fused routed kernels (routed_attention,
routed_mlp_scatter) round where their plain versions round, but sum their
products in another order than cuBLAS: f32 within 1e-4 (atol and rtol);
in bf16 a sum that lands on the other side of a rounding boundary moves a
value by one bf16 ulp (2^-8 relative) and the following products carry it,
hence ROUTED_TOL.

Gradients: every wrapper is a ``torch.autograd.Function``; autograd
through it must match autograd through the plain version. Routed
attention / MLP recompute the plain version in their backward, so with a
loss linear in the outputs the two agree to the bit up to cuBLAS's own
order; gather/scatter backwards are the same two kernels (exact); the
flash backward is the blocked torch-op backward from the kernel's lse,
against autograd through the dense plain version (f32 1e-4; bf16: the
plain version's autograd rounds at its bf16 casts, the Function does not).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as TC  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import routing as KR  # noqa: E402
from repro_torch.kernels import swiglu as SW  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}
ROUTED_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
              torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,D,k", [(1, 77, 96, 10), (3, 2048, 1792, 256), (2, 33, 5, 33)])
def test_routing_kernels_bitwise(dev, dtype, B, S, D, k):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    delta = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    build.reset_counters()
    assert torch.equal(KR.gather_rows(x, idx), KR.gather_rows_plain(x, idx))
    assert torch.equal(KR.scatter_add_rows(x, idx, delta, gate),
                       KR.scatter_add_rows_plain(x, idx, delta, gate))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["gather_rows"] == 1 and counts["scatter_add_rows"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Sq,Skv,nq,nkv,hd,causal,window",
    [
        (2, 45, 45, 4, 2, 64, True, 0),  # GQA, ragged edges
        (1, 300, 300, 14, 14, 128, True, 0),
        (8, 1, 1056, 14, 14, 128, True, 0),  # decode against a ring
        (2, 17, 70, 4, 4, 32, False, 0),
        (1, 64, 64, 2, 1, 256, True, 16),  # sliding window
    ],
)
def test_flash_attention_matches_plain(dev, dtype, B, Sq, Skv, nq, nkv, hd, causal, window):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, Sq, nq, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    kv_pos[:, -3:] = -1  # empty slots / padded tail
    if Sq == Skv:
        q_pos = kv_pos.clone()
    else:
        q_pos = torch.randint(0, Skv, (B, Sq), generator=g, device=dev, dtype=torch.int32)
    build.reset_counters()
    got = FA.flash_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 2, 48, device=dev)
    pos = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q, pos, pos)
    with pytest.raises(TypeError):
        KR.gather_rows(torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 2, dtype=torch.int32,
                                                                         device=dev))


# ---------------------------------------------------------------------------
# fused routed block kernels
# ---------------------------------------------------------------------------


def _routed_inputs(dev, dtype, B, S, k, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    return g, x, idx


def _w(g, dev, dtype, *shape):
    return (torch.randn(*shape, generator=g, device=dev) / shape[0] ** 0.5).to(dtype)


def _attn_params(g, dev, dtype, D, nq, nkv, hd, bias):
    p = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
         "wq": _w(g, dev, dtype, D, nq * hd), "wk": _w(g, dev, dtype, D, nkv * hd),
         "wv": _w(g, dev, dtype, D, nkv * hd), "wo": _w(g, dev, dtype, nq * hd, D)}
    if bias:
        for key, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[key] = (0.1 * torch.randn(n * hd, generator=g, device=dev)).to(dtype)
    return p


ATTN_CASES = [
    # B, S, k, D, nq, nkv, hd, bias, window, pos_emb
    (2, 64, 13, 64, 4, 2, 32, True, 0, "rope"),  # GQA, biases, k not a multiple of 16
    (1, 300, 40, 256, 4, 4, 64, False, 16, "rope"),  # sliding window
    (2, 128, 37, 128, 2, 1, 128, False, 0, "none"),
    (1, 64, 20, 512, 2, 2, 256, False, 0, "rope"),  # head_dim 256: > 48 KB shared memory
    (4, 2048, 256, 1792, 14, 14, 128, False, 0, "rope"),  # mod-paper-1b training shape
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,k,D,nq,nkv,hd,bias,window,pos_emb", ATTN_CASES)
def test_routed_attention_matches_plain(dev, dtype, B, S, k, D, nq, nkv, hd, bias, window,
                                        pos_emb):
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 2)
    pos = idx.to(torch.int32)
    pos[0, 0] = -1  # a key without a position is masked out
    params = _attn_params(g, dev, dtype, D, nq, nkv, hd, bias)
    spec = FA.RoutedAttnSpec(nq, nkv, hd, hd ** -0.5, True, window, 10000.0, pos_emb, 1e-5)
    build.reset_counters()
    a, h = FA.routed_attention(x, idx, pos, params, spec)
    wa, wh = FA.routed_attention_plain(x, idx, pos, params, spec)
    torch.cuda.synchronize()
    assert build.launch_counts()["routed_attention"] == 1
    torch.testing.assert_close(a.float(), wa.float(), **ROUTED_TOL[dtype])
    torch.testing.assert_close(h.float(), wh.float(), **ROUTED_TOL[dtype])


MLP_CASES = [
    # B, S, k, D, F, act, glu
    (2, 64, 13, 64, 96, "silu", True),
    (1, 100, 30, 128, 200, "gelu", True),
    (2, 48, 17, 64, 130, "gelu", False),
    (4, 2048, 256, 1792, 7168, "silu", True),  # mod-paper-1b training shape
]


def _mlp_params(g, dev, dtype, D, F, glu):
    p = {"ln": (1 + 0.1 * torch.randn(D, generator=g, device=dev)).to(dtype),
         "w_up": _w(g, dev, dtype, D, F), "w_down": _w(g, dev, dtype, F, D)}
    if glu:
        p["w_gate"] = _w(g, dev, dtype, D, F)
    return p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,k,D,F,act,glu", MLP_CASES)
def test_routed_mlp_scatter_matches_plain(dev, dtype, B, S, k, D, F, act, glu):
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 3)
    h = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    a = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    params = _mlp_params(g, dev, dtype, D, F, glu)
    spec = SW.RoutedMlpSpec(act, 1e-5)
    build.reset_counters()
    out = SW.routed_mlp_scatter(x, h, a, idx, gate, params, spec)
    want = SW.routed_mlp_scatter_plain(x, h, a, idx, gate, params, spec)
    torch.cuda.synchronize()
    assert build.launch_counts()["routed_mlp_scatter"] == 1
    routed = torch.zeros(B, S, dtype=torch.bool, device=dev)
    routed.scatter_(1, idx, True)
    assert torch.equal(out[~routed], x[~routed])  # rows that are not routed pass through
    torch.testing.assert_close(out.float(), want.float(), **ROUTED_TOL[dtype])


# ---------------------------------------------------------------------------
# gradients through every kernel's autograd.Function
# ---------------------------------------------------------------------------


def _grads(fn, inputs, seed):
    """Gradients of a loss linear in fn's outputs (fixed random weights), so
    the cotangents do not depend on the forward values."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=outs[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    loss.backward()
    return [t.grad for t in leaves if t.requires_grad]


def _assert_grads(got, want, tol):
    for a, b in zip(got, want):
        assert a is not None and b is not None
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routing_gradients_match_plain(dev, dtype):
    _, x, idx = _routed_inputs(dev, dtype, 2, 300, 40, 256, 4)
    g = torch.Generator(device=dev).manual_seed(5)
    delta = torch.randn(2, 40, 256, generator=g, device=dev).to(dtype)
    gate = torch.randn(2, 40, generator=g, device=dev)
    build.reset_counters()
    got = _grads(lambda x_: KR.gather_rows(x_, idx), [x], 0)
    want = _grads(lambda x_: KR.gather_rows_plain(x_, idx), [x], 0)
    assert torch.equal(got[0], want[0])
    got = _grads(lambda *t: KR.scatter_add_rows(t[0], idx, t[1], t[2]), [x, delta, gate], 1)
    want = _grads(lambda *t: KR.scatter_add_rows_plain(t[0], idx, t[1], t[2]), [x, delta, gate], 1)
    torch.cuda.synchronize()
    # gather's backward is a scatter launch and scatter's a gather launch
    assert build.launch_counts()["gather_rows"] == 2
    assert build.launch_counts()["scatter_add_rows"] == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_gradients_match_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(6)
    B, S, nq, nkv, hd = 2, 300, 4, 2, 64
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev).to(dtype)
               for n in (nq, nkv, nkv))
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    pos[:, -5:] = -1
    build.reset_counters()
    got = _grads(lambda *t: FA.flash_attention(*t, pos, pos), [q, k, v], 7)
    want = _grads(lambda *t: FA.flash_attention_plain(*t, pos, pos), [q, k, v], 7)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    _assert_grads(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernel_gradients_match_plain(dev, dtype):
    B, S, k, D, nq, hd, F = 2, 96, 24, 128, 4, 32, 192
    g, x, idx = _routed_inputs(dev, dtype, B, S, k, D, 8)
    pos = idx.to(torch.int32)
    ap = _attn_params(g, dev, dtype, D, nq, nq, hd, True)
    spec = FA.RoutedAttnSpec(nq, nq, hd, hd ** -0.5, True, 0, 10000.0, "rope", 1e-5)
    keys = list(ap)
    got = _grads(lambda x_, *ps: FA.routed_attention(x_, idx, pos, dict(zip(keys, ps)), spec),
                 [x, *ap.values()], 9)
    want = _grads(lambda x_, *ps: FA.routed_attention_plain(x_, idx, pos, dict(zip(keys, ps)),
                                                            spec), [x, *ap.values()], 9)
    _assert_grads(got, want, dict(atol=1e-5, rtol=1e-5))
    h = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    a = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    mp = _mlp_params(g, dev, dtype, D, F, True)
    mspec = SW.RoutedMlpSpec("silu", 1e-5)
    mkeys = list(mp)
    got = _grads(lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter(
        x_, h_, a_, idx, g_, dict(zip(mkeys, ps)), mspec), [x, h, a, gate, *mp.values()], 10)
    want = _grads(lambda x_, h_, a_, g_, *ps: SW.routed_mlp_scatter_plain(
        x_, h_, a_, idx, g_, dict(zip(mkeys, ps)), mspec), [x, h, a, gate, *mp.values()], 10)
    _assert_grads(got, want, dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
def test_training_step_launches_the_backends_kernels(dev, backend):
    """A loss and its gradients on the card: pallas_fused runs the fused
    kernels and no gather/scatter; xla and pallas the reverse."""
    from repro_torch.models import api
    from repro_torch.utils import tree_leaves

    cfg = TC.with_mod_backend(TC.smoke_config(TC.get_config("mod-paper-60m")), backend)
    params = api.init_model(cfg, device=dev, seed=0)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=dev)
    build.reset_counters()
    loss, _ = api.model_loss(params, cfg, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    n = len(params["groups"])
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tree_leaves(params))
    if backend == "pallas_fused":
        assert counts["flash_attention"] == n  # the full blocks only
        assert counts["routed_attention"] == counts["routed_mlp_scatter"] == n
        assert counts["gather_rows"] == counts["scatter_add_rows"] == 0
    else:
        assert counts["flash_attention"] == 2 * n  # full blocks and routed sub-sequences
        # forward gather + scatter, and each one's backward launches the other
        assert counts["gather_rows"] == counts["scatter_add_rows"] == 2 * n
        assert counts["routed_attention"] == counts["routed_mlp_scatter"] == 0
