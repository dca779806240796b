"""The port's flat ragged forward (``model_forward_ragged``) against the JAX
package, on the CPU.

- Kernels: the plain versions of the ragged MoD gather and gated
  scatter-add (what the wrappers run for CPU tensors) equal the Pallas
  kernels in interpret mode, bit for bit in f32 and bf16, including
  segments shorter than their capacity (``-1`` selections: zero rows in,
  nothing out, no neighbouring row touched); ``flat_segment_ids``.
- Routing: ``decide_tokens_ragged`` selects JAX's ``idx`` and ``mask``;
  its gates equal JAX's on dyadic inputs (router dot products then sum
  exactly in any order).
- Model: ``model_forward_ragged`` gives JAX's logits within 1e-5 (f32)
  with equal routed masks in every MoD layer; on equal-length segments it
  gives the port's padded ``model_forward``; with MoD off each unequal
  segment gives its sequence alone; the three backend names give equal
  logits.
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import routing as JROUT  # noqa: E402
from repro.kernels import ragged as JRG  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from tests.test_torch_paged import model_pair  # noqa: E402

DTYPES = ["float32", "bfloat16"]
TOL = 1e-5  # f32: the two frameworks sum the model's dot products in other orders


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _flat_case(dtype, seed=0, lens=(3, 1, 0, 5), cap=4, d=16):
    """Flat stream + per-segment selections with masked (-1) tails and a
    short padded tail behind the last segment; the same values as JAX
    arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T = int(offs[-1]) + 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    idx = np.full((len(lens), cap), -1, np.int32)
    for s, L in enumerate(lens):
        k = min(cap, L)
        idx[s, :k] = offs[s] + np.sort(rng.choice(L, size=k, replace=False))
    delta = rng.standard_normal((len(lens), cap, d)).astype(np.float32)
    gate = np.where(idx >= 0, rng.standard_normal((len(lens), cap)), 0.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = (jnp.asarray(x, jdt), jnp.asarray(idx), jnp.asarray(delta, jdt), jnp.asarray(gate))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(idx), torch.from_numpy(delta).to(tdt),
         torch.from_numpy(gate))
    return j, t, offs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,cap", [((3, 1, 0, 5), 4), ((7, 2, 9), 5), ((4, 4), 4)])
def test_ragged_dispatch_plain_matches_pallas(dtype, lens, cap):
    (jx, jidx, jdelta, jgate), (tx, tidx, tdelta, tgate), _ = _flat_case(dtype, lens=lens,
                                                                         cap=cap, d=24)
    got = KRG.ragged_gather_rows(tx, tidx)
    want = JRG.ragged_gather_rows(jx, jidx, interpret=True)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert bool((got[tidx < 0] == 0).all())
    got = KRG.ragged_scatter_add_rows(tx, tidx, tdelta, tgate)
    want = JRG.ragged_scatter_add_rows(jx, jidx, jdelta, jgate, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_ragged_scatter_masked_tail_does_not_leak():
    """A -1 selection touches no flat row, in particular not the first row
    of the next segment; the input stream is not written."""
    _, (tx, tidx, tdelta, tgate), _ = _flat_case("float32", lens=(2, 3), cap=4)
    before = tx.clone()
    out = KRG.ragged_scatter_add_rows(tx, tidx, torch.ones_like(tdelta) * 1e3, tgate)
    assert torch.equal(tx, before)
    touched = set(tidx[tidx >= 0].tolist())
    assert (tidx < 0).any()
    for t in range(tx.shape[0]):
        if t not in touched:
            assert torch.equal(out[t], tx[t])


def test_flat_segment_ids_and_guards():
    offs = np.asarray([0, 3, 3, 7], np.int32)
    got = KRG.flat_segment_ids(torch.from_numpy(offs), 9)
    want = JRG.flat_segment_ids(jnp.asarray(offs), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    x = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_gather_rows(x, torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        KRG.ragged_gather_rows(x.detach(), torch.zeros(1, 1, dtype=torch.int64))


@pytest.mark.parametrize("lens", [(6, 2, 9), (4, 4, 4), (1, 0, 7)])
def test_decide_tokens_ragged_matches_jax(lens):
    """Dyadic stream and router weights: every router logit is exact in both
    frameworks, so the gates must be equal too, not just the selection."""
    jc, jp, tc, tp = model_pair(True)
    rng = np.random.default_rng(3)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T, D = int(offs[-1]) + 3, jc.d_model
    x = (rng.integers(-8, 9, size=(1, T, D)) / 8.0).astype(np.float32)
    w = (rng.integers(-8, 9, size=(D,)) / 16.0).astype(np.float32)
    w[:4] = 0.0  # ties: equal logits must still rank lower index first
    x[0, :, 4:] = np.where(rng.random((T, D - 4)) < 0.2, 0.0, x[0, :, 4:])
    jparams = {"router": {"w": jnp.asarray(w)}}
    tparams = {"router": {"w": torch.from_numpy(w)}}
    cap = max(lens)
    jd = JROUT.decide_tokens_ragged(jparams, jnp.asarray(x), jnp.asarray(offs), jc, cap)
    td = TROUT.decide_tokens_ragged(tparams, torch.from_numpy(x), torch.from_numpy(offs), tc, cap)
    assert td.strategy == "token_topk_ragged" and td.idx.dtype == torch.int32
    np.testing.assert_array_equal(td.idx.numpy(), np.asarray(jd.idx))
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_array_equal(td.gate.numpy(), np.asarray(jd.gate))
    np.testing.assert_array_equal(td.logits.numpy(), np.asarray(jd.logits))


@contextlib.contextmanager
def _recorded(module, name="decide_tokens_ragged"):
    real, seen = getattr(module, name), []

    def record(*a, **k):
        d = real(*a, **k)
        seen.append(np.asarray(d.mask.detach().cpu() if hasattr(d.mask, "detach") else d.mask))
        return d

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("lens,tail", [((7, 3, 11), 2), ((5, 1, 9, 4), 0), ((8, 8), 3)])
def test_model_forward_ragged_matches_jax(lens, tail):
    jc, jp, tc, tp = model_pair(True)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    toks = _tokens(jc.vocab, int(offs[-1]) + tail, 4)
    # unrolled: a Python loop over the layer groups, so every JAX decision
    # is a concrete array the recorder can read (the same function as the scan)
    with _recorded(JROUT) as jm:
        jl, ja = JAPI.model_forward_ragged(jp, dataclasses.replace(jc, unroll_layers=True),
                                           jnp.asarray(toks), jnp.asarray(offs), max(lens))
    with _recorded(TROUT) as tm:
        tl, ta = TAPI.model_forward_ragged(tp, tc, torch.from_numpy(toks).long(),
                                           torch.from_numpy(offs), max(lens))
    assert tl.shape == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert len(tm) == len(jm) == len(tp["groups"])
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    assert sorted(ta) == sorted(ja)
    for key in ja:
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]), atol=TOL, rtol=TOL)


def test_forward_ragged_equal_segments_match_padded_forward():
    """Equal-length segments: the flat stream is the padded batch, row-major,
    the MoD windows are the padded rows, so the port's two forwards compute
    one function (dense ragged attention vs the flash kernel's plain
    version: f32 sums in other orders); a garbage padded tail behind the
    last segment changes no valid row."""
    _, _, tc, tp = model_pair(True)
    B, S = 3, 16
    toks = torch.from_numpy(_tokens(tc.vocab, B * S, 7)).long()
    padded, _ = TAPI.model_forward(tp, tc, {"tokens": toks.view(B, S)})
    offs = torch.arange(B + 1, dtype=torch.int32) * S
    flat, _ = TAPI.model_forward_ragged(tp, tc, toks, offs, S)
    np.testing.assert_allclose(flat.numpy(), padded.reshape(B * S, -1).numpy(), atol=TOL, rtol=TOL)
    tail = torch.cat([toks, torch.full((5,), tc.vocab - 1)])
    flat_tail, _ = TAPI.model_forward_ragged(tp, tc, tail, offs, S)
    torch.testing.assert_close(flat_tail[: B * S], flat, atol=0, rtol=0)


def test_forward_ragged_unequal_segments_match_each_sequence_alone():
    _, _, tc, tp = model_pair(False)
    lens = (5, 1, 9)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    toks = torch.from_numpy(_tokens(tc.vocab, int(offs[-1]), 2)).long()
    flat, _ = TAPI.model_forward_ragged(tp, tc, toks, torch.from_numpy(offs), max(lens))
    for s in range(len(lens)):
        lo, hi = int(offs[s]), int(offs[s + 1])
        solo, _ = TAPI.model_forward(tp, tc, {"tokens": toks[None, lo:hi]})
        np.testing.assert_allclose(flat[lo:hi].numpy(), solo[0].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_forward_ragged_backends_equal(backend):
    """Every backend name dispatches through the same ragged wrappers."""
    _, _, tc, tp = model_pair(True)
    lens = (7, 3, 11)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    toks = torch.from_numpy(_tokens(tc.vocab, int(offs[-1]) + 2, 4)).long()
    xla, _ = TAPI.model_forward_ragged(tp, tc, toks, offs, max(lens))
    cfg_b = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, backend=backend))
    other, _ = TAPI.model_forward_ragged(tp, cfg_b, toks, offs, max(lens))
    torch.testing.assert_close(other, xla, atol=0, rtol=0)
    with pytest.raises(ValueError, match="backend"):
        TAPI.model_forward_ragged(
            tp, dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, backend="mosaic")),
            toks, offs, max(lens))


def test_forward_ragged_other_families_raise():
    _, _, tc, tp = model_pair(True)
    with pytest.raises(NotImplementedError, match="ssm"):
        TAPI.model_forward_ragged(tp, dataclasses.replace(tc, family="ssm"),
                                  torch.zeros(4, dtype=torch.long),
                                  torch.tensor([0, 4], dtype=torch.int32), 4)
