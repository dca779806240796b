"""Every op of the port's entry point ``repro_torch.kernels.ops`` against the
JAX package's op of the same name (``repro.kernels.ops``, Pallas in
interpret mode), on the CPU: the same arguments, in JAX's order, made by
numpy from one seed, and the same result within the op's existing
tolerance:

- bit for bit where both sides copy or add one term per element (the row
  gathers and gated scatter-adds, the paged gathers and scatters, plain
  and quantized: narrow bytes and scales);
- f32 within 1e-5 where both sides sum products in their own order
  (flash and routed attention, routed MLP; the SSD kernel within 1e-5 of
  its largest value plus the cumsum's rounding, as
  ``tests/test_torch_ssm.py``), 2e-5 for SwiGLU and 1e-6 for ragged
  attention (JAX's tolerances for those kernels against their oracles).

The paged ops get a leaf with a lead axis (``page_axis=1``), so the fold
of lead and tail dims into the canonical row is exercised, and their
inputs must come back unchanged (the JAX ops are functional). Torch runs on
one thread in this module (ROADMAP Queue 3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from tests.test_torch_ragged_attention import attn_case  # noqa: E402

JAX_OPS = [
    "flash_attention_op", "ssd_intra_chunk_op", "swiglu_op", "gather_rows_op",
    "scatter_add_rows_op", "routed_attention_op", "paged_gather_op", "paged_scatter_rows_op",
    "ragged_attention_op", "ragged_gather_rows_op", "ragged_scatter_add_rows_op",
    "ragged_paged_scatter_rows_op", "routed_mlp_scatter_op", "on_cpu",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _rows(rng, B, S, k):
    return np.sort(np.stack([rng.choice(S, k, replace=False) for _ in range(B)]), 1).astype(
        np.int32)


def _paged_leaf(rng, dtype=np.float32):
    """A JAX-layout leaf (L, N, p, nkv, hd) with page_axis 1, its table,
    and a decode row per slot (L, B, nkv, hd) at positions ``pos``."""
    L, N, p, nkv, hd, B, P = 2, 9, 4, 2, 3, 3, 2
    pages = _f32(rng, L, N, p, nkv, hd).astype(dtype)
    table = (2 + rng.permutation(N - 2)[: B * P]).reshape(B, P).astype(np.int32)
    rows = _f32(rng, L, B, nkv, hd).astype(dtype)
    pos = rng.integers(0, P * p, B).astype(np.int32)
    return pages, table, rows, pos


def _quant_leaf(rng, kind):
    """A narrow leaf of int8 / e4m3 values and its (N, p, G) pow2 scales."""
    pages, table, rows, pos = _paged_leaf(rng)
    qmax = 127.0 if kind == "int8" else 448.0
    narrow = np.clip(np.round(pages * 40), -qmax, qmax)
    G = 1 if kind == "int8" else pages.shape[0] * pages.shape[3]
    scales = (2.0 ** rng.integers(-6, 2, (pages.shape[1], pages.shape[2], G))).astype(np.float32)
    return narrow, scales, table, rows, pos


_JNARROW = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
_TNARROW = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_GRAN = {"int8": "page", "fp8": "head"}


def _narrow_pair(narrow, kind):
    j = jnp.asarray(narrow, _JNARROW[kind])
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(_TNARROW[kind])


def _bits(a):
    """Bytes of a JAX array or torch tensor as numpy (last axis widened by
    the item size)."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _case(name, rng):
    """(JAX args, JAX kwargs, port args, port kwargs, how to compare)."""
    T = torch.as_tensor
    if name == "flash_attention_op":
        B, S, nq, nkv, hd = 2, 32, 4, 2, 16
        q, k, v = _f32(rng, B, S, nq, hd), _f32(rng, B, S, nkv, hd), _f32(rng, B, S, nkv, hd)
        qp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        kp = qp.copy()
        qp[:, -3:] = -1
        kp[:, -5:] = -1
        args = (q, k, v, qp, kp)
        kw = dict(causal=True, window=7)
        return args, kw, args, kw, dict(atol=1e-5)
    if name == "ssd_intra_chunk_op":
        B, H, NC, Q, hd, ds = 2, 3, 2, 16, 8, 8
        x = _f32(rng, B, H, NC, Q, hd)
        dt = np.log1p(np.exp(_f32(rng, B, H, NC, Q))).astype(np.float32)
        loglam = (dt * -np.exp(_f32(rng, H, s=0.5))[None, :, None, None]).astype(np.float32)
        args = (x, loglam, dt, _f32(rng, B, NC, Q, ds), _f32(rng, B, NC, Q, ds))
        tol = 1e-5 + 2 * np.abs(np.cumsum(loglam, axis=-1)).max() * 2.0 ** -24
        return args, {}, args, {}, dict(rel=tol)
    if name == "swiglu_op":
        M, D, F = 64, 32, 128
        args = (_f32(rng, M, D, s=0.5), _f32(rng, D, F, s=0.2), _f32(rng, D, F, s=0.2),
                _f32(rng, F, D, s=0.2))
        return args, {}, args, {}, dict(atol=2e-5)
    if name in ("gather_rows_op", "scatter_add_rows_op"):
        B, S, D, k = 2, 40, 16, 9
        x, idx = _f32(rng, B, S, D), _rows(rng, B, S, k)
        if name == "gather_rows_op":
            return (x, idx), {}, (x, idx), {}, "bits"
        args = (x, idx, _f32(rng, B, k, D), _f32(rng, B, k))
        return args, {}, args, {}, "bits"
    if name in ("routed_attention_op", "routed_mlp_scatter_op"):
        B, S, D, nq, nkv, hd, k, F = 2, 40, 32, 4, 2, 8, 11, 48
        x, idx = _f32(rng, B, S, D), _rows(rng, B, S, k)
        ln = (1 + 0.1 * _f32(rng, D)).astype(np.float32)
        if name == "routed_attention_op":
            p = {"ln": ln, "wq": _f32(rng, D, nq * hd, s=D ** -0.5),
                 "wk": _f32(rng, D, nkv * hd, s=D ** -0.5),
                 "wv": _f32(rng, D, nkv * hd, s=D ** -0.5),
                 "wo": _f32(rng, nq * hd, D, s=(nq * hd) ** -0.5)}
            kw = dict(n_heads=nq, n_kv_heads=nkv, head_dim=hd, scale=hd ** -0.5, window=5)
            return (x, idx, idx.copy(), p), kw, (x, idx, idx.copy(), p), kw, dict(atol=1e-5)
        p = {"ln": ln, "w_up": _f32(rng, D, F, s=D ** -0.5), "w_gate": _f32(rng, D, F, s=D ** -0.5),
             "w_down": _f32(rng, F, D, s=F ** -0.5)}
        args = (x, _f32(rng, B, k, D), _f32(rng, B, k, D), idx, _f32(rng, B, k), p)
        return args, dict(act="silu"), args, dict(act="silu"), dict(atol=1e-5)
    if name == "paged_gather_op":
        pages, table, _, _ = _paged_leaf(rng)
        kw = dict(page_axis=1, backend="pallas")
        return (pages, table), kw, (pages, table), kw, "bits"
    if name.startswith("paged_gather_op-"):
        kind = name.split("-")[1]
        narrow, scales, table, _, _ = _quant_leaf(rng, kind)
        jn, tn = _narrow_pair(narrow, kind)
        jkw = dict(page_axis=1, scales=jnp.asarray(scales), out_dtype=jnp.bfloat16)
        tkw = dict(page_axis=1, scales=T(scales), out_dtype=torch.bfloat16)
        return (jn, table), jkw, (tn, T(table)), tkw, "bits"
    if name == "paged_scatter_rows_op":
        pages, table, rows, pos = _paged_leaf(rng)
        args = (pages, table, rows, pos)
        return args, dict(page_axis=1), args, dict(page_axis=1), "bits"
    if name.startswith("paged_scatter_rows_op-") or name.startswith(
            "ragged_paged_scatter_rows_op-"):
        kind = name.split("-")[1]
        narrow, scales, table, rows, pos = _quant_leaf(rng, kind)
        jn, tn = _narrow_pair(narrow, kind)
        jq = JQ.QuantConfig(kv=kind, granularity=_GRAN[kind])
        tq = TQ.QuantConfig(kv=kind, granularity=_GRAN[kind])
        if name.startswith("paged_"):
            jargs, targs = (jn, table, rows, pos), (tn, T(table), T(rows), T(pos))
        else:
            slot = np.array([0, 2, 1, 2], np.int32)
            wpos = np.array([1, 5, 0, 6], np.int32)
            valid = np.array([True, True, True, False])
            wrows = _f32(rng, rows.shape[0], 4, *rows.shape[2:])
            jargs = (jn, table, wrows, slot, wpos, valid)
            targs = (tn, T(table), T(wrows), T(slot), T(wpos), T(valid))
        jkw = dict(page_axis=1, scales=jnp.asarray(scales), quant=jq)
        tkw = dict(page_axis=1, scales=T(scales), quant=tq)
        return jargs, jkw, targs, tkw, "bits" if name.startswith("paged_") else "bits-no-dump"
    if name == "ragged_paged_scatter_rows_op":
        pages, table, _, _ = _paged_leaf(rng)
        slot = np.array([0, 2, 1, 2, 0], np.int32)
        pos = np.array([1, 5, 0, 6, 2], np.int32)
        valid = np.array([True, True, True, False, True])
        rows = _f32(rng, pages.shape[0], 5, *pages.shape[3:])
        args = (pages, table, rows, slot, pos, valid)
        return args, dict(page_axis=1), args, dict(page_axis=1), "bits-no-dump"
    if name == "ragged_attention_op":
        case, cap = attn_case(seed=4)
        args = tuple(case[n] for n in ("q", "k_pages", "v_pages", "pos_pages", "table",
                                       "row_offsets", "seg_slot", "q_pos"))
        kw = dict(seg_cap=cap, window=6)
        return args, kw, args, kw, dict(atol=1e-6, rtol=1e-6)
    if name in ("ragged_gather_rows_op", "ragged_scatter_add_rows_op"):
        lens, cap, D = (3, 1, 0, 5), 4, 16
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        x = _f32(rng, int(offs[-1]) + 2, D)
        idx = np.full((len(lens), cap), -1, np.int32)
        for s, L in enumerate(lens):
            n = min(cap, L)
            idx[s, :n] = offs[s] + np.sort(rng.choice(L, size=n, replace=False))
        if name == "ragged_gather_rows_op":
            return (x, idx), {}, (x, idx), {}, "bits"
        gate = np.where(idx >= 0, _f32(rng, len(lens), cap), 0).astype(np.float32)
        args = (x, idx, _f32(rng, len(lens), cap, D), gate)
        return args, {}, args, {}, "bits"
    raise KeyError(name)


def _to_jax(a):
    if isinstance(a, dict):
        return {k: _to_jax(v) for k, v in a.items()}
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_torch(a):
    if isinstance(a, dict):
        return {k: _to_torch(v) for k, v in a.items()}
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _outputs(x):
    return list(x) if isinstance(x, tuple) else [x]


CASES = [n for n in JAX_OPS if n != "on_cpu"] + [
    "paged_gather_op-int8", "paged_gather_op-fp8", "paged_scatter_rows_op-int8",
    "paged_scatter_rows_op-fp8", "ragged_paged_scatter_rows_op-int8",
    "ragged_paged_scatter_rows_op-fp8"]


def test_the_port_has_every_jax_op():
    public = {n for n in dir(JOPS) if n.endswith("_op") or n == "on_cpu"}
    assert public == set(JAX_OPS) == set(TOPS.__all__)
    assert all(callable(getattr(TOPS, n)) for n in JAX_OPS)
    assert TOPS.on_cpu() == JOPS.on_cpu()


@pytest.mark.parametrize("name", CASES)
def test_op_matches_the_jax_op(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jargs, jkw, targs, tkw, cmp = _case(name, rng)
    op = name.split("-")[0]
    jargs, jkw = [_to_jax(a) for a in jargs], {k: _to_jax(v) for k, v in jkw.items()}
    targs, tkw = [_to_torch(a) for a in targs], {k: _to_torch(v) for k, v in tkw.items()}
    before = [t.clone() for t in targs if isinstance(t, torch.Tensor)]
    want = _outputs(getattr(JOPS, op)(*jargs, interpret=True, **jkw))
    got = _outputs(getattr(TOPS, op)(*targs, **tkw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), (g.shape, w.shape)
        if cmp == "bits":
            np.testing.assert_array_equal(_bits(g), _bits(w))
        elif cmp == "bits-no-dump":  # the dump page's rows are garbage by contract
            axis = 0 if g.dim() == 3 else 1  # the (N, p, G) scales or the (L, N, ...) leaf
            keep = [n for n in range(g.shape[axis]) if n != 1]
            gb = _bits(g).reshape(tuple(g.shape) + (-1,)).take(keep, axis)
            wb = _bits(w).reshape(tuple(w.shape) + (-1,)).take(keep, axis)
            np.testing.assert_array_equal(gb, wb)
        elif "rel" in cmp:
            w = np.asarray(w, np.float64)
            err = np.abs(g.detach().double().numpy() - w).max() / np.abs(w).max()
            assert err <= cmp["rel"], err
        else:
            np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                       **cmp)
    after = [t for t in targs if isinstance(t, torch.Tensor)]
    assert all((_bits(a) == _bits(b)).all() for a, b in zip(after, before))
