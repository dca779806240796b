"""The port's ragged paged flash attention against the JAX package, on the
CPU.

On CPU tensors ``repro_torch.kernels.ragged.ragged_paged_flash_attention``
(re-exported as ``ops.ragged_attention_op``) runs its plain version: one
dense masked softmax per segment over the slot's pages, gathered through
the table. It is held against the Pallas kernel in interpret mode
(``repro.kernels.ops.ragged_attention_op``) and the segment-loop oracle
(``ref.ragged_attention_ref``):

- wide pages, f32 and bf16, window 0 and 5, GQA (4 query heads on 2 kv
  heads), an empty segment, query rows with position -1 inside segments,
  a segment of exactly ``seg_cap`` rows, a flat tail behind the last
  segment, and slots whose pages are shared or out of order in the table;
  f32 within 1e-6 (JAX's own tolerance for its kernel against the oracle,
  ``tests/test_ragged.py``: both sum in another order), bf16 within 2e-2
  (``p`` rounds to bf16 against the running maximum in the Pallas kernel,
  against the row's maximum here);
- int8 and e4m3 pages with pow2 scales against
  ``ref.ragged_attention_quant_ref`` and the Pallas quantized kernel,
  within 1e-5 (JAX's tolerance for its quantized kernel);
- rows behind ``row_offsets[-1]`` are exactly 0, and a query row with no
  valid key is exactly 0.

Torch runs on one thread in this module (ROADMAP Queue 3: a torch worker
thread beside XLA sometimes computes ``exp`` off by ~1e-4 relative).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
NARROW = {"int8": (jnp.int8, torch.int8, 127.0), "fp8": (jnp.float8_e4m3fn,
                                                         torch.float8_e4m3fn, 448.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def attn_case(seed=0, lens=(3, 1, 0, 5, 8), B=5, P=3, p=4, nq=4, nkv=2, hd=8, cap=8,
              tail=3, invalid=(1, 9)):
    """Inputs as numpy arrays, after ``tests/test_ragged.py::_attn_case``:
    each segment continues its own slot's cache (the cache holds its first
    ``ctx_len`` positions, the segment queries the last ``L``); the table
    maps each slot's pages in a shuffled order and slots 0 and 1 share
    their first page (a prefix page); the flat rows ``invalid`` get
    position -1."""
    rng = np.random.default_rng(seed)
    n_seg = len(lens)
    N = 2 + B * P
    k_pages = rng.standard_normal((N, p, nkv, hd)).astype(np.float32)
    v_pages = rng.standard_normal((N, p, nkv, hd)).astype(np.float32)
    table = (2 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    table[1, 0] = table[0, 0]
    pos_pages = np.full((N, p), -1, np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T = int(offs[-1]) + tail
    q = rng.standard_normal((T, nq, hd)).astype(np.float32)
    q_pos = np.full((T,), -1, np.int32)
    seg_slot = np.arange(n_seg, dtype=np.int32)
    ctx_lens = [P * p] + [int(rng.integers(max(L, 1), P * p + 1)) for L in lens[1:]]
    for s, L in enumerate(lens):
        if s == 1:  # shares slot 0's first page: its prefix is slot 0's
            for t in range(p, ctx_lens[s]):
                pos_pages[table[s, t // p], t % p] = t
        else:
            for t in range(ctx_lens[s]):
                pos_pages[table[s, t // p], t % p] = t
        q_pos[offs[s]: offs[s + 1]] = np.arange(ctx_lens[s] - L, ctx_lens[s])
    q_pos[list(invalid)] = -1
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, pos_pages=pos_pages, table=table,
                row_offsets=offs, seg_slot=seg_slot, q_pos=q_pos), cap


ORDER = ("q", "k_pages", "v_pages", "pos_pages", "table", "row_offsets", "seg_slot", "q_pos")


def _run(case, jdt, tdt, **kw):
    jargs = [jnp.asarray(case[n], jdt if n in ("q", "k_pages", "v_pages") else None)
             for n in ORDER]
    targs = [torch.as_tensor(case[n]).to(tdt) if n in ("q", "k_pages", "v_pages")
             else torch.as_tensor(case[n]) for n in ORDER]
    return jargs, targs


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ragged_attention_plain_matches_pallas_and_oracle(dt, window):
    case, cap = attn_case()
    jargs, targs = _run(case, JDT[dt], TDT[dt])
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, window=window)
    assert got.dtype == TDT[dt] and got.shape == case["q"].shape
    pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, window=window, interpret=True)
    oracle = JREF.ragged_attention_ref(*jargs, window=window)
    tol = 1e-6 if dt == "f32" else 2e-2
    g = got.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=tol, atol=tol)
    end = int(case["row_offsets"][-1])
    assert (g[end:] == 0).all() and end < g.shape[0]
    assert (g[list((1, 9))] == 0).all()  # rows with position -1: no valid key


def test_ragged_attention_without_causality_and_with_a_scale():
    case, cap = attn_case(seed=3)
    jargs, targs = _run(case, jnp.float32, torch.float32)
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, causal=False, scale=0.3)
    want = JOPS.ragged_attention_op(*jargs, seg_cap=cap, causal=False, scale=0.3, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_ragged_attention_narrow_pages_match_the_quantized_oracle(kind):
    jdt, tdt, qmax = NARROW[kind]
    case, cap = attn_case(seed=6)
    rng = np.random.default_rng(6)
    N, p, nkv, hd = case["k_pages"].shape
    narrow, scales = {}, {}
    for name in ("k_pages", "v_pages"):
        vals = rng.integers(-127, 128, size=(N, p, nkv, hd)).astype(np.float32)
        if kind == "fp8":
            vals = vals * 3.5  # e4m3 rounds these; both sides read the same bytes
        narrow[name] = jnp.asarray(vals, jdt)
        scales[name] = np.asarray(JREF.pow2_scale_ref(rng.uniform(0.05, 2.0, (N, p, nkv)), qmax),
                                  np.float32)
    jargs = [narrow.get(n, jnp.asarray(case[n])) for n in ORDER]
    targs = [torch.as_tensor(np.array(narrow[n].astype(jnp.float32))).to(tdt)
             if n in narrow else torch.as_tensor(case[n]) for n in ORDER]
    jks, jvs = jnp.asarray(scales["k_pages"]), jnp.asarray(scales["v_pages"])
    tks, tvs = torch.as_tensor(scales["k_pages"]), torch.as_tensor(scales["v_pages"])
    got = TOPS.ragged_attention_op(*targs, seg_cap=cap, k_scales=tks, v_scales=tvs).numpy()
    oracle = JREF.ragged_attention_quant_ref(jargs[0], jargs[1], jks, jargs[2], jvs, *jargs[3:])
    pallas = JOPS.ragged_attention_op(*jargs, seg_cap=cap, interpret=True, k_scales=jks,
                                      v_scales=jvs)
    for want in (oracle, pallas):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[int(case["row_offsets"][-1]):] == 0).all()


def test_ragged_attention_no_segments_and_all_empty():
    case, cap = attn_case(lens=(0, 0), tail=4, invalid=())
    _, targs = _run(case, jnp.float32, torch.float32)
    got = KRG.ragged_paged_flash_attention(*targs, seg_cap=cap)
    assert (got == 0).all() and got.shape == case["q"].shape


def test_ragged_attention_refuses_what_it_does_not_take():
    case, cap = attn_case()
    _, targs = _run(case, jnp.float32, torch.float32)
    with pytest.raises(ValueError, match="gradient"):
        KRG.ragged_paged_flash_attention(targs[0].clone().requires_grad_(True), *targs[1:],
                                         seg_cap=cap)
    with pytest.raises(TypeError, match="int32"):
        KRG.ragged_paged_flash_attention(*targs[:4], targs[4].long(), *targs[5:], seg_cap=cap)
    with pytest.raises(TypeError, match="wide pages"):
        KRG.ragged_paged_flash_attention(targs[0].bfloat16(), *targs[1:], seg_cap=cap)
    with pytest.raises(ValueError, match="k_scales"):
        KRG.ragged_paged_flash_attention(*targs, seg_cap=cap,
                                         k_scales=torch.ones(case["pos_pages"].shape))
    with pytest.raises(ValueError, match="seg_cap"):
        KRG.ragged_paged_flash_attention(*targs, seg_cap=0)
