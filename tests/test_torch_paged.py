"""The port's paged KV pool against the JAX package, on the CPU.

- Kernels: the plain versions of the paged gather, the decode-row scatter
  and the ragged write-back (what the wrappers run for CPU tensors) equal
  the ``kernels/ref.py`` oracles and the Pallas kernels in interpret mode,
  bit for bit, in f32, bf16 and int32 (rows that collide on the scratch page
  are garbage by contract and left out of the comparison).
- Pool: page accounting, prefix eviction and bad geometry, as
  ``tests/test_paged.py`` holds the JAX pool.
- Engine: paged == contiguous within the port; the port's paged streams,
  with and without the prefix cache, equal the JAX engine's for the same
  weights (``params.from_jax_params``); prefix-warm == cold, including one
  entry restored twice; preemption on page exhaustion and a resume in the
  middle of a chunked prefill stay bit-identical; the admission gate.

The JAX engine runs ``paged_backend="xla"`` (its ``pallas`` variant is held
equal to it by ``tests/test_paged.py``); the port runs both names.

The gather kernel's pure planner (``gather_plan``): the widest vector of
16, 4 and 1 bytes that divides the page and the page tensor's base, whole
blocks over the output, 64-bit indices past 2^32 vectors, a raise for what
no grid takes, and the plan is what the C entry point receives and the
launch counter records. The decode-row scatter's (``scatter_rows_plan``)
and the ragged write-back's (``scatter_plan``) likewise.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import MoDConfig as JMoDConfig  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ragged as JRG  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.kernels import paged as KP  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.cache import NULL_PAGE, SCRATCH_PAGE, PagedCachePool  # noqa: E402
from repro_torch.serve.scheduler import PREFILL  # noqa: E402
from tests.helpers import tiny_cfg  # noqa: E402

DTYPES = ["float32", "bfloat16", "int32"]

# ---------------------------------------------------------------------------
# shared helpers (tests/test_torch_serve_ragged.py imports them)
# ---------------------------------------------------------------------------


def port_cfg(jc):
    """The port's ModelConfig with the fields of a JAX ModelConfig."""
    sub = {"attn": TC.AttentionConfig, "mod": TC.MoDConfig, "moe": TC.MoEConfig,
           "ssm": TC.SSMConfig}
    kw = {}
    for f in dataclasses.fields(TC.ModelConfig):
        v = getattr(jc, f.name)
        if f.name in sub:
            v = sub[f.name](**{g.name: getattr(v, g.name) for g in dataclasses.fields(sub[f.name])})
        kw[f.name] = v
    return TC.ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def model_pair(mod: bool = True, seed: int = 0):
    """(JAX cfg, JAX params, port cfg, port params): one tiny model, the same
    weights in both packages."""
    jc = tiny_cfg() if mod else tiny_cfg(mod=JMoDConfig(enabled=False))
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)
    return jc, jp, port_cfg(jc), from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def run_both(prompts, max_new, arrival_every=0, jax_side=True, backend="xla", **engine):
    """Greedy streams {uid: full sequence} of the port's engine and, with
    ``jax_side``, of the JAX engine, on the same requests and settings
    (``mod=False`` in ``engine`` picks the dense twin). Returns
    (port streams, port engine, JAX streams, JAX engine)."""
    jc, jp, tc, tp = model_pair(engine.pop("mod", True))
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    teng = ServingEngine(tp, tc, EngineConfig(paged_backend=backend, **engine), device="cpu")
    touts = teng.run_stream([Request(tokens=p, max_new_tokens=n)
                             for p, n in zip(prompts, news)], arrival_every)
    tstreams = {o.uid: o.full_sequence.tolist() for o in touts}
    if not jax_side:
        return tstreams, teng, None, None
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(**engine))
    jouts = jeng.run_stream([JRequest(tokens=np.asarray(p, np.int32), max_new_tokens=n)
                             for p, n in zip(prompts, news)], arrival_every)
    return tstreams, teng, {o.uid: o.full_sequence.tolist() for o in jouts}, jeng


def shared_prefix_prompts(n=5, prefix=8, seed=7, tails=(3, 5, 2, 6, 4, 3)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 96, size=prefix)
    return [np.concatenate([shared, rng.integers(1, 96, size=tails[i])]) for i in range(n)]


# ---------------------------------------------------------------------------
# Kernels: plain versions == ref oracles == Pallas (interpret)
# ---------------------------------------------------------------------------


def _arrays(dtype, *shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape) * 8
    if dtype == "int32":
        x = np.round(x)
    x = x.astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_gather_plain_matches_ref_and_pallas(dtype):
    N, p, F, B, P = 9, 4, 6, 3, 2
    jpages, tpages = _arrays(dtype, N, p, F)
    table = np.random.default_rng(1).integers(0, N, size=(B, P)).astype(np.int32)
    want = _jnp(JREF.paged_gather_ref(jpages, jnp.asarray(table)))
    pallas = _jnp(JOPS.paged_gather_op(jpages, jnp.asarray(table), backend="pallas",
                                       interpret=True))
    got = KP.paged_gather(tpages, torch.from_numpy(table))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(want, pallas)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_scatter_rows_plain_matches_ref_and_pallas(dtype):
    N, p, F, B, P = 9, 4, 6, 3, 2
    jpages, tpages = _arrays(dtype, N, p, F)
    jrows, trows = _arrays(dtype, B, F, seed=2)
    table = np.asarray([[2, 3], [4, 5], [6, 7]], np.int32)
    pos = np.asarray([1, 7, 2], np.int32)
    want = _jnp(JREF.paged_scatter_rows_ref(jpages, jnp.asarray(table), jrows, jnp.asarray(pos)))
    pallas = _jnp(JOPS.paged_scatter_rows_op(jpages, jnp.asarray(table), jrows, jnp.asarray(pos),
                                             backend="pallas", interpret=True))
    before = tpages.clone()
    out = KP.paged_scatter_rows(tpages, torch.from_numpy(table), trows, torch.from_numpy(pos))
    assert out is tpages  # in place
    np.testing.assert_array_equal(_np(tpages), want)
    np.testing.assert_array_equal(want, pallas)
    # every page outside the B targets is untouched
    hit = {(2, 1), (5, 3), (6, 2)}
    for n in range(N):
        for r in range(p):
            if (n, r) not in hit:
                assert torch.equal(tpages[n, r], before[n, r])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_paged_scatter_rows_plain_matches_ref_and_pallas(dtype):
    N, p, F, B, P, W = 10, 4, 5, 3, 3, 9
    jpages, tpages = _arrays(dtype, N, p, F)
    jrows, trows = _arrays(dtype, W, F, seed=3)
    table = np.asarray([[2, 3, 4], [5, 6, NULL_PAGE], [7, 8, 9]], np.int32)
    slot = np.asarray([0, 1, 2, 0, 0, 2, 2, 1, 1], np.int32)
    pos = np.asarray([0, 5, 11, 4, 9, 1, 2, 3, 6], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0, 1, 1, 0, 1], bool)
    jpid, joff = JRG.ragged_page_targets(jnp.asarray(table), jnp.asarray(slot), jnp.asarray(pos),
                                         jnp.asarray(valid), p, SCRATCH_PAGE)
    pid, off = KRG.ragged_page_targets(torch.from_numpy(table), torch.from_numpy(slot),
                                       torch.from_numpy(pos), torch.from_numpy(valid), p,
                                       SCRATCH_PAGE)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    want = _jnp(JREF.ragged_paged_scatter_rows_ref(jpages, jpid, joff, jrows))
    pallas = _jnp(JOPS.ragged_paged_scatter_rows_op(
        jpages, jnp.asarray(table), jrows, jnp.asarray(slot), jnp.asarray(pos),
        jnp.asarray(valid), backend="pallas", dump_page=SCRATCH_PAGE, interpret=True))
    KRG.ragged_paged_scatter_rows(tpages, pid, off, trows)
    got = _np(tpages)
    # the two invalid rows collide on the scratch page: garbage by contract
    keep = np.ones(N, bool)
    keep[SCRATCH_PAGE] = False
    np.testing.assert_array_equal(got[keep], want[keep])
    np.testing.assert_array_equal(want[keep], pallas[keep])


def test_leaf_wrappers_match_jax_ops():
    """Cache leaves carry (nkv, hd) tails; the wrappers fold them into F."""
    rng = np.random.default_rng(4)
    N, p, nkv, hd, B, P = 7, 4, 2, 3, 3, 2
    pages = rng.normal(size=(N, p, nkv, hd)).astype(np.float32)
    table = rng.integers(0, N, size=(B, P)).astype(np.int32)
    rows = rng.normal(size=(B, nkv, hd)).astype(np.float32)
    pos = np.asarray([0, 5, 3], np.int32)
    g = KP.paged_gather_op(torch.from_numpy(pages), torch.from_numpy(table))
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(JOPS.paged_gather_op(jnp.asarray(pages), jnp.asarray(table))))
    tp = torch.from_numpy(pages.copy())
    table = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    KP.paged_scatter_rows_op(tp, torch.from_numpy(table), torch.from_numpy(rows),
                             torch.from_numpy(pos))
    want = JOPS.paged_scatter_rows_op(jnp.asarray(pages), jnp.asarray(table), jnp.asarray(rows),
                                      jnp.asarray(pos))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))


def test_wrappers_refuse_grads_and_bad_input():
    pages = torch.zeros(4, 2, 3, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        KP.paged_gather(pages, torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        KP.paged_gather(pages.detach(), torch.zeros(1, 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="paged backend"):
        EngineConfig(batch_size=2, ctx=16, page_size=4, paged_backend="mosaic")


# ---------------------------------------------------------------------------
# gather_plan: the gather kernel's vector width and grid, before launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_bytes,base,vec", [
    (16 * 1792 * 2, 0, 16),  # mod-paper-1b's bf16 K/V pages
    (16 * 4, 4096, 16),  # its int32 position pages
    (3 * 5 * 4, 0, 4),  # a page of 60 bytes: not a multiple of 16
    (16 * 1792 * 2, 4, 4),  # a page view 4 bytes off 16
    (3 * 5 * 2, 0, 1),  # a page of 30 bytes: not a multiple of 4
    (16 * 1792 * 2, 2, 1),  # a bf16 page view 2 bytes off 16
    (7, 16, 1),
])
def test_gather_plan_takes_the_widest_vector_that_divides_page_and_base(page_bytes, base, vec):
    assert KP.gather_plan(498, 8, 62, page_bytes, base).vec == vec


@pytest.mark.parametrize("B,P,page_bytes,unroll,blocks", [
    (1, 62, 16 * 1792 * 2, 1, 868),  # a chunked prefill's (1, 62) table: 868 blocks, not 62
    (8, 62, 16 * 1792 * 2, 4, 1736),  # a decode step's (8, 62): more vectors than the card's
    (8, 62, 64, 1, 8),  # position pages share blocks
    (1, 62, 64, 1, 1),
    (3, 3, 30, 1, 2),  # 270 vectors of 1 byte
    (0, 5, 64, 1, 0),
])
def test_gather_plan_covers_the_output_with_whole_blocks(B, P, page_bytes, unroll, blocks):
    plan = KP.gather_plan(498, B, P, page_bytes, 0)
    per_block = KP.GATHER_THREADS * plan.unroll
    assert (plan.unroll, plan.blocks) == (unroll, blocks)
    assert (blocks - 1) * per_block < B * P * page_bytes // plan.vec <= blocks * per_block
    assert not plan.wide


def test_gather_plan_widens_indices_past_32_bits():
    # pages of 2^12 vectors of 16 bytes: 2^20 - 1 of them stay under 2^32
    # vectors, 2^20 reach it
    assert not KP.gather_plan(1, 1, 2 ** 20 - 1, 2 ** 16, 0).wide
    assert KP.gather_plan(1, 1, 2 ** 20, 2 ** 16, 0).wide


def test_gather_plan_takes_more_vectors_a_thread_past_a_card_of_threads():
    assert KP.gather_plan(1, 1, 1, 16 * KP.CARD_THREADS, 0).unroll == 1
    assert KP.gather_plan(1, 1, 1, 16 * (KP.CARD_THREADS + 1), 0).unroll == KP.GATHER_UNROLL


@pytest.mark.parametrize("N,B,P,page_bytes", [(0, 1, 1, 64), (4, 1, 1, 0), (4, -1, 1, 64),
                                              (4, 2 ** 20, 2 ** 20, 2 ** 20 + 1)])
def test_gather_plan_raises_for_what_the_kernel_does_not_take(N, B, P, page_bytes):
    with pytest.raises(ValueError):
        KP.gather_plan(N, B, P, page_bytes, 0)


class _FakeEntry:
    """Stands in for the C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("dtype,F,offset,vec", [(torch.bfloat16, 8, 0, 16),
                                                (torch.bfloat16, 8, 1, 1),
                                                (torch.float32, 8, 1, 4),
                                                (torch.int32, 1, 0, 16)])
def test_gather_passes_its_plan_to_the_entry_point(monkeypatch, dtype, F, offset, vec):
    """The plan gather_plan made for the page tensor's own base (an offset
    view keeps it) is what the C entry point gets, and the launch counter
    records it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(KP.build, "bind", lambda *a: entry)
    monkeypatch.setattr(KP.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    N, p, B, P = 6, 4, 2, 3
    pages = torch.zeros(offset + N * p * F, dtype=dtype)[offset:].view(N, p, F)
    table = torch.zeros(B, P, dtype=torch.int32)
    KP.build.reset_counters()
    out = KP._gather_launch(pages, table)
    page_bytes = p * F * pages.element_size()
    plan = KP.gather_plan(N, B, P, page_bytes, pages.data_ptr())
    assert plan.vec == vec and out.shape == (B, P * p, F)
    # (pages, table, out, N, B, P, page_bytes, vec, unroll, wide, blocks, stream)
    assert entry.args[3:11] == (N, B, P, page_bytes, vec, plan.unroll, 0, plan.blocks)
    assert KP.PAGED_GATHER.by_call == {(vec, B, P, page_bytes): 1}
    KP.build.reset_counters()


# ---------------------------------------------------------------------------
# scatter_plan: the ragged write-back's flat grid, before launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_bytes,pages_base,rows_base,vec", [
    (1792 * 2, 0, 0, 16),  # mod-paper-1b's bf16 K/V rows
    (4, 0, 0, 4),  # its int32 position rows: 4 bytes
    (1792 * 2, 0, 4, 4),  # rows 4 bytes off 16
    (1792 * 2, 8, 0, 4),  # pages 8 bytes off 16
    (13 * 2, 0, 0, 1),  # a bf16 row of 26 bytes: not a multiple of 4
    (1792 * 2, 0, 2, 1),  # bf16 rows 2 bytes off 16
    (7, 16, 16, 1),
])
def test_scatter_plan_takes_the_widest_vector_that_divides_row_and_bases(row_bytes, pages_base,
                                                                         rows_base, vec):
    assert KRG.scatter_plan(498, 7432, 16, row_bytes, pages_base, rows_base).vec == vec


@pytest.mark.parametrize("W,row_bytes,unroll,blocks", [
    (7432, 4, 1, 30),  # the ragged run's first step, position leaf: 30 blocks, not 7432
    (7432, 1792 * 2, 4, 1626),  # its K/V leaf: more vectors than the card's threads
    (8, 1792 * 2, 1, 7),  # a decode-only step's K/V leaf
    (8, 4, 1, 1),
    (3, 26, 1, 1),  # 78 vectors of 1 byte
    (0, 4, 1, 0),
])
def test_scatter_plan_covers_the_rows_with_whole_blocks(W, row_bytes, unroll, blocks):
    plan = KRG.scatter_plan(498, W, 16, row_bytes, 0, 0)
    per_block = KP.GATHER_THREADS * plan.unroll
    assert (plan.unroll, plan.blocks) == (unroll, blocks)
    assert (blocks - 1) * per_block < W * row_bytes // plan.vec <= blocks * per_block
    assert not plan.wide


def test_scatter_plan_widens_indices_past_32_bits():
    # rows of 2^12 vectors of 16 bytes: 2^20 - 1 of them stay under 2^32
    # vectors, 2^20 reach it
    assert not KRG.scatter_plan(1, 2 ** 20 - 1, 1, 2 ** 16, 0, 0).wide
    assert KRG.scatter_plan(1, 2 ** 20, 1, 2 ** 16, 0, 0).wide


@pytest.mark.parametrize("N,W,p,row_bytes", [(0, 1, 16, 4), (4, 1, 0, 4), (4, 1, 16, 0),
                                             (4, -1, 16, 4), (4, 2 ** 30, 16, 2 ** 20 + 1)])
def test_scatter_plan_raises_for_what_the_kernel_does_not_take(N, W, p, row_bytes):
    with pytest.raises(ValueError):
        KRG.scatter_plan(N, W, p, row_bytes, 0, 0)


@pytest.mark.parametrize("dtype,F,offset,vec", [(torch.bfloat16, 8, 0, 16),
                                                (torch.bfloat16, 8, 1, 1),
                                                (torch.float32, 8, 1, 4),
                                                (torch.int32, 1, 0, 4)])
def test_ragged_scatter_passes_its_plan_to_the_entry_point(monkeypatch, dtype, F, offset, vec):
    """The plan scatter_plan made for the page tensor's and the rows' own
    bases (an offset view of the rows keeps its base) is what the C entry
    point gets, and the launch counter records it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(KRG.build, "bind", lambda *a: entry)
    monkeypatch.setattr(KRG.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    N, p, W = 6, 4, 5
    pages = torch.zeros(N, p, F, dtype=dtype)
    rows = torch.zeros(offset + W * F, dtype=dtype)[offset:].view(W, F)
    pid = torch.zeros(W, dtype=torch.int32)
    off = torch.arange(W, dtype=torch.int32) % p
    KP.build.reset_counters()
    KRG._scatter_launch(pages, pid, off, rows)
    row_bytes = F * pages.element_size()
    plan = KRG.scatter_plan(N, W, p, row_bytes, pages.data_ptr(), rows.data_ptr())
    assert plan.vec == vec
    # (pages, pid, off, rows, N, W, p, row_bytes, vec, unroll, wide, blocks, stream)
    assert entry.args[4:12] == (N, W, p, row_bytes, vec, plan.unroll, 0, plan.blocks)
    assert KRG.RAGGED_PAGED_SCATTER_ROWS.by_call == {(vec, W, row_bytes): 1}
    KP.build.reset_counters()


# ---------------------------------------------------------------------------
# scatter_rows_plan: the decode-row scatter on the same flat grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_bytes,pages_base,rows_base,vec", [
    (1792 * 2, 0, 0, 16),  # mod-paper-1b's bf16 K/V rows
    (4, 0, 0, 4),  # its int32 position rows
    (1792 * 2, 0, 4, 4),  # rows 4 bytes off 16
    (1792 * 2, 8, 0, 4),  # pages 8 bytes off 16
    (13 * 2, 0, 0, 1),  # a bf16 row of 26 bytes
    (1792 * 2, 2, 0, 1),  # bf16 pages 2 bytes off 16
])
def test_scatter_rows_plan_takes_the_widest_vector_that_divides_row_and_bases(
        row_bytes, pages_base, rows_base, vec):
    assert KP.scatter_rows_plan(498, 8, 62, 16, row_bytes, pages_base, rows_base).vec == vec


@pytest.mark.parametrize("B,row_bytes,unroll,blocks", [
    (8, 4, 1, 1),  # a decode step's position leaf: 8 vectors, one block
    (8, 1792 * 2, 1, 7),  # its K/V leaf: 1792 vectors of 16 bytes
    (1, 1792 * 2, 1, 1),
    (3, 26, 1, 1),  # 78 vectors of 1 byte
    (0, 4, 1, 0),
])
def test_scatter_rows_plan_covers_the_rows_with_whole_blocks(B, row_bytes, unroll, blocks):
    plan = KP.scatter_rows_plan(498, B, 62, 16, row_bytes, 0, 0)
    per_block = KP.GATHER_THREADS * plan.unroll
    assert (plan.unroll, plan.blocks) == (unroll, blocks)
    assert (blocks - 1) * per_block < B * row_bytes // plan.vec <= blocks * per_block
    assert not plan.wide


@pytest.mark.parametrize("N,B,P,p,row_bytes", [(0, 1, 4, 16, 4), (4, 1, 0, 16, 4),
                                               (4, 1, 4, 0, 4), (4, 1, 4, 16, 0),
                                               (4, -1, 4, 16, 4)])
def test_scatter_rows_plan_raises_for_what_the_kernel_does_not_take(N, B, P, p, row_bytes):
    with pytest.raises(ValueError):
        KP.scatter_rows_plan(N, B, P, p, row_bytes, 0, 0)


@pytest.mark.parametrize("dtype,F,offset,vec", [(torch.bfloat16, 8, 0, 16),
                                                (torch.bfloat16, 8, 1, 1),
                                                (torch.float32, 8, 1, 4),
                                                (torch.int32, 1, 0, 4)])
def test_paged_scatter_passes_its_plan_to_the_entry_point(monkeypatch, dtype, F, offset, vec):
    """The plan scatter_rows_plan made for the page tensor's and the rows'
    own bases (an offset view of the rows keeps its base) is what the C
    entry point gets, and the launch counter records it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(KP.build, "bind", lambda *a: entry)
    monkeypatch.setattr(KP.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    N, p, B, P = 6, 4, 5, 3
    pages = torch.zeros(N, p, F, dtype=dtype)
    rows = torch.zeros(offset + B * F, dtype=dtype)[offset:].view(B, F)
    table = torch.zeros(B, P, dtype=torch.int32)
    pos = torch.arange(B, dtype=torch.int32)
    KP.build.reset_counters()
    KP._scatter_rows_launch(pages, table, rows, pos)
    row_bytes = F * pages.element_size()
    plan = KP.scatter_rows_plan(N, B, P, p, row_bytes, pages.data_ptr(), rows.data_ptr())
    assert plan.vec == vec
    # (pages, table, rows, pos, N, B, P, p, row_bytes, vec, unroll, wide, blocks, stream)
    assert entry.args[4:13] == (N, B, P, p, row_bytes, vec, plan.unroll, 0, plan.blocks)
    assert KP.PAGED_SCATTER_ROWS.by_call == {(vec, B, row_bytes): 1}
    KP.build.reset_counters()


# ---------------------------------------------------------------------------
# Pool accounting (host-side, no model): mirrors tests/test_paged.py
# ---------------------------------------------------------------------------


def test_pool_page_accounting_and_prefix_eviction():
    tc = model_pair(mod=False)[2]
    pool = PagedCachePool(tc, 2, 16, 4, torch.device("cpu"), n_pages=8, prefix_chunk=4)
    assert pool.available_pages() == 6
    pool.acquire(0)
    assert (pool.table_np[0] == NULL_PAGE).all()
    assert pool.alloc_pages(0, 9)  # 3 pages
    assert pool.available_pages() == 3
    assert int(pool.n_mapped[0]) == 3
    # register a 2-page (8-token) prefix; release keeps its pages cached
    toks = np.arange(12, dtype=np.int32)
    work = pool.read_slot(0)
    pool.prefix_register(0, toks, {4: pool.snapshot_resid(work), 8: pool.snapshot_resid(work)})
    pool.release(0)
    assert (pool.table_np[0] == SCRATCH_PAGE).all()
    stats = pool.page_stats()
    assert stats["pages_in_use"] == 0 and stats["pages_cached_only"] == 2
    assert pool.available_pages() == 6  # cached pages are evictable
    # exhausting the free list evicts LRU prefix entries
    pool.acquire(0)
    assert pool.alloc_pages(0, 16)  # 4 pages: 4 free + evict
    pool.acquire(1)
    assert pool.alloc_pages(1, 8)  # remaining 2 via eviction
    assert not pool.alloc_pages(1, 12)  # nothing left anywhere
    assert pool.prefix_evictions >= 1
    pool.release(0)
    assert pool.alloc_pages(1, 12)


def test_pool_scrubs_recycled_pages_and_snapshots_are_copies():
    tc = model_pair(mod=True)[2]
    pool = PagedCachePool(tc, 1, 16, 4, torch.device("cpu"), n_pages=3, prefix_chunk=4)
    pool.acquire(0)
    assert pool.alloc_pages(0, 4)
    pid = int(pool.table_np[0, 0])
    for pages in pool.pages:  # a finished request's garbage
        pages[pid] = 7
    work = pool.read_slot(0)
    snap = pool.snapshot_resid(work)
    for leaf in snap.values():
        assert all(leaf.data_ptr() != r.data_ptr() for r in pool.resid)
    pool.release(0)
    pool.acquire(0)
    assert pool.alloc_pages(0, 4) and int(pool.table_np[0, 0]) == pid
    for pages, tmpl in zip(pool.pages, pool._tmpl_pages):
        assert torch.equal(pages[pid], tmpl)  # zeros for K/V, -1 for positions


def test_pool_rejects_bad_geometry():
    tc = model_pair(mod=False)[2]
    with pytest.raises(ValueError):
        PagedCachePool(tc, 2, 16, 5, torch.device("cpu"))
    with pytest.raises(ValueError):
        PagedCachePool(tc, 2, 16, 4, torch.device("cpu"), prefix_chunk=6)
    with pytest.raises(ValueError):
        EngineConfig(batch_size=2, ctx=16, prefix_cache=True)
    with pytest.raises(ValueError):
        EngineConfig(batch_size=2, ctx=16, n_pages=8)


# ---------------------------------------------------------------------------
# Engine streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_paged_equals_contiguous_in_the_port(backend):
    prompts = shared_prefix_prompts()
    base, _, _, _ = run_both(prompts, 5, arrival_every=1, jax_side=False, batch_size=2, ctx=24,
                             prefill_chunk=4)
    paged, eng, _, _ = run_both(prompts, 5, arrival_every=1, jax_side=False, backend=backend,
                                batch_size=2, ctx=24, page_size=4, prefill_chunk=4)
    assert paged == base
    assert eng.stats()["pages_in_use"] == 0.0


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_paged_streams_equal_jax_engine(prefix_cache):
    prompts = shared_prefix_prompts()
    t, teng, j, jeng = run_both(prompts, [5, 3, 6, 4, 5], arrival_every=1, batch_size=2, ctx=24,
                                page_size=4, prefill_chunk=4, prefix_cache=prefix_cache)
    assert t == j
    ts, js = teng.stats(), jeng.stats()
    for key in ("steps", "prefill_tokens_computed", "prefix_hit_rate", "page_utilization_peak",
                "prefix_entries", "preemptions", "kv_bytes", "resid_bytes"):
        assert ts[key] == js[key], key
    assert (ts["prefix_hit_rate"] > 0) == prefix_cache


def test_prefix_warm_equals_cold_and_entry_reused_twice():
    """Three identical prompts one after another: the second and third
    restore the same entry. Both warm streams equal the cold one, so the
    restore never wrote into the stored snapshot."""
    tc, tp = model_pair(mod=True)[2:]
    p = shared_prefix_prompts(n=1, prefix=10, tails=(0,))[0]
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=1, ctx=16, page_size=4, prefill_chunk=4,
                                             prefix_cache=True), device="cpu")
    outs, computed = [], []
    for _ in range(3):
        before = eng.stats()["prefill_tokens_computed"]
        eng.submit(Request(tokens=p, max_new_tokens=4))
        outs.append(eng.run()[-1].tokens.tolist())
        computed.append(eng.stats()["prefill_tokens_computed"] - before)
    assert outs[0] == outs[1] == outs[2]
    assert computed == [10, 2, 2]  # boundary 8 cached: only the tail recomputes
    cold = ServingEngine(tp, tc, EngineConfig(batch_size=1, ctx=16, page_size=4, prefill_chunk=4),
                         device="cpu")
    cold.submit(Request(tokens=p, max_new_tokens=4))
    assert cold.run()[0].tokens.tolist() == outs[0]


def test_page_exhaustion_preempts_youngest_back_to_queue():
    """Cross-wave overcommit: lazy growth exhausts the pool, the youngest
    slot is preempted and requeued, and the streams still equal the
    contiguous engine's and the JAX paged engine's (MoD off)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, size=4) for _ in range(2)]
    t, teng, j, jeng = run_both(prompts, 12, arrival_every=2, mod=False, batch_size=2, ctx=16,
                                page_size=4, n_pages=8)
    assert teng.preemptions >= 1 and teng.preemptions == jeng.preemptions
    assert t == j
    base, _, _, _ = run_both(prompts, 12, arrival_every=2, jax_side=False, mod=False,
                             batch_size=2, ctx=16)
    assert t == base
    assert teng.stats()["pages_in_use"] == 0.0
    teng.scheduler.check_invariants(teng.slots, len(t))


def test_preemption_mid_chunked_prefill_resumes_bit_identical():
    """The ragged engine ingests one segment per step, so an older slot's
    growth exhausts the pool while a younger one is mid-prompt: the victim
    requeues and, re-admitted, reproduces an uninterrupted run."""
    rng = np.random.default_rng(5)
    pa = rng.integers(1, 96, size=4)
    pb = rng.integers(1, 96, size=14)
    victim_states = []

    def run(**kw):
        _, _, tc, tp = model_pair(mod=False)
        eng = ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=32, page_size=4, ragged=True,
                                                 ragged_segments=1, **kw), device="cpu")
        orig = eng._preempt
        eng._preempt = lambda s: (victim_states.append(s.state), orig(s))[1]
        eng.submit(Request(tokens=pa, max_new_tokens=12))
        eng.submit(Request(tokens=pb, max_new_tokens=2))
        return {o.uid: o.full_sequence.tolist() for o in eng.run()}, eng

    outs, eng = run(n_pages=7)
    assert eng.preemptions >= 1 and PREFILL in victim_states
    ref_outs, ref_eng = run()
    assert ref_eng.preemptions == 0
    assert outs == ref_outs
    assert eng.stats()["pages_in_use"] == 0.0
    eng.scheduler.check_invariants(eng.slots, len(outs))


def test_admission_gate_blocks_oversized_and_transient_requests():
    _, _, tc, tp = model_pair(mod=False)
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=1, ctx=16, page_size=4, n_pages=4),
                        device="cpu")
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(tokens=np.arange(8), max_new_tokens=8))
    eng2 = ServingEngine(tp, tc, EngineConfig(batch_size=2, ctx=16, page_size=4, n_pages=6),
                         device="cpu")
    eng2.submit(Request(tokens=np.arange(4), max_new_tokens=12))  # 4 pages
    eng2.step()
    eng2.submit(Request(tokens=np.arange(4), max_new_tokens=12))
    eng2.step()
    assert len(eng2.scheduler.queue) == 1  # gated while the first runs
    assert len(eng2.run()) == 2
