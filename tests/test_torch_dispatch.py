"""The MoD dispatch kernels' launch plan and their gradients (CPU).

- ``routing.dispatch_plan``, the pure planner of the gather and gated
  scatter-add kernels (csrc/routing.cu): the vector width by row bytes and
  by base offsets, threads and vectors a thread, index width and grid (the
  gather's per output row, the scatter's flat) at the shapes the
  main paths give the kernels (a served mod-paper-1b prompt, mamba2-1.3b's
  training step, the flat stream of 8 segments), k = S, and the refusals;
  that the C entry point gets the plan and the launch counter records it
  by call, the zero target with no x and no gate.
- The gradients of ``gather_rows`` and ``scatter_add_rows`` on the CPU
  (plain versions; gather's backward through ``gather_rows_vjp``, the code
  that on the card launches the scatter's zero target) against ``jax.vjp``
  of the Pallas kernels in interpret mode, in f32 and bf16: dx and ddelta
  bit for bit, dgate within 1e-6 relative (a sum over D in another order
  than XLA's). Torch runs on one thread here (ROADMAP Queue 3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.routing import gather_rows as j_gather  # noqa: E402
from repro.kernels.routing import scatter_add_rows as j_scatter  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as KP  # noqa: E402
from repro_torch.kernels import ragged as KRG  # noqa: E402
from repro_torch.kernels import routing as KR  # noqa: E402
from test_torch_kernels import CASES, DTYPES, _bits, _routing_case, _to_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# dispatch_plan: before launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,row_bytes,elem_bytes,offset,vec", [
    ("gather", 1792 * 2, 2, 0, 16),  # mod-paper-1b's bf16 rows
    ("gather", 1792 * 2, 2, 2, 1),  # a base 2 bytes off 16: a byte copy
    ("gather", 1792 * 2, 2, 4, 4),
    ("gather", 1792 * 2, 2, 8, 4),
    ("gather", 5 * 4, 4, 0, 4),  # rows of 20 bytes
    ("gather", 5 * 2, 2, 0, 1),  # rows of 10 bytes
    ("scatter", 1792 * 2, 2, 0, 16),
    ("scatter", 1792 * 2, 2, 2, 2),  # whole bf16 elements
    ("scatter", 1792 * 2, 2, 4, 4),
    ("scatter", 1792 * 2, 2, 8, 4),
    ("scatter", 1792 * 4, 4, 4, 4),
    ("scatter", 5 * 2, 2, 0, 2),
    ("scatter_zero", 2048 * 2, 2, 2, 2),
    ("scatter_zero", 2048 * 4, 4, 8, 4),
])
def test_dispatch_plan_takes_the_widest_vector_that_divides_row_and_bases(
        kind, row_bytes, elem_bytes, offset, vec):
    for bases in ((offset, 0, 0), (0, offset, 0), (0, 0, offset)):
        assert KR.dispatch_plan(kind, 2, 300, 40, row_bytes, elem_bytes, 8, bases).vec == vec


@pytest.mark.parametrize("kind,B,S,k,D,idx_bytes,threads,unroll,grid", [
    # a served prompt: 128 rows of 224 vectors, 128 threads of 2 each
    ("gather", 1, 1000, 128, 1792, 8, 128, 2, (128, 1, 1)),
    ("scatter", 1, 1000, 128, 1792, 8, 256, 1, (875, 1, 1)),  # 224000 vectors
    ("gather", 4, 2048, 256, 2048, 8, 128, 2, (256, 1, 4)),  # mamba2-1.3b's training step
    ("scatter", 4, 2048, 256, 2048, 8, 256, 1, (8192, 1, 1)),
    ("scatter_zero", 4, 2048, 256, 2048, 8, 256, 2, (4096, 1, 1)),  # past a card of threads
    ("scatter_zero", 1, 1000, 128, 1792, 8, 256, 1, (875, 1, 1)),
    ("gather", 1, 4096, 8 * 128, 1792, 4, 128, 2, (1024, 1, 1)),  # phase 8b's flat stream
    ("scatter", 1, 4096, 8 * 128, 1792, 4, 256, 1, (3584, 1, 1)),
    ("gather", 2, 300, 300, 96, 8, 32, 2, (300, 1, 2)),  # k = S; rows of 12 vectors
    ("scatter", 2, 300, 300, 96, 8, 256, 1, (29, 1, 1)),
    ("gather", 1, 10, 4, 8192, 8, 256, 2, (4, 2, 1)),  # rows of 1024 vectors: 2 chunks
    ("gather", 2, 300, 0, 96, 8, 32, 2, (0, 1, 2)),  # nothing to do: the wrappers return first
])
def test_dispatch_plan_covers_the_output(kind, B, S, k, D, idx_bytes, threads, unroll, grid):
    plan = KR.dispatch_plan(kind, B, S, k, D * 2, 2, idx_bytes, (0, 0, 0))
    assert (plan.kind, plan.threads, plan.unroll, plan.grid, plan.idx_bytes) == (
        kind, threads, unroll, grid, idx_bytes)
    vpr = D * 2 // plan.vec
    if kind == "gather":  # a row's chunks cover its vectors, the fewest threads that do
        assert (grid[1] - 1) * threads * unroll < vpr <= grid[1] * threads * unroll
        assert threads % 32 == 0 and (threads == 32 or threads - 32 < -(-vpr // unroll))
    else:  # the flat grid covers the output with whole blocks
        per_block = KP.GATHER_THREADS * plan.unroll
        assert (grid[0] - 1) * per_block < B * S * vpr <= grid[0] * per_block
    assert not plan.wide


@pytest.mark.parametrize("kind", ["gather", "scatter", "scatter_zero"])
def test_dispatch_plan_index_width_changes_nothing_else(kind):
    p64 = KR.dispatch_plan(kind, 3, 2048, 256, 3584, 2, 8, (0, 0, 0))
    p32 = KR.dispatch_plan(kind, 3, 2048, 256, 3584, 2, 4, (0, 0, 0))
    assert (p64.idx_bytes, p32.idx_bytes) == (8, 4)
    assert p64._replace(idx_bytes=4) == p32


@pytest.mark.parametrize("B,wide", [(2 ** 20 - 1, False), (2 ** 20, True)])
def test_dispatch_plan_widens_the_scatter_past_32_bits(B, wide):
    # rows of 2^12 vectors of 16 bytes: 2^20 - 1 of them stay under 2^32
    # vectors, 2^20 reach it; the gather's row grid indexes a row's vectors
    # in 32 bits and its rows in 64
    assert KR.dispatch_plan("scatter", B, 1, 1, 2 ** 16, 2, 8, (0, 0)).wide == wide
    assert not KR.dispatch_plan("gather", 1, 1, B, 2 ** 16, 2, 8, (0, 0)).wide


@pytest.mark.parametrize("args", [
    ("gather", 1, 10, 2, 0, 2, 8, (0,)),  # an empty row
    ("scatter", 1, 10, 2, 0, 2, 8, (0,)),
    ("scatter", -1, 10, 2, 64, 2, 8, (0,)),  # a negative count
    ("gather", 1, 10, -2, 64, 2, 8, (0,)),
    ("scatter", 1, 10, 2, 63, 2, 8, (0,)),  # a row of half an element
    ("scatter", 1, 10, 2, 64, 2, 2, (0,)),  # indices of 2 bytes
    ("copy", 1, 10, 2, 64, 2, 8, (0,)),  # an unknown kind
    ("gather", 2 ** 16, 1, 2, 64, 2, 8, (0,)),  # a grid beyond CUDA's: B > 65535
    ("gather", 1, 1, 2, 2 ** 31, 2, 8, (0,)),  # 65536 chunks of a row
    ("gather", 1, 1, 2 ** 31, 64, 2, 8, (0,)),  # k > 2^31 - 1
    ("scatter", 2 ** 30, 2 ** 10, 1, 2 ** 12 + 2, 2, 8, (0,)),
])
def test_dispatch_plan_raises_for_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        KR.dispatch_plan(*args)


class _FakeEntry:
    """Stands in for a C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def entry(monkeypatch):
    fake = _FakeEntry()
    monkeypatch.setattr(KR.build, "bind", lambda *a: fake)
    monkeypatch.setattr(KR.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    build.reset_counters()
    yield fake
    build.reset_counters()


@pytest.mark.parametrize("dtype,offset,idx_dtype", [(torch.bfloat16, 0, torch.int64),
                                                    (torch.bfloat16, 1, torch.int32),
                                                    (torch.float32, 1, torch.int64)])
def test_gather_passes_its_plan_to_the_entry_point(entry, dtype, offset, idx_dtype):
    """The plan dispatch_plan makes for x's own base (an offset view keeps
    it) is what the C entry point gets, and the counter records it by call."""
    B, S, D, k = 2, 9, 8, 3
    x = torch.zeros(offset + B * S * D, dtype=dtype)[offset:].view(B, S, D)
    idx = torch.zeros(B, k, dtype=idx_dtype)
    out = KR.gather_launch(x, idx, KR.GATHER_ROWS)
    es, ib = x.element_size(), idx.element_size()
    plan = KR.dispatch_plan("gather", B, S, k, D * es, es, ib, (x.data_ptr(), out.data_ptr()))
    assert out.shape == (B, k, D) and plan.vec == (16 if offset == 0 else 4 if es == 4 else 1)
    # (x, idx, out, B, S, k, row_bytes, idx_bytes, vec, threads, chunks, stream)
    assert entry.args[3:11] == (B, S, k, D * es, ib, plan.vec, plan.threads, plan.grid[1])
    assert KR.GATHER_ROWS.by_call == {("gather", plan.vec, plan.unroll, B, S, k, D * es): 1}


@pytest.mark.parametrize("dtype,offset,zero", [(torch.bfloat16, 0, False),
                                               (torch.bfloat16, 1, False),
                                               (torch.float32, 1, True),
                                               (torch.bfloat16, 1, True)])
def test_scatter_passes_its_plan_to_the_entry_point(entry, dtype, offset, zero):
    """One entry-point call a scatter; the zero target passes no x and no
    gate and is counted by its kind."""
    B, S, D, k = 2, 9, 8, 3
    delta = torch.zeros(offset + B * k * D, dtype=dtype)[offset:].view(B, k, D)
    x = None if zero else torch.zeros(B, S, D, dtype=dtype)
    gate = None if zero else torch.zeros(B, k)
    idx = torch.zeros(B, k, dtype=torch.int64)
    out = KR.scatter_launch(x, idx, delta, gate, KR.SCATTER_ADD_ROWS, (B, S, D))
    es = delta.element_size()
    kind = "scatter_zero" if zero else "scatter"
    bases = tuple(t.data_ptr() for t in (x, delta, out) if t is not None)
    plan = KR.dispatch_plan(kind, B, S, k, D * es, es, 8, bases)
    assert out.shape == (B, S, D) and plan.vec == (16 if offset == 0 else es)
    # (x, idx, delta, gate, out, B, S, k, D, dtype, idx_bytes, vec, unroll, wide, blocks, stream)
    assert (entry.args[0] is None, entry.args[3] is None) == (zero, zero)
    assert entry.args[5:15] == (B, S, k, D, KR._DTYPES[dtype], 8, plan.vec, plan.unroll, 0,
                                plan.grid[0])
    assert KR.SCATTER_ADD_ROWS.by_call == {(kind, plan.vec, plan.unroll, B, S, k, D * es): 1}


def test_ragged_dispatch_launches_the_routing_kernels(entry, monkeypatch):
    """The flat stream's wrappers launch the same entry points with int32
    indices, B = 1 and S = T, counted on their own counters."""
    seen = []

    def launch(name):
        real = getattr(KR, name)

        def spy(x, idx, *rest):
            seen.append((name, tuple(x.shape), tuple(idx.shape), idx.dtype, rest[-1].name))
            return real(x, idx, *rest)
        return spy

    monkeypatch.setattr(KRG, "gather_launch", launch("gather_launch"))
    monkeypatch.setattr(KRG, "scatter_launch", launch("scatter_launch"))
    monkeypatch.setattr(KRG, "check_device", lambda *t: "cuda")
    T, D, n_seg, k = 20, 8, 3, 4
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    idx = torch.zeros(n_seg, k, dtype=torch.int32)
    assert KRG.ragged_gather_rows(x, idx).shape == (n_seg, k, D)
    out = KRG.ragged_scatter_add_rows(x, idx, torch.zeros(n_seg, k, D, dtype=torch.bfloat16),
                                      torch.zeros(n_seg, k))
    assert out.shape == (T, D)
    assert seen == [("gather_launch", (1, T, D), (1, n_seg * k), torch.int32, "ragged_gather_rows"),
                    ("scatter_launch", (1, T, D), (1, n_seg * k), torch.int32,
                     "ragged_scatter_add_rows")]
    assert [key[0] for key in KRG.RAGGED_GATHER_ROWS.by_call] == ["gather"]
    assert [key[0] for key in KRG.RAGGED_SCATTER_ADD_ROWS.by_call] == ["scatter"]


# ---------------------------------------------------------------------------
# gradients against the JAX custom VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio,S", CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gather_rows_vjp_bitwise_vs_jax(ratio, S, dt):
    x, idx, _, _ = _routing_case(ratio, S, DTYPES[dt][0], seed=3)
    ct = np.random.default_rng(4).standard_normal((x.shape[0], idx.shape[1], x.shape[2]))
    ct = ct.astype(np.float32).astype(DTYPES[dt][0])
    _, vjp = jax.vjp(lambda x_: j_gather(x_, jnp.asarray(idx), interpret=True, block_s=16),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    tx = _to_torch(x).requires_grad_(True)
    (got,) = torch.autograd.grad(KR.gather_rows(tx, torch.as_tensor(idx).long()), tx,
                                 _to_torch(ct))
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ratio,S", CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_scatter_add_rows_vjp_vs_jax(ratio, S, dt):
    x, idx, delta, gate = _routing_case(ratio, S, DTYPES[dt][0], seed=5)
    ct = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    ct = ct.astype(DTYPES[dt][0])
    _, vjp = jax.vjp(lambda *a: j_scatter(a[0], jnp.asarray(idx), a[1], a[2], interpret=True,
                                          block_s=16),
                     jnp.asarray(x), jnp.asarray(delta), jnp.asarray(gate))
    wx, wd, wg = vjp(jnp.asarray(ct))
    leaves = [_to_torch(a).requires_grad_(True) for a in (x, delta, gate)]
    out = KR.scatter_add_rows(leaves[0], torch.as_tensor(idx).long(), leaves[1], leaves[2])
    gx, gd, gg = torch.autograd.grad(out, leaves, _to_torch(ct))
    np.testing.assert_array_equal(_bits(gx), _bits(wx))
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-6, atol=1e-6)
