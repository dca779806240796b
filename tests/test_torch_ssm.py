"""The port's Mamba2 (ssm) family against the JAX package, on the CPU.

Same inputs, drawn from a numpy seed, through the JAX function and its
port; same weights (the JAX tree carried across by ``repro_torch.params``).
Tolerances are of the largest absolute value of the JAX result, unless
stated:

- the SSD intra-chunk kernel's plain version against the Pallas kernel in
  interpret mode (f32 and bf16 inputs; the plain version computes in f32
  as the Pallas kernel does), and against the sequential oracle
  ``kernels/ref.py::ssd_chunk_ref``, within 1e-5 plus the rounding of the
  two f32 cumsums of ``loglam`` (``2·max|l|·2^-24``: at mamba2's A and dt
  ``|l|`` reaches 189 inside a 128-chunk, and the exponentials of
  differences of such sums carry it);
- ``ssd_chunked`` (with and without an initial state), ``ssm_block`` and
  ``ssm_block_decode`` unrolled over a sequence, f32 within 1e-5;
- the gradient hazard of the reference: at mamba2-1.3b's A and dt the JAX
  ``ssd_chunked`` exponentiates the whole Q x Q tile before masking, its
  upper triangle overflows, and ``jax.grad`` with respect to ``dt`` holds
  NaN; the port masks before the exponential and its gradient is finite
  and equals ``jax.grad`` through the sequential ``ssd_step`` recurrence
  within 1e-4;
- ``smoke_config(mamba2-1.3b)`` in f32: logits within 1e-5, identical
  routed masks, aux and loss, every gradient leaf within 1e-4 of the
  leaf's largest |grad| (remat none and full), 16 decode steps with an
  ``active`` mask (logits and caches); forward, gradients and decode also
  with MoD off (``mamba2-1.3b-dense``) and with MoD every layer; the stepped serving engine's greedy
  streams and stats equal the JAX engine's, contiguous and paged;
  ``Trainer`` losses equal the JAX train loop's within 1e-5; the
  checkpoint round-trips the ssm tree in the JAX format both ways;
- the kernel's pure planner ``ssd_plan``: the path by dtype, shape and
  alignment, a grid that covers every (b, h, c), shared memory within the
  limit, a schedule that balances the warps, its refusals, and the plan is
  what the C entry point receives and the launch counter records.
"""
import ctypes
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.ssd import ssd_intra_chunk as jax_ssd_intra_chunk  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import ssd as KSSD  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serve.cache import paged_leaf_ids  # noqa: E402
from repro_torch.train import Trainer, make_train_state  # noqa: E402
from repro_torch.train.loop import state_from_host, state_to_host  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ARCH = "mamba2-1.3b"
TOL = 1e-5  # f32, of the largest |value|
GRAD_TOL = 1e-4  # of the leaf's largest |grad|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only. With JAX in the same
    process, a torch worker thread now and then computes ``torch.exp`` off
    by ~1e-4 (half of a two-thread op's elements, the same wrong values in
    separate processes; the calling thread stays right), which this
    module's 1e-5 comparisons would catch as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"max error {err:.3g} of the largest |value| (limit {tol:g})"


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _init_dt(rng, shape):
    """dt as mamba2's init draws dt_bias: log-uniform on [1e-3, 0.1]."""
    u = rng.random(shape)
    return np.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3)).astype(np.float32)


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------


def _kernel_inputs(B, H, NC, Q, hd, ds, init_like, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, NC, Q, hd)).astype(np.float32)
    if init_like:  # mamba2's A = -(1..H) and dt
        dt = _init_dt(rng, (B, H, NC, Q))
        A = -np.arange(1, H + 1, dtype=np.float32)
    else:  # tests/test_kernels.py's draw
        dt = np.log1p(np.exp(rng.standard_normal((B, H, NC, Q)))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    loglam = (dt * A[None, :, None, None]).astype(np.float32)
    Bm = rng.standard_normal((B, NC, Q, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, NC, Q, ds)).astype(np.float32)
    return x, loglam, dt, Bm, Cm


KERNEL_SHAPES = [((2, 3, 4, 32, 16, 8), False), ((1, 2, 2, 64, 32, 16), False),
                 ((1, 64, 2, 128, 8, 16), True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,init_like", KERNEL_SHAPES)
def test_ssd_intra_chunk_plain_matches_pallas_and_ref(shape, init_like, dtype):
    x, loglam, dt, Bm, Cm = _kernel_inputs(*shape, init_like)
    jx, jB, jC = (jnp.asarray(a).astype(dtype) for a in (x, Bm, Cm))
    jy, jinc = jax_ssd_intra_chunk(jx, jnp.asarray(loglam), jnp.asarray(dt), jB, jC,
                                   interpret=True)
    tx, tB, tC = (_t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jx, jB, jC))
    ty, tinc = KSSD.ssd_intra_chunk(tx, _t(loglam), _t(dt), tB, tC)
    assert ty.dtype == tinc.dtype == torch.float32
    # both sides take the f32 cumsum of loglam in their own order; each
    # decay exp(l_i - l_j) carries that rounding, up to |l|·2^-24 relative
    tol = TOL + 2 * np.abs(np.cumsum(loglam, axis=-1)).max() * 2.0**-24
    _close(_np(ty), jy, tol)
    _close(_np(tinc), jinc, tol)
    assert np.isfinite(_np(ty)).all() and np.isfinite(_np(tinc)).all()
    # the sequential oracle, one (b, h, c) tile at a time (a few at the
    # 64-head shape)
    B, H, NC = shape[:3]
    tiles = [(b, h, c) for b in range(B) for h in range(H) for c in range(NC)]
    for b, h, c in tiles[:: max(1, len(tiles) // 8)]:
        yr, incr = JREF.ssd_chunk_ref(jx[b, h, c], loglam[b, h, c], dt[b, h, c], jB[b, c],
                                      jC[b, c])
        _close(_np(ty[b, h, c]), yr, tol)
        _close(_np(tinc[b, h, c]), incr, tol)


def test_ssd_intra_chunk_validates_its_inputs():
    x, loglam, dt, Bm, Cm = (_t(a) for a in _kernel_inputs(1, 2, 2, 16, 8, 8, False))
    with pytest.raises(ValueError, match="loglam and dt"):
        KSSD.ssd_intra_chunk(x, loglam[..., :8], dt, Bm, Cm)
    with pytest.raises(ValueError, match="Bm and Cm"):
        KSSD.ssd_intra_chunk(x, loglam, dt, Bm[:, :1], Cm)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        KSSD.ssd_intra_chunk(x.half(), loglam, dt, Bm, Cm)
    with pytest.raises(TypeError, match="unsupported dtypes"):  # x, Bm, Cm share one dtype
        KSSD.ssd_intra_chunk(x.bfloat16(), loglam, dt, Bm, Cm)
    # the kernel's shared-memory plan: mamba2-1.3b's chunk fits one block
    assert KSSD.smem_bytes(128, 64, 128) == 230912 <= KSSD.SMEM_LIMIT
    assert KSSD.head_group(4, 64, 16, 132) == 8 and KSSD.head_group(1, 3, 2, 132) == 1


# ---------------------------------------------------------------------------
# ssd_plan: the kernel's path, heads per block, grid and schedule, before launch
# ---------------------------------------------------------------------------

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("dtype,shape,aligned,path", [
    (torch.bfloat16, (4, 64, 16, 128, 64, 128), True, "tensor"),  # mamba2-1.3b's full blocks
    (torch.bfloat16, (4, 64, 2, 128, 64, 128), True, "tensor"),  # its routed blocks
    (torch.bfloat16, (1, 3, 2, 16, 32, 16), True, "tensor"),  # the smoke chunk
    (torch.float32, (4, 64, 16, 128, 64, 128), True, "cuda"),  # f32 parity runs
    (torch.bfloat16, (4, 64, 16, 128, 64, 128), False, "cuda"),  # rows off 16 bytes
    (torch.bfloat16, (2, 5, 3, 40, 8, 24), True, "cuda"),  # widths not multiples of 16
    (torch.bfloat16, (1, 2, 1, 144, 16, 16), True, "cuda"),  # a chunk over 128
])
def test_ssd_plan_picks_the_path_by_dtype_and_shape(dtype, shape, aligned, path):
    plan = KSSD.ssd_plan(*shape, dtype, SMS, aligned)
    assert plan.path == path
    assert bool(plan.schedule) == (path == "tensor")


@pytest.mark.parametrize("shape,G", [
    ((4, 64, 16, 128, 64, 128), 32),  # 128 blocks of 32 heads: one per SM
    ((4, 64, 2, 128, 64, 128), 4),  # 128 blocks of 4 heads
    ((4, 5, 16, 64, 32, 32), 3),  # 128 blocks; G does not divide H
    ((1, 3, 2, 16, 32, 16), 1),
    ((40, 64, 16, 128, 64, 128), 64),  # more (b, c) than SMs: all heads in a block
])
def test_ssd_plan_grid_covers_every_head_chunk_and_batch(shape, G):
    B, H, NC = shape[:3]
    plan = KSSD.ssd_plan(*shape, torch.bfloat16, SMS)
    assert plan.G == G and plan.grid == (B * NC, -(-H // G))
    # every (b, h, c) in exactly one block: block (bc, hg) takes chunk bc % NC
    # of batch bc // NC and heads hg·G .. min(H, hg·G + G) - 1
    seen = [(bc // NC, h, bc % NC) for bc in range(plan.grid[0]) for hg in range(plan.grid[1])
            for h in range(hg * G, min(H, hg * G + G))]
    assert sorted(seen) == [(b, h, c) for b in range(B) for h in range(H) for c in range(NC)]
    f32 = KSSD.ssd_plan(*shape, torch.float32, SMS)
    assert f32.G == KSSD.head_group(B, H, NC, SMS) and f32.grid == (B * NC, -(-H // f32.G))


def test_ssd_plan_shared_memory_within_the_limit():
    # the tensor-core block at mamba2's chunk: B, C.B^T, x of two heads, x∘w
    # in three bf16 terms, l/dt/w and the schedule; one block per SM
    plan = KSSD.ssd_plan(4, 64, 16, 128, 64, 128, torch.bfloat16, SMS)
    assert plan.smem == KSSD.tc_smem_bytes(128, 64, 128) == 165504 <= KSSD.SMEM_LIMIT
    assert KSSD.ssd_plan(4, 64, 16, 128, 64, 128, torch.float32, SMS).smem == 230912
    for shape in ((1, 1, 1, 16, 16, 16), (1, 1, 1, 128, 32, 64), (1, 1, 1, 64, 64, 128),
                  (1, 1, 1, 64, 128, 128)):
        assert KSSD.ssd_plan(*shape, torch.bfloat16, SMS).smem <= KSSD.SMEM_LIMIT
    # head dim 128 at chunk 128 fits neither the tensor-core block (x∘w,
    # two heads of x) nor the CUDA-core one
    assert KSSD.tc_smem_bytes(128, 128, 128) > KSSD.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        KSSD.ssd_plan(1, 1, 1, 128, 128, 128, torch.bfloat16, SMS)


def test_ssd_plan_schedule_balances_the_warps():
    """Longest task first, each to the least-loaded warp: at mamba2's chunk
    the 24 tasks of a head (y's 8 row tiles x 2 column chunks cost 6..48 mma
    triples with their M fragments, inc's 8 cost 64) land within 12% of the
    mean load on each of the 16 warps."""
    cost = KSSD.tc_tasks(128, 64, 128)
    sched = KSSD.ssd_plan(4, 64, 16, 128, 64, 128, torch.bfloat16, SMS).schedule
    assert len(cost) == len(sched) == 24 and sum(cost) == 944
    load = [sum(c for c, w in zip(cost, sched) if w == warp) for warp in range(KSSD.TC_WARPS)]
    assert max(load) <= 1.12 * sum(cost) / KSSD.TC_WARPS and min(load) > 0
    for shape in ((16, 32, 16), (48, 16, 32), (128, 48, 80), (128, 80, 64)):
        cost, sched = KSSD.tc_tasks(*shape), KSSD.tc_schedule(*shape)
        load = [sum(c for c, w in zip(cost, sched) if w == warp) for warp in range(16)]
        assert set(sched) <= set(range(16)) and max(load) - min(load) <= max(cost)


def test_ssd_plan_refuses_what_no_path_takes():
    with pytest.raises(TypeError):
        KSSD.ssd_plan(1, 1, 1, 16, 16, 16, torch.float16, SMS)
    with pytest.raises(ValueError, match="tensor-core path does not take"):
        KSSD.ssd_plan(1, 1, 1, 16, 16, 16, torch.float32, SMS, path="tensor")
    with pytest.raises(ValueError, match="tensor-core path does not take"):
        KSSD.ssd_plan(1, 1, 1, 40, 16, 16, torch.bfloat16, SMS, path="tensor")
    with pytest.raises(ValueError, match="unknown path"):
        KSSD.ssd_plan(1, 1, 1, 16, 16, 16, torch.bfloat16, SMS, path="wgmma")
    with pytest.raises(ValueError):
        KSSD.ssd_plan(1, 0, 1, 16, 16, 16, torch.bfloat16, SMS)
    # the CUDA-core path forced for a shape the tensor cores take
    assert KSSD.ssd_plan(4, 64, 16, 128, 64, 128, torch.bfloat16, SMS, path="cuda").path == "cuda"


class _FakeEntry:
    def __call__(self, *args):
        self.args = args
        self.sched = ctypes.string_at(args[17], args[18]) if args[18] else b""
        return 0


@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, None), (torch.bfloat16, "cuda"),
                                        (torch.float32, None)])
def test_ssd_launch_passes_its_plan_to_the_entry_point(monkeypatch, dtype, path):
    """The plan ssd_plan made for the call (path, G, schedule, shared memory)
    is what the C entry point gets, and the launch counter records the path
    by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(KSSD.build, "bind", lambda *a: entry)
    monkeypatch.setattr(KSSD.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: type("P", (), {"multi_processor_count": SMS}))
    B, H, NC, Q, hd, ds = 2, 5, 3, 32, 32, 16
    x, loglam, dt, Bm, Cm = (_t(a) for a in _kernel_inputs(B, H, NC, Q, hd, ds, True))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    KSSD.build.reset_counters()
    KSSD._launch(x, loglam, dt, Bm, Cm, path)
    plan = KSSD.ssd_plan(B, H, NC, Q, hd, ds, dtype, SMS, KSSD.aligned_rows(x, Bm, Cm), path)
    assert plan.path == ("tensor" if dtype == torch.bfloat16 and path is None else "cuda")
    # (x, loglam, dt, Bm, Cm, y, inc, strides, B, H, NC, Q, hd, ds, G, dtype, path, sched,
    #  n_tasks, smem, stream)
    assert entry.args[8:17] == (B, H, NC, Q, hd, ds, plan.G, int(dtype == torch.bfloat16),
                                int(plan.path == "tensor"))
    assert entry.args[18:20] == (len(plan.schedule), plan.smem)
    assert tuple(entry.sched) == plan.schedule
    assert KSSD.SSD_INTRA_CHUNK.by_call == {(plan.path, B, H, NC, Q, hd, ds): 1}
    KSSD.build.reset_counters()


# ---------------------------------------------------------------------------
# The SSD scan and the block
# ---------------------------------------------------------------------------


def _scan_inputs(B, S, H, hd, ds, init_like, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    if init_like:
        dt = _init_dt(rng, (B, S, H))
        A = -np.arange(1, H + 1, dtype=np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, ds)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    x, dt, A, Bm, Cm, s0 = _scan_inputs(2, 48, 3, 8, 4, False)
    jy, jfinal = JSSM.ssd_chunked(x, dt, A, Bm, Cm, 16, s0 if with_state else None)
    ty, tfinal = TSSM.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), 16,
                                  _t(s0) if with_state else None)
    _close(_np(ty), jy)
    _close(_np(tfinal), jfinal)


def _sequential_ssd(x, dt, A, Bm, Cm):
    """The JAX recurrence ``ssd_step`` stepped over the sequence (the loop
    of tests/test_ssm.py, as a ``lax.scan``)."""
    B, S, H, hd = x.shape

    def body(state, step):
        xt, dtt, bt, ct = step
        y, state = JSSM.ssd_step(xt, dtt, A, bt, ct, state)
        return state, y

    state0 = jnp.zeros((B, H, hd, Bm.shape[-1]), jnp.float32)
    steps = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (x, dt, Bm, Cm))
    state, ys = jax.lax.scan(body, state0, steps)
    return jnp.moveaxis(ys, 0, 1), state


def test_reference_dt_gradient_is_nan_where_the_port_is_finite():
    """B=1, S=256, H=64 (A = -(1..64)), hd 8, ds 16, chunk 128, dt as at
    init: the JAX chunked scan's gradient with respect to dt holds NaN (its
    masked exponential overflows above the diagonal); the port's is finite
    and equals the gradient through the sequential recurrence."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(1, 256, 64, 8, 16, True, seed=2)

    def jloss(x, dt):
        return jnp.sum(JSSM.ssd_chunked(x, dt, A, Bm, Cm, 128)[0] ** 2)

    jgx, jgdt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(x, dt)
    assert np.isfinite(np.asarray(JSSM.ssd_chunked(x, dt, A, Bm, Cm, 128)[0])).all()
    assert np.isfinite(np.asarray(jgx)).all()
    n_nan = int(np.isnan(np.asarray(jgdt)).sum())
    assert n_nan > 0, "the reference's dt gradient is expected to hold NaN here"

    sgx, sgdt = jax.jit(jax.grad(
        lambda x, dt: jnp.sum(_sequential_ssd(x, dt, A, Bm, Cm)[0] ** 2), argnums=(0, 1)))(x, dt)
    tx, tdt = _t(x).requires_grad_(True), _t(dt).requires_grad_(True)
    y, _ = TSSM.ssd_chunked(tx, tdt, _t(A), _t(Bm), _t(Cm), 128)
    (y ** 2).sum().backward()
    assert torch.isfinite(tdt.grad).all() and torch.isfinite(tx.grad).all()
    _close(_np(tdt.grad), sgdt, GRAD_TOL)
    _close(_np(tx.grad), sgx, GRAD_TOL)


def _cfgs(arch=ARCH, dtype="float32", every=None, **kw):
    """The smoke config in both packages; ``every`` overrides mod.every."""
    out = []
    for C in (JC, TC):
        cfg = C.smoke_config(C.get_config(arch))
        if every is not None:
            kw["mod"] = dataclasses.replace(cfg.mod, every=every)
        out.append(dataclasses.replace(cfg, dtype=dtype, **kw))
    return tuple(out)


# the layer groupings besides the paper's (MoD every 2): MoD off (one
# {full} group per layer) and MoD every layer (one {mod} group per layer)
OTHER_LAYOUTS = {"dense": dict(arch=ARCH + "-dense"), "every1": dict(every=1)}


@functools.lru_cache(maxsize=None)
def _jax_params(jc, seed=0):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _params(jc, seed=0):
    jp = _jax_params(jc, seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _block_params(seed=0):
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed)
    jblk = jax.tree.map(lambda a: a[0], jp["groups"]["full"]["ssm"])
    return jc, tc, jblk, tp["groups"][0]["full"]["ssm"]


def test_ssm_block_matches_jax():
    jc, tc, jblk, tblk = _block_params()
    x = np.random.default_rng(3).standard_normal((2, 32, jc.d_model)).astype(np.float32)
    _close(_np(TSSM.ssm_block(tblk, _t(x), tc)), JSSM.ssm_block(jblk, x, jc))


def test_ssm_block_decode_unrolled_matches_jax():
    jc, tc, jblk, tblk = _block_params()
    B, S = 3, 12
    x = np.random.default_rng(4).standard_normal((B, S, jc.d_model)).astype(np.float32)
    jcache = JSSM.init_ssm_cache(B, jc)
    tcache = TSSM.init_ssm_cache(B, tc, torch.device("cpu"))
    jstep = jax.jit(lambda p, x, c: JSSM.ssm_block_decode(p, x, c, jc))
    for t in range(S):
        jout, jcache = jstep(jblk, x[:, t:t + 1], jcache)
        tout, tcache = TSSM.ssm_block_decode(tblk, _t(x[:, t:t + 1]), tcache, tc)
        _close(_np(tout), jout)
    for name in jcache:
        _close(_np(tcache[name]), jcache[name])
    # from an empty cache, one step is the full-sequence block on one token
    first, _ = TSSM.ssm_block_decode(tblk, _t(x[:, :1]),
                                     TSSM.init_ssm_cache(B, tc, torch.device("cpu")), tc)
    _close(_np(first), JSSM.ssm_block(jblk, x[:, :1], jc))


# ---------------------------------------------------------------------------
# The smoke mamba2-1.3b: forward, loss, gradients, decode
# ---------------------------------------------------------------------------


def _batch(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


@pytest.fixture
def masks_of(monkeypatch):
    """The routed mask of every token_topk decision, in both packages."""
    seen = {"jax": [], "torch": []}
    jreal, treal = JROUT.decide_tokens, TROUT.decide_tokens

    def jrec(*a, **k):
        d = jreal(*a, **k)
        jax.debug.callback(lambda m: seen["jax"].append(np.asarray(m)), d.mask)
        return d

    def trec(*a, **k):
        d = treal(*a, **k)
        seen["torch"].append(d.mask.numpy())
        return d

    monkeypatch.setattr(JROUT, "decide_tokens", jrec)
    monkeypatch.setattr(TROUT, "decide_tokens", trec)
    return seen


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_loss_and_grads_match_jax(remat, masks_of):
    _check_forward_loss_and_grads(*_cfgs(remat=remat), masks_of)


@pytest.mark.parametrize("layout,remat", [("dense", "none"), ("every1", "full")])
def test_forward_loss_and_grads_match_jax_other_layouts(layout, remat, masks_of):
    jc, tc = _cfgs(remat=remat, **OTHER_LAYOUTS[layout])
    groups = TAPI.init_model(tc, device="cpu")["groups"]
    assert len(groups) == tc.n_layers
    assert {k for g in groups for k in g} == ({"full"} if layout == "dense" else {"mod"})
    _check_forward_loss_and_grads(jc, tc, masks_of)


def _check_forward_loss_and_grads(jc, tc, masks_of):
    jp, tp = _params(jc)
    batch = _batch(jc.vocab)
    jlogits, jaux = jax.jit(lambda p, b: JAPI.model_forward(p, jc, b))(jp, batch)
    with torch.no_grad():
        tlogits, taux = TAPI.model_forward(tp, tc, _torch_batch(batch))
    _close(_np(tlogits), jlogits)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5, atol=1e-6)
    n_mod = sum("mod" in g for g in tp["groups"])
    assert len(masks_of["torch"]) == len(masks_of["jax"]) == n_mod
    for t, j in zip(masks_of["torch"], masks_of["jax"]):
        np.testing.assert_array_equal(t, j)

    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JAPI.model_loss(p, jc, b), has_aux=True))(jp, batch)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tl, taux = TAPI.model_loss(tp, tc, _torch_batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    aux_terms = (tc.mod.aux_loss_weight * taux["mod/router_bce"] + taux["mod/predictor_bce"]
                 if n_mod else 0.0)
    np.testing.assert_allclose(float(taux["ce"]), float(taux["loss"]) - float(aux_terms),
                               rtol=1e-6)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(tree_map(lambda p: p.grad, tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)


def test_routed_blocks_reach_the_dispatch_kernels(monkeypatch):
    """Every backend name, pallas_fused included, runs the routed SSD
    blocks through gather/scatter (no fused SSD block, as in JAX), and every
    SSD block through the intra-chunk kernel's wrapper."""
    calls = []
    for mod, name in ((TROUT.KR, "gather_rows"), (TROUT.KR, "scatter_add_rows"),
                      (TSSM, "ssd_intra_chunk")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    for backend in ("xla", "pallas_fused"):
        calls.clear()
        _, tc = _cfgs()
        tc = TC.with_mod_backend(tc, backend)
        params = TAPI.init_model(tc, device="cpu", seed=1)
        with torch.no_grad():
            TAPI.model_forward(params, tc, _torch_batch(_batch(tc.vocab)))
        n = len(params["groups"])
        assert calls.count("gather_rows") == calls.count("scatter_add_rows") == n
        assert calls.count("ssd_intra_chunk") == 2 * n


def test_decode_16_steps_matches_jax():
    _check_decode_16_steps(*_cfgs())


@pytest.mark.parametrize("layout", sorted(OTHER_LAYOUTS))
def test_decode_16_steps_matches_jax_other_layouts(layout):
    _check_decode_16_steps(*_cfgs(**OTHER_LAYOUTS[layout]))


def _check_decode_16_steps(jc, tc):
    jp, tp = _params(jc)
    B = 4
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, (16, B)).astype(np.int32)
    jcaches = JAPI.make_caches(jc, B, 32)
    tcaches = TAPI.make_caches(tc, B, 32, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos, a: JAPI.model_decode(p, c, jc, t, pos, a))
    for i in range(16):
        active = np.array([True, i % 3 != 0, True, i < 10])
        pos = np.full((B,), i, np.int32)
        jl, jcaches, jaux = jstep(jp, jcaches, toks[i][:, None], pos, active)
        with torch.no_grad():
            tl, tcaches, taux = TAPI.model_decode(
                tp, tcaches, tc, torch.as_tensor(toks[i][:, None]).long(), torch.as_tensor(pos),
                torch.as_tensor(active))
        _close(_np(tl), jl)
        assert set(taux) == set(jaux)
        for key in jaux:  # the routed masks equal, the scores and fractions close
            if key == "mod/decode_routed":
                np.testing.assert_array_equal(_np(taux[key]), jaux[key])
            else:
                _close(_np(taux[key]), jaux[key])
    for g, tg in enumerate(tcaches["groups"]):
        for kind, leaves in tg.items():
            for name, leaf in leaves.items():
                _close(_np(leaf), np.asarray(jcaches["groups"][kind][name][g]))


def test_family_dispatch():
    _, tc = _cfgs()
    params = TAPI.init_model(tc, device="cpu", seed=0)
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="uses forward\\+decode"):
        TAPI.model_prefill(params, tc, {"tokens": toks}, 32)
    with pytest.raises(NotImplementedError, match="prompts ingest via decode steps"):
        TAPI.model_prefill_chunk(params, tc, TAPI.make_caches(tc, 1, 32, "cpu"), toks, 0, 16)
    with pytest.raises(NotImplementedError, match="use the padded model_forward"):
        TAPI.model_forward_ragged(params, tc, toks[0], torch.tensor([0, 16]), 16)
    with pytest.raises(ValueError, match="^rnn$"):  # an unknown family, as in JAX
        TAPI.init_model(dataclasses.replace(tc, family="rnn"), device="cpu")
    assert set(params["groups"][0]) == {"full", "mod"}
    assert params["groups"][0]["mod"]["block"]["ssm"]["A_log"].dtype == torch.float32
    bf = TAPI.init_model(TC.smoke_config(TC.get_config(ARCH)), device="cpu")
    ssm = bf["groups"][0]["full"]["ssm"]
    assert ssm["w_x"].dtype == torch.bfloat16
    assert ssm["A_log"].dtype == ssm["skip_D"].dtype == ssm["dt_bias"].dtype == torch.float32
    full = TC.get_config(ARCH)
    assert abs(full.n_params() - JC.get_config(ARCH).n_params()) == 0
    assert full.ssm.n_heads(full.d_model) == 64


# ---------------------------------------------------------------------------
# Serving: stepped ingestion through the engine
# ---------------------------------------------------------------------------


def _requests(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.choice([3, 6, 10, 13], n)
    gens = rng.choice([3, 6], n)
    return [(rng.integers(0, vocab, L).astype(np.int32), int(g)) for L, g in zip(lens, gens)]


_STATS = ("steps", "decode_steps", "generated_tokens", "finished_requests", "mean_occupancy",
          "mean_routed_frac", "prefill_tokens_computed", "padded_token_fraction")


@pytest.mark.parametrize("page_size", [None, 4])
def test_stepped_engine_streams_equal_jax(page_size):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    reqs = _requests(jc.vocab)
    ctx = 20
    jeng = JServingEngine(jp, jc, engine=JEngineConfig(batch_size=4, ctx=ctx))
    teng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=ctx, page_size=page_size),
                         device="cpu")
    assert teng.prefill_mode == "step"
    jout = jeng.run_stream([JRequest(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    tout = teng.run_stream([Request(tokens=t, max_new_tokens=g) for t, g in reqs], 0)
    assert {o.uid: o.tokens.tolist() for o in tout} == {o.uid: o.tokens.tolist() for o in jout}
    assert {o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in tout} == {
        o.uid: (o.admitted_step, o.first_token_step, o.finished_step) for o in jout}
    js, ts = jeng.stats(), teng.stats()
    for key in _STATS:
        if key in js:
            assert ts[key] == pytest.approx(js[key], rel=1e-12), key
    assert ts["kv_bytes"] == 0.0  # no SSM leaf is page-addressed
    if page_size is not None:
        assert paged_leaf_ids(teng.pool._template, ctx) == []
        assert ts["peak_pages_in_use"] > 0  # pages map, as in JAX, but hold nothing


def test_prefill_policy_per_family():
    _, tc = _cfgs()
    params = TAPI.init_model(tc, device="cpu", seed=0)
    with pytest.raises(ValueError, match="has no batched prefill"):
        ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16, prefill="batch"),
                      device="cpu")
    for setting, msg in ((dict(prefill_chunk=4), "ingests prompts through decode steps"),
                         (dict(page_size=4, prefix_cache=True), "prefix_cache requires"),
                         (dict(page_size=4, ragged=True), "ragged=True needs")):
        with pytest.raises(ValueError, match=msg):
            ServingEngine(params, tc, EngineConfig(batch_size=2, ctx=16, **setting),
                          device="cpu")
    dense = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m")), dtype="float32")
    dparams = TAPI.init_model(dense, device="cpu", seed=0)
    assert ServingEngine(dparams, dense, EngineConfig(batch_size=2, ctx=16),
                         device="cpu").prefill_mode == "batch"
    assert ServingEngine(dparams, dense, EngineConfig(batch_size=2, ctx=16, prefill="step"),
                         device="cpu").prefill_mode == "step"


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------


def test_trainer_losses_match_jax_3_steps(tmp_path):
    steps = 3
    jc, tc = _cfgs()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jt = JC.TrainConfig(global_batch=4, seq_len=32, optim=JC.OptimConfig(**kw), log_every=10**6)
    tt = TC.TrainConfig(global_batch=4, seq_len=32, optim=TC.OptimConfig(**kw), log_every=10**6,
                        ckpt_dir=str(tmp_path), ckpt_every=10**6, async_ckpt=False)
    jp = _jax_params(jc, 1)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    src = JSyntheticLM(jc.vocab, 32, seed=0)
    jlosses = []
    for i in range(steps):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, src.batch(i, 4)))
        jlosses.append(float(m["loss"]))
    loader = ShardedLoader(SyntheticLM(tc.vocab, 32, seed=0), 4, torch.device("cpu"))
    trainer = Trainer(tc, tt, loader, device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)


def test_checkpoint_roundtrips_the_ssm_tree_in_the_jax_format(tmp_path):
    jc, tc = _cfgs(dtype="bfloat16")
    jp, _ = _params(jc, 2)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.asarray(7, jnp.int32)}
    # JAX writes, the port reads
    jm = JCheckpointManager(str(tmp_path / "jax"), async_save=False)
    jm.save(7, jstate)
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore_latest()
    state = state_from_host(tree, "cpu")
    assert step == 7 and int(state["step"]) == 7
    ssm = state["params"]["groups"][1]["mod"]["block"]["ssm"]
    assert ssm["w_x"].dtype == torch.bfloat16 and ssm["A_log"].dtype == torch.float32
    want = jax.tree.flatten(jax.tree.map(np.asarray, jp))[0]
    got = jax.tree.flatten(to_numpy_tree(state["params"]))[0]
    for a, b in zip(want, got):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(a, b)
    # the port writes, JAX reads
    CheckpointManager(str(tmp_path / "torch"), async_save=False).save(7, state_to_host(state))
    jstep_, jtree = JCheckpointManager(str(tmp_path / "torch")).restore_latest()
    assert jstep_ == 7
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jtree["params"]))
    wl, wdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    assert jdef == wdef
    for a, b in zip(jl, wl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
                                      b.view(np.uint16) if b.dtype.name == "bfloat16" else b)
