"""The port's kernels against the JAX package's Pallas kernels (CPU).

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX function on the same inputs:

- ``gather_rows`` / ``scatter_add_rows`` against the Pallas kernels in
  interpret mode and the ``kernels/ref.py`` oracles, bit for bit, in f32
  and bf16, over capacity ratios and sequence lengths that leave a ragged
  tail in the Pallas S-blocking;
- ``flash_attention`` against the Pallas kernel in interpret mode at
  divisible shapes, and against the model's dense ``attend`` on valid
  query rows (atol 1e-5 in f32: the two sum in different orders). Padded
  query rows are left out of the ``attend`` comparison on purpose: with
  no valid key the kernel gives 0 and ``attend`` the mean of V, and
  neither reaches a valid row or a logit.

The CUDA kernels themselves run only on a GPU: tests/test_torch_gpu.py
holds each against its plain version there and skips elsewhere. What the
flash wrapper decides before a launch is tested here: ``flash_plan``'s
path and key split (a function of the dtype, Sq, nq/nkv and the head dim
alone), its decode splits at fixed key indices, the merge launch and its
scratch only past one chunk, that the C entry point gets that plan and
the launch counter records it by call, and that shapes the kernel does
not take raise before anything is built.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.routing import gather_rows as j_gather  # noqa: E402
from repro.kernels.routing import scatter_add_rows as j_scatter  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import routing as TKR  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a):
    """Raw bit pattern of a jax/numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


def _routing_case(ratio, S, dtype, B=2, D=24, seed=0):
    rng = np.random.default_rng(seed)
    k = max(1, int(round(ratio * S)))
    x = rng.standard_normal((B, S, D)).astype(np.float32).astype(dtype)
    idx = np.sort(np.stack([rng.choice(S, k, replace=False) for _ in range(B)]), axis=1)
    delta = rng.standard_normal((B, k, D)).astype(np.float32).astype(dtype)
    gate = rng.standard_normal((B, k)).astype(np.float32)
    return x, idx.astype(np.int32), delta, gate


CASES = [(r, S) for r in (0.125, 0.5, 1.0) for S in (32, 37)]


@pytest.mark.parametrize("ratio,S", CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gather_rows_plain_bitwise_vs_pallas(ratio, S, dt):
    x, idx, _, _ = _routing_case(ratio, S, DTYPES[dt][0])
    want = j_gather(jnp.asarray(x), jnp.asarray(idx), interpret=True, block_s=16)
    oracle = JREF.gather_rows_ref(jnp.asarray(x), jnp.asarray(idx))
    got = TKR.gather_rows(_to_torch(x), torch.as_tensor(idx).long())
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


@pytest.mark.parametrize("ratio,S", CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_scatter_add_rows_plain_bitwise_vs_pallas(ratio, S, dt):
    x, idx, delta, gate = _routing_case(ratio, S, DTYPES[dt][0], seed=1)
    args = (jnp.asarray(x), jnp.asarray(idx), jnp.asarray(delta), jnp.asarray(gate))
    want = j_scatter(*args, interpret=True, block_s=16)
    oracle = JREF.scatter_add_rows_ref(*args)
    got = TKR.scatter_add_rows(_to_torch(x), torch.as_tensor(idx).long(), _to_torch(delta),
                               torch.as_tensor(gate))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


def _attn_case(B, Sq, Skv, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, nkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "B,Sq,Skv,nq,nkv,hd,causal",
    [
        (2, 64, 64, 4, 2, 32, True),  # GQA
        (1, 64, 64, 2, 2, 16, True),
        (2, 32, 64, 4, 4, 32, False),
    ],
)
def test_flash_attention_plain_vs_pallas(B, Sq, Skv, nq, nkv, hd, causal):
    q, k, v = _attn_case(B, Sq, Skv, nq, nkv, hd)
    qp = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    qp[:, -5:] = -1  # padded query tail
    kp[:, -7:] = -1  # empty cache slots
    want = j_flash(*map(jnp.asarray, (q, k, v, qp, kp)), causal=causal,
                   block_q=32, block_kv=32, interpret=True)
    got = TFA.flash_attention(*map(torch.as_tensor, (q, k, v, qp, kp)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("Sq,Skv,nq,nkv", [(1, 37, 4, 2), (13, 13, 4, 4), (29, 50, 4, 1)])
def test_flash_attention_plain_vs_attend_on_valid_rows(Sq, Skv, nq, nkv):
    """Ragged shapes, routed (non-contiguous) positions, a decode query
    against a ring with empty slots."""
    cfg = dataclasses.replace(JC.smoke_config(JC.get_config("mod-paper-60m")), dtype="float32")
    B, hd = 2, 32
    q, k, v = _attn_case(B, Sq, Skv, nq, nkv, hd, seed=2)
    rng = np.random.default_rng(3)
    kp = np.sort(rng.choice(200, (B, Skv), replace=False), axis=1).astype(np.int32)
    kp[:, rng.choice(Skv, Skv // 4, replace=False)] = -1
    qp = np.sort(rng.choice(200, (B, Sq), replace=False), axis=1).astype(np.int32)
    if Sq == Skv:
        qp = np.where(kp >= 0, kp, -1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = JA.attend(jq, jk, jv, JA.make_mask(jnp.asarray(qp), jnp.asarray(kp), True), cfg)
    want = np.asarray(want).reshape(B, Sq, nq, hd)
    got = TFA.flash_attention(*map(torch.as_tensor, (q, k, v, qp, kp)), causal=True).numpy()
    has_key = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])).any(-1) & (qp >= 0)
    assert has_key.any()
    np.testing.assert_allclose(got[has_key], want[has_key], atol=1e-5)
    np.testing.assert_array_equal(got[~has_key], 0.0)  # the kernel's masked-row value


def test_wrappers_count_no_launch_on_the_cpu():
    build.reset_counters()
    x = torch.zeros(1, 8, 4)
    TKR.gather_rows(x, torch.zeros(1, 2, dtype=torch.long))
    assert build.launch_counts()["gather_rows"] == 0


def test_launch_counter_counts_by_call():
    """A wrapper may count its launches by a key beside the total (flash:
    path and call shape); a reset clears both."""
    c = build.LaunchCounter("probe")
    c.add(("tile", 1, 65, 65))
    c.add(("decode", 8, 1, 1056))
    c.add(("decode", 8, 1, 1056))
    c.add()
    assert c.launches == 4
    assert c.by_call == {("tile", 1, 65, 65): 1, ("decode", 8, 1, 1056): 2}
    c.reset()
    assert c.launches == 0 and c.by_call == {}


def test_flash_call_reads_the_lse_the_function_saves():
    """chip_smoke's training-call helper: through the public wrapper, lse is
    the f32 row log-sum-exp the autograd Function saves for its backward
    (here the plain version's), and None where no gradient is needed."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import flash_call

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 4, 32, generator=g) for _ in range(3))
    pos = torch.arange(9, dtype=torch.int32)[None].repeat(2, 1)
    want, want_l = TFA._flash_plain(q, k, v, pos, pos, True, 0, 32 ** -0.5)
    out, lse = flash_call(TFA, q, k, v, pos, pos)
    assert lse is None and torch.equal(out, want)
    out, lse = flash_call(TFA, *(t.clone().requires_grad_() for t in (q, k, v)), pos, pos)
    assert torch.equal(out.detach(), want) and torch.equal(lse, want_l)



# ---------------------------------------------------------------------------
# The CUDA wrapper's plan (a pure function of the shapes; the kernels
# themselves run only on a GPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_decode_splits_fall_at_fixed_key_indices(hd):
    """The decode path splits the keys into chunks of a fixed number of key
    indices, a multiple of the key tile, whatever Skv is, and each chunk
    into DECODE_WARPS fixed quarters, one per warp; past one chunk a second
    launch merges one scratch row of partial (m, l, acc) per (batch row, kv
    head, split, tile row), and a row whose keys fit one chunk is written
    by the chunk's own launch (no merge, no scratch)."""
    chunk = TFA.decode_chunk(hd)
    assert chunk % TFA.key_tile(hd) == 0
    for Skv in (1, chunk - 1, chunk, chunk + 1, 1056, 4097):
        plan = TFA.flash_plan(3, 2, Skv, 14, 2, hd, torch.bfloat16)
        assert plan.path == "decode" and plan.chunk == chunk
        assert (plan.key_split, plan.key_tile) == (TFA.DECODE_WARPS, chunk // TFA.DECODE_WARPS)
        bounds = [i * plan.chunk for i in range(plan.n_splits)]
        assert bounds[-1] < Skv <= bounds[-1] + chunk  # the chunks cover the keys, none empty
        assert plan.merge == (plan.n_splits > 1) and plan.kernels == 1 + plan.merge
        if plan.merge:
            assert plan.scratch == ((3, 2, plan.n_splits, 14),) * 2 + (
                (3, 2, plan.n_splits, 14, hd),)
        else:
            assert plan.n_splits == 1 and plan.scratch == ()


def _tile_path(hd):
    return "wgmma" if hd in TFA.WGMMA_HEAD_DIMS else "mma_sync"


def test_flash_path_depends_only_on_sq_and_group():
    """bf16: the decode path exactly when Sq * nq/nkv rows fit one 16-row mma
    tile, else a tile path by head dim (wgmma for 64 and 128, mma.sync for
    32 and 256); f32: its own kernel. The path and its key split are never
    a function of Skv or B."""
    for Sq in (1, 2, 3, 8, 9, 15, 16, 17, 65, 300):
        for nq, nkv in ((14, 14), (8, 4), (14, 2), (4, 1)):
            for hd in (32, 64, 128, 256):
                plans = {TFA.flash_plan(B, Sq, Skv, nq, nkv, hd, torch.bfloat16)[:3]
                         for B in (1, 8) for Skv in (1, 50, 1056, 5000)}
                path = "decode" if Sq * (nq // nkv) <= TFA.DECODE_ROWS else _tile_path(hd)
                assert {plan[0] for plan in plans} == {path} and len(plans) == 1
            assert TFA.flash_plan(2, Sq, 99, nq, nkv, 64, torch.float32).path == "f32"
    assert TFA.flash_plan(8, 1, 1056, 14, 14, 128, torch.bfloat16).path == "decode"
    assert TFA.flash_plan(1, 1000, 1000, 14, 14, 128, torch.bfloat16).path == "wgmma"


@pytest.mark.parametrize("hd,path,key_tile,key_split", [
    (32, "mma_sync", 64, 1),  # 64-byte rows: half a 128-byte swizzle atom
    (64, "wgmma", 128, 2),
    (128, "wgmma", 128, 2),  # mod-paper-1b
    (256, "mma_sync", 32, 1),  # O and S do not fit a consumer's registers
])
def test_flash_tile_path_by_head_dim(hd, path, key_tile, key_split):
    """The tile paths: wgmma takes head dims 64 and 128, with two consumer
    warpgroups splitting a query tile's key tiles by parity; the others go
    to the mma.sync tiles, unsplit. Neither merges through scratch."""
    plan = TFA.flash_plan(4, 2048, 2048, 14, 14, hd, torch.bfloat16)
    assert (plan.path, plan.key_tile, plan.key_split) == (path, key_tile, key_split)
    assert (plan.chunk, plan.n_splits, plan.merge, plan.scratch, plan.kernels) == (0, 0, False,
                                                                                   (), 1)


class _FakeEntry:
    """Stands in for the C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("B,Sq,Skv,nq,nkv,hd,dtype", [
    (1, 1, 128, 14, 14, 128, torch.bfloat16),  # decode in one chunk: one launch
    (8, 1, 1056, 14, 14, 128, torch.bfloat16),  # decode over 9 chunks: chunks + merge
    (1, 1000, 1000, 14, 14, 128, torch.bfloat16),  # wgmma
    (2, 65, 65, 4, 4, 256, torch.bfloat16),  # mma.sync
    (2, 9, 9, 4, 4, 64, torch.float32),
])
def test_flash_passes_its_plan_to_the_entry_point(monkeypatch, B, Sq, Skv, nq, nkv, hd, dtype):
    """The plan flash_plan made is what the C entry point gets (path code,
    key tile, split, chunk, chunk count, merge, and scratch only when it
    merges), and the launch counter records it by call with the call's
    kernel launches."""
    entry = _FakeEntry()
    monkeypatch.setattr(build, "bind", lambda *a: entry)
    monkeypatch.setattr(build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    q = torch.zeros(B, Sq, nq, hd, dtype=dtype)
    kv = torch.zeros(B, Skv, nkv, hd, dtype=dtype)
    pos = torch.zeros(B, Sq, dtype=torch.int32)
    kpos = torch.zeros(B, Skv, dtype=torch.int32)
    build.reset_counters()
    TFA._flash_launch(q, kv, kv, pos, kpos, True, 0, 1.0, False)
    plan = TFA.flash_plan(B, Sq, Skv, nq, nkv, hd, dtype)
    # (q, k, v, q_pos, kv_pos, out, lse, part_m, part_l, part_acc, B, Sq, Skv, nq, nkv, hd,
    #  dtype, path, key_tile, key_split, chunk, n_splits, merge, scale, causal, window, stream)
    assert entry.args[10:23] == (B, Sq, Skv, nq, nkv, hd, TFA._DTYPES[dtype],
                                 TFA._PATHS[plan.path], plan.key_tile, plan.key_split,
                                 plan.chunk, plan.n_splits, int(plan.merge))
    assert all(a is None for a in entry.args[7:10]) == (not plan.merge)
    assert TFA.FLASH_ATTENTION.by_call == {(plan.path, B, Sq, Skv, nq, nkv, hd, plan.kernels): 1}
    build.reset_counters()


@pytest.mark.parametrize("shape,dtype,err", [
    ((1, 4, 8, 2, 2, 48), torch.bfloat16, ValueError),  # head dim
    ((1, 4, 8, 6, 4, 64), torch.bfloat16, ValueError),  # nq not a multiple of nkv
    ((1, 4, 8, 2, 2, 64), torch.float16, TypeError),
    ((70000, 1, 8, 2, 2, 64), torch.bfloat16, ValueError),  # beyond the grid's batch axis
])
def test_flash_launch_refuses_shapes_before_any_build(monkeypatch, shape, dtype, err):
    B, Sq, Skv, nq, nkv, hd = shape
    with pytest.raises(err):
        TFA.flash_plan(B, Sq, Skv, nq, nkv, hd, dtype)

    def no_build(*args):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "bind", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    # a batch this large as stride-0 views: the plan sees only the shape
    q = torch.zeros(1, Sq, nq, hd, dtype=dtype).expand(B, -1, -1, -1)
    kv = torch.zeros(1, Skv, nkv, hd, dtype=dtype).expand(B, -1, -1, -1)
    pos = torch.zeros(B, Sq, dtype=torch.int32)
    kpos = torch.zeros(B, Skv, dtype=torch.int32)
    with pytest.raises(err):
        TFA._flash_launch(q, kv, kv, pos, kpos, True, 0, 1.0, False)
