"""The port's SwiGLU MLP op against the JAX package, on the CPU.

On CPU tensors ``repro_torch.kernels.swiglu.swiglu`` (re-exported as
``ops.swiglu_op``) runs its plain version. It is held against the Pallas
``swiglu`` kernel in interpret mode at the shapes and blockings of
``tests/test_kernels.py::test_swiglu_sweep``, with inputs made by numpy at
that test's scales:

- f32 within 2e-5 (JAX's tolerance for its kernel against ``ref``; the
  products sum in another order);
- bf16 within one bf16 ulp of the output's scale (2^-7 of the largest
  power of two at or below max|y|): the hidden is rounded once, to bf16,
  after ``silu(g)·u`` in f32, as the kernel does. The model's
  ``layers.mlp`` rounds g, u, silu(g) and the product each to bf16; the
  test shows that this rounding lands farther from the kernel;
- a shape the JAX wrapper rejects (M not a multiple of its 256-row block,
  F not a multiple of its 512 block), held to ``ref.swiglu_ref`` in f32.

It also holds what the CUDA wrappers of both MLP kernels decide before a
launch: ``gemm_path`` (the wgmma GEMM for aligned bf16 in multiples of 8,
the CUDA-core GEMM otherwise), that sizes no GEMM takes raise before any
build, and that the chosen path is what the C entry points receive.

Torch runs on one thread in this module (ROADMAP Queue 3).
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.swiglu import swiglu as jswiglu  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import swiglu as TSW  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def swiglu_case(M, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for shape, s in (((M, D), 0.5), ((D, F), 0.2), ((D, F), 0.2), ((F, D), 0.2))]


def _bf16_ulp(y: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M,D,F,bm,bf", [(64, 32, 128, 32, 64), (128, 64, 64, 64, 64)])
def test_swiglu_plain_matches_the_pallas_kernel(M, D, F, bm, bf, dt):
    arrs = swiglu_case(M, D, F)
    jargs = [jnp.asarray(a, JDT[dt]) for a in arrs]
    targs = [torch.as_tensor(a).to(TDT[dt]) for a in arrs]
    want = np.asarray(jswiglu(*jargs, block_m=bm, block_f=bf, interpret=True), np.float32)
    got = TOPS.swiglu_op(*targs)
    assert got.dtype == TDT[dt] and got.shape == (M, D)
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        return
    ulp = _bf16_ulp(want)
    err = np.abs(got - want).max()
    assert err <= ulp, (err, ulp)
    # layers.mlp's rounding points (each projection, the activation and the
    # product in bf16) are not the kernel's
    p = {"w_gate": targs[1], "w_up": targs[2], "w_down": targs[3]}
    mlp = TL.mlp_act(p, targs[0], "silu").float().numpy()
    assert np.abs(mlp - want).max() > err
    assert np.abs(mlp - want).mean() > 2 * np.abs(got - want).mean()


def test_swiglu_takes_shapes_the_jax_wrapper_rejects():
    M, D, F = 300, 32, 600  # M % 256 != 0, F % 512 != 0
    arrs = swiglu_case(M, D, F, seed=1)
    jargs = [jnp.asarray(a) for a in arrs]
    with pytest.raises(AssertionError):
        jswiglu(*jargs, interpret=True)
    got = TSW.swiglu(*(torch.as_tensor(a) for a in arrs)).numpy()
    np.testing.assert_allclose(got, np.asarray(JREF.swiglu_ref(*jargs)), atol=2e-5, rtol=0)


def test_swiglu_refuses_what_it_does_not_take():
    x, wg, wu, wd = (torch.as_tensor(a) for a in swiglu_case(8, 4, 6))
    with pytest.raises(ValueError, match="gradient"):
        TSW.swiglu(x.requires_grad_(True), wg, wu, wd)
    with pytest.raises(ValueError, match="w_down"):
        TSW.swiglu(x.detach(), wg, wu, wd.T)
    with pytest.raises(TypeError, match="one dtype"):
        TSW.swiglu(x.detach(), wg.bfloat16(), wu, wd)


# ---------------------------------------------------------------------------
# The GEMM each MLP kernel runs its products on: a pure function of the
# dtype, the shape and the alignment, decided before launch (the kernels
# themselves run only on a GPU: tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,N,K", [(1, 8, 8), (63, 200, 136), (1000, 1792, 7168),
                                   (8192, 7168, 1792)])
def test_gemm_path_takes_wgmma_for_aligned_bf16_in_multiples_of_8(M, N, K):
    assert TSW.gemm_path(torch.bfloat16, M, N, K, True) == "wgmma"
    assert TSW.gemm_path(torch.bfloat16, M, K, N, True) == "wgmma"  # a kernel's other product


@pytest.mark.parametrize("dtype,M,N,K,aligned", [
    (torch.float32, 1024, 7168, 1792, True),  # f32 keeps the CUDA cores
    (torch.bfloat16, 64, 130, 64, True),  # N not a multiple of 8
    (torch.bfloat16, 64, 64, 44, True),  # K not a multiple of 8
    (torch.bfloat16, 1024, 7168, 1792, False),  # a base off 16 bytes
    (torch.bfloat16, 0, 64, 64, True),  # empty products: TMA takes no zero-size tensor
    (torch.bfloat16, 8, 0, 64, True),
    (torch.bfloat16, 8, 64, 0, True),
])
def test_gemm_path_takes_the_cuda_cores_otherwise(dtype, M, N, K, aligned):
    assert TSW.gemm_path(dtype, M, N, K, aligned) == "cuda_cores"


@pytest.mark.parametrize("dtype,M,N,K,err", [
    (torch.float16, 8, 64, 64, TypeError),
    (torch.bfloat16, -1, 64, 64, ValueError),
    (torch.bfloat16, 2 ** 31, 64, 64, ValueError),  # beyond the C entry points' int
])
def test_gemm_path_raises_for_what_no_gemm_takes(dtype, M, N, K, err):
    with pytest.raises(err):
        TSW.gemm_path(dtype, M, N, K, True)


def test_aligned_reads_the_bases_the_kernel_is_given():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert TSW.bases_aligned(base, base[8:])  # 16 bytes in
    assert not TSW.bases_aligned(base[1:])  # 2 bytes in, and contiguous: passed as it is
    assert TSW.bases_aligned(base.view(8, 8)[:, 1:])  # not contiguous: copied to a new buffer


def _no_build(monkeypatch):
    def no_build(*args):
        raise AssertionError("a kernel was built for a shape no GEMM takes")

    monkeypatch.setattr(TSW.build, "bind", no_build)
    monkeypatch.setattr(TSW.build, "build_all", no_build)


def test_mlp_launches_refuse_sizes_before_any_build(monkeypatch):
    """A size beyond the C int raises in gemm_path, before a copy, a buffer
    or a build (stride-0 views: nothing of that size exists)."""
    _no_build(monkeypatch)
    big = 2 ** 31
    x = torch.zeros(1, 64, dtype=torch.bfloat16).expand(big, 64)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="GEMM sizes"):
        TSW._swiglu_launch(x, w, w, w)
    xs = torch.zeros(1, 4, 64, dtype=torch.bfloat16).expand(big, 4, 64)
    rows = torch.zeros(1, 1, 64, dtype=torch.bfloat16).expand(big, 1, 64)
    idx = torch.zeros(1, 1, dtype=torch.long).expand(big, 1)
    gate = torch.zeros(1, 1).expand(big, 1)
    params = {"ln": torch.ones(64, dtype=torch.bfloat16), "w_up": w, "w_down": w}
    with pytest.raises(ValueError, match="GEMM sizes"):
        TSW._routed_mlp_launch(xs, rows, rows, idx, gate, params, TSW.RoutedMlpSpec("silu", 1e-5))


class _FakeEntry:
    """Stands in for a C entry point: records its arguments, returns 0."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("dtype,offset,want", [(torch.bfloat16, 0, "wgmma"),
                                               (torch.bfloat16, 1, "cuda_cores"),
                                               (torch.float32, 0, "cuda_cores")])
def test_mlp_wrappers_pass_the_gemm_path_to_the_entry_point(monkeypatch, dtype, offset, want):
    """The path gemm_path chose is the argument the C entry points get, and
    the launch counters record it by call."""
    entry = _FakeEntry()
    monkeypatch.setattr(TSW.build, "bind", lambda *a: entry)
    monkeypatch.setattr(TSW.build, "check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: type("S", (), {"cuda_stream": 0}))
    M, D, F = 5, 16, 24
    buf = torch.zeros(offset + D * F, dtype=dtype)
    wg = buf[offset:].view(D, F)  # contiguous; 2 or 4 bytes in when offset is 1
    x, wu = torch.zeros(M, D, dtype=dtype), torch.zeros(D, F, dtype=dtype)
    wd = torch.zeros(F, D, dtype=dtype)
    TSW.build.reset_counters()
    TSW._swiglu_launch(x, wg, wu, wd)
    assert entry.args[-2] == TSW.GEMM_PATHS[want]  # (..., M, D, F, dtype, path, stream)
    assert TSW.SWIGLU.by_call == {(want, M, D, F): 1}
    B, S, k = 2, 6, 3
    xs = torch.zeros(B, S, D, dtype=dtype)
    rows = torch.zeros(B, k, D, dtype=dtype)
    idx = torch.tensor([[0, 2, 4], [1, 3, 5]])
    params = {"ln": torch.ones(D, dtype=dtype), "w_up": wu, "w_down": wd, "w_gate": wg}
    TSW._routed_mlp_launch(xs, rows, rows, idx, torch.zeros(B, k), params,
                           TSW.RoutedMlpSpec("silu", 1e-5))
    assert entry.args[-3] == TSW.GEMM_PATHS[want]  # (..., act, path, eps, stream)
    assert TSW.ROUTED_MLP_SCATTER.by_call == {(want, B, S, k, D, F): 1}
    TSW.build.reset_counters()


def test_routed_mlp_library_figure_is_the_plain_version():
    """chip_smoke's library yardstick for routed_mlp_scatter computes the
    plain version's function (f32 on the CPU: the sums in other orders)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import routed_mlp_library

    rng = np.random.default_rng(4)
    B, S, k, D, F = 2, 12, 5, 16, 24
    x, h, a = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, D), (B, k, D), (B, k, D)))
    idx = torch.as_tensor(np.sort(np.stack([rng.permutation(S)[:k] for _ in range(B)]), axis=1))
    gate = torch.as_tensor(rng.standard_normal((B, k)).astype(np.float32))
    for glu, act in ((True, "silu"), (False, "gelu")):
        p = {"ln": torch.as_tensor(1 + 0.1 * rng.standard_normal(D).astype(np.float32)),
             "w_up": torch.as_tensor(rng.standard_normal((D, F)).astype(np.float32) / 4),
             "w_down": torch.as_tensor(rng.standard_normal((F, D)).astype(np.float32) / 4)}
        if glu:
            p["w_gate"] = torch.as_tensor(rng.standard_normal((D, F)).astype(np.float32) / 4)
        spec = TSW.RoutedMlpSpec(act, 1e-5)
        want = TSW.routed_mlp_scatter_plain(x, h, a, idx.long(), gate, p, spec)
        got = routed_mlp_library(x, h, a, idx.long(), gate, p, spec)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
