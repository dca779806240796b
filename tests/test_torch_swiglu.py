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

Torch runs on one thread in this module (ROADMAP Queue 3).
"""
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
