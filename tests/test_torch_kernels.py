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
holds each against its plain version there and skips elsewhere.
"""
import dataclasses

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

