"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch (the repository's ``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: gather/scatter are copies and exact updates, so bitwise; the
flash kernel sums its online softmax in another order than the dense plain
version (f32 atol 2e-5), and rounds p to bf16 against another running max
before p@V (bf16 atol and rtol 8e-3: one bf16 ulp of the output is at most
2^-7 of its value).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import routing as KR  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=8e-3, rtol=8e-3)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,D,k", [(1, 77, 96, 10), (3, 2048, 1792, 256), (2, 33, 5, 33)])
def test_routing_kernels_bitwise(dev, dtype, B, S, D, k):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, S, D, generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.sort(torch.randperm(S, generator=g, device=dev)[:k]).values
                       for _ in range(B)])
    delta = torch.randn(B, k, D, generator=g, device=dev).to(dtype)
    gate = torch.randn(B, k, generator=g, device=dev)
    build.reset_counters()
    assert torch.equal(KR.gather_rows(x, idx), KR.gather_rows_plain(x, idx))
    assert torch.equal(KR.scatter_add_rows(x, idx, delta, gate),
                       KR.scatter_add_rows_plain(x, idx, delta, gate))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["gather_rows"] == 1 and counts["scatter_add_rows"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Sq,Skv,nq,nkv,hd,causal,window",
    [
        (2, 45, 45, 4, 2, 64, True, 0),  # GQA, ragged edges
        (1, 300, 300, 14, 14, 128, True, 0),
        (8, 1, 1056, 14, 14, 128, True, 0),  # decode against a ring
        (2, 17, 70, 4, 4, 32, False, 0),
        (1, 64, 64, 2, 1, 256, True, 16),  # sliding window
    ],
)
def test_flash_attention_matches_plain(dev, dtype, B, Sq, Skv, nq, nkv, hd, causal, window):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, Sq, nq, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, nkv, hd, generator=g, device=dev).to(dtype)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    kv_pos[:, -3:] = -1  # empty slots / padded tail
    if Sq == Skv:
        q_pos = kv_pos.clone()
    else:
        q_pos = torch.randint(0, Skv, (B, Sq), generator=g, device=dev, dtype=torch.int32)
    build.reset_counters()
    got = FA.flash_attention(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 2, 48, device=dev)
    pos = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q, pos, pos)
    with pytest.raises(TypeError):
        KR.gather_rows(torch.zeros(1, 4, 8, device=dev), torch.zeros(1, 2, dtype=torch.int32,
                                                                         device=dev))
