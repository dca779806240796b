"""Self-speculative rounds of the port's quantized engines against the JAX
engine (CPU, f32, ``tests/helpers.tiny_cfg``'s model, torch on one thread):
int8/page and fp8/head KV and int8 weights, each on the padded paged, the
prefix-cached and the ragged engine, requests submitted upfront. Greedy
streams equal the JAX engine's speculative streams and the port's own
non-speculative streams; the ``speculative_*`` stats,
``padded_token_fraction``, ``steps`` and the page books equal JAX's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tests.test_torch_paged import model_pair, shared_prefix_prompts  # noqa: E402
from tests.test_torch_speculative_engines import _check_against_jax_and_plain  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QUANTS = {"int8-page": ("int8", "page", "none"), "fp8-head": ("fp8", "head", "none"),
          "int8-weights": ("int8", "head", "int8")}
ENGINES = {
    "paged": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4),
    "prefix": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4, prefix_cache=True),
    "ragged": dict(batch_size=2, ctx=24, page_size=4, prefill_chunk=4, ragged=True,
                   ragged_segments=2),
}


@pytest.mark.parametrize("kind", list(ENGINES))
@pytest.mark.parametrize("quant", list(QUANTS))
def test_quantized_speculative_streams(quant, kind):
    """Each in-window row goes through the narrow dtype after its step, so
    later steps attend to what the plain engine reads back from its pages;
    the window scatter quantizes rows and scales together."""
    _check_against_jax_and_plain(shared_prefix_prompts(), [5, 3, 6, 4, 5], 0,
                                 quant=QUANTS[quant], spec=dict(speculate=3, draft_ratio=0.0),
                                 **ENGINES[kind])


def test_quant_speculative_matches_plain():
    """JAX ``tests/test_quant.py::test_quant_speculative_matches_plain`` on
    the port: int8 pages, the fused window (draft ratio == capacity)."""
    tc = model_pair(True)[2]
    prompts = list(np.random.default_rng(12).integers(0, 97, size=(3, 6)))
    _check_against_jax_and_plain(prompts, [10] * 3, quant=("int8", "page", "none"),
                                 batch_size=3, ctx=20, page_size=4, prefill_chunk=4,
                                 spec=dict(speculate=3, draft_ratio=tc.mod.capacity_ratio))
