"""The port's GPipe pipeline and int8 compressed all-reduce against the JAX
package (CPU, gloo).

- ``bubble_fraction`` at JAX's three values;
- ``pipeline_forward`` over 4 gloo ranks (one stage a rank, 8
  microbatches) within 1e-6 of the sequential stages and of JAX's
  ``pipeline_forward`` on 4 forced host devices (a subprocess, as
  tests/test_pipeline.py runs it);
- ``compressed_all_reduce`` over the same 4 ranks: the mean and the new
  error feedback **bitwise** JAX's ``compressed_psum`` under ``shard_map``
  on the same inputs (a carried error included).

Ranks are spawned as tests/test_torch_mesh.py spawns them (a FileStore
under ``tmp_path``, one torch thread a rank); they import no JAX.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.pipeline import bubble_fraction  # noqa: E402
from tests.test_torch_mesh import _spawn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_STAGES, N_MICRO, B, D = 4, 8, 2, 8
PIPE_TOL = 1e-6


def _inputs():
    """The pipeline's stage weights, biases and microbatches, and the
    compressed reduction's gradients and carried errors (one row a rank),
    from one numpy seed."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(
        W=(rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(f32),
        b=(rng.standard_normal((N_STAGES, D)) * 0.1).astype(f32),
        x=rng.standard_normal((N_MICRO, B, D)).astype(f32),
        g={"a": rng.standard_normal((N_STAGES, 16)).astype(f32),
           "b": (rng.standard_normal((N_STAGES, 3, 5)) * 1e-3).astype(f32)},
        e={"a": (rng.standard_normal((N_STAGES, 16)) * 1e-2).astype(f32),
           "b": np.zeros((N_STAGES, 3, 5), f32)},
    )


JAX_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.distributed.pipeline import pipeline_forward
    from repro.optim.compression import compressed_psum

    data = np.load(sys.argv[1])
    try:
        from jax.sharding import AxisType
        mesh = jax.make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
    except ImportError:
        mesh = jax.make_mesh((4,), ("pod",))

    def stage_fn(p, h, idx):
        return jnp.tanh(h @ p["W"] + p["b"])

    pipe = pipeline_forward(stage_fn, {"W": jnp.asarray(data["W"]), "b": jnp.asarray(data["b"])},
                            jnp.asarray(data["x"]), mesh, axis="pod")

    def reduce_fn(ga, gb, ea, eb):
        avg, new_e = compressed_psum({"a": ga[0], "b": gb[0]}, "pod", {"a": ea[0], "b": eb[0]})
        return avg["a"][None], avg["b"][None], new_e["a"][None], new_e["b"][None]

    fn = shard_map(reduce_fn, mesh=mesh, in_specs=(P("pod"),) * 4, out_specs=(P("pod"),) * 4,
                   check_rep=False)
    outs = fn(*(jnp.asarray(data[k]) for k in ("g_a", "g_b", "e_a", "e_b")))
    np.savez(sys.argv[2], pipe=np.asarray(pipe),
             **{k: np.asarray(v) for k, v in zip(("avg_a", "avg_b", "err_a", "err_b"), outs)})
    print(json.dumps({"ok": True}))
    """
)


def _jax_reference(inp, tmp_path):
    src, dst = tmp_path / "inputs.npz", tmp_path / "jax.npz"
    np.savez(src, W=inp["W"], b=inp["b"], x=inp["x"], g_a=inp["g"]["a"], g_b=inp["g"]["b"],
             e_a=inp["e"]["a"], e_b=inp["e"]["b"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(src), str(dst)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


def _rank_pipeline_and_compression(inp):
    """One rank: its pipeline stage over the world group, then its row of
    the gradients through ``compressed_all_reduce``."""
    import torch.distributed as dist

    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.optim.compression import compressed_all_reduce

    group, r = dist.group.WORLD, dist.get_rank()

    def stage_fn(p, h, idx):
        return torch.tanh(h @ p["W"] + p["b"])

    params = {"W": torch.as_tensor(inp["W"][r]), "b": torch.as_tensor(inp["b"][r])}
    pipe = pipeline_forward(stage_fn, params, torch.as_tensor(inp["x"]), group)
    grads = [torch.as_tensor(inp["g"][k][r]) for k in ("a", "b")]
    errs = [torch.as_tensor(inp["e"][k][r]) for k in ("a", "b")]
    avg, new_e = compressed_all_reduce(grads, group, errs)
    return dict(pipe=pipe.numpy(), avg=[a.numpy() for a in avg], err=[e.numpy() for e in new_e])


@pytest.mark.parametrize("n_micro,n_stages,want", [(1, 4, 0.75), (8, 4, 3 / 11), (8, 1, 0.0)])
def test_bubble_fraction_matches_jax(n_micro, n_stages, want):
    # imported here: the spawned ranks import this module, and need no JAX
    from repro.distributed.pipeline import bubble_fraction as jax_bubble_fraction

    assert bubble_fraction(n_micro, n_stages) == want
    assert bubble_fraction(n_micro, n_stages) == jax_bubble_fraction(n_micro, n_stages)


def test_pipeline_and_compressed_all_reduce_match_jax(tmp_path):
    inp = _inputs()
    ranks = _spawn(tmp_path / "ranks", N_STAGES, _rank_pipeline_and_compression, inp)
    ref = _jax_reference(inp, tmp_path)
    seq = torch.as_tensor(inp["x"])
    for i in range(N_STAGES):
        seq = torch.tanh(seq @ torch.as_tensor(inp["W"][i]) + torch.as_tensor(inp["b"][i]))
    for r, got in enumerate(ranks):
        # every stage holds the last stage's outputs
        np.testing.assert_allclose(got["pipe"], seq.numpy(), atol=PIPE_TOL, rtol=0)
        np.testing.assert_allclose(got["pipe"], ref["pipe"], atol=PIPE_TOL, rtol=0)
        for j, k in enumerate(("a", "b")):
            np.testing.assert_array_equal(got["avg"][j], ref[f"avg_{k}"][r], err_msg=f"rank {r}")
            np.testing.assert_array_equal(got["err"][j], ref[f"err_{k}"][r], err_msg=f"rank {r}")
    # the compressed mean is near the true mean (a quantization bin of the max)
    for j, k in enumerate(("a", "b")):
        g = inp["g"][k] + inp["e"][k]
        scale = np.abs(g).max() / 127.0
        assert np.abs(ranks[0]["avg"][j] - g.mean(axis=0)).max() < 4 * scale


def test_quantize_int8_matches_jax():
    import jax.numpy as jnp

    from repro.optim.compression import dequantize_int8 as jdequant
    from repro.optim.compression import quantize_int8 as jquant
    from repro_torch.optim.compression import dequantize_int8, quantize_int8

    x = np.random.default_rng(3).standard_normal((7, 33)).astype(np.float32) * 3e-2
    q, scale = quantize_int8(torch.as_tensor(x))
    jq, jscale = jquant(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(), np.asarray(jdequant(jq, jscale)))
