"""The port's mesh engine over several processes (CPU, gloo).

Each case spawns one process a rank (``torch.multiprocessing``), joined
through a ``FileStore`` under ``tmp_path`` (no port, so parallel test
workers never collide), one torch thread a rank. Held, as the JAX
package's gate (tests/test_routing_spmd.py) holds its 8-device mesh:

- on a (2, 2) mesh (data 2, model 2) over ``mod-paper-60m`` and
  ``olmoe-1b-7b`` at smoke size, f32, the served streams are token for
  token the single-process ``data_shards=2`` run (which
  tests/test_torch_spmd.py holds equal to JAX), the routed capacities are
  equal, and each rank's pool holds ``B/2`` slots and its kv heads, as
  ``cache_placement`` cuts them;
- on a (1, 2) mesh (tensor parallel), a decode step's logits are within
  1e-5 of the unsharded step's, with the same argmax and routed rows;
- the serving CLI under ``torchrun`` (``--spmd --model-axis 2``) prints
  its shard-local routing line.

This file imports no JAX: the spawned ranks import it.
"""
import dataclasses
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402
from torch import distributed as dist  # noqa: E402

from repro_torch import config as TC  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, CTX, N_REQ, GEN = 8, 24, 12, 8


def _cfg(arch):
    cfg = dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype="float32")
    return TC.with_mod_backend(cfg, "pallas")


def _prompts(vocab):
    rng = np.random.default_rng(3)  # distinct tokens a prompt: no routing ties
    return [rng.permutation(vocab)[:8] for _ in range(N_REQ)]


def _serve(cfg, params, **kw):
    eng = ServingEngine(params, cfg, EngineConfig(batch_size=B, ctx=CTX, **kw), device="cpu")
    with torch.no_grad():
        outs = eng.run_stream([Request(tokens=p, max_new_tokens=GEN)
                               for p in _prompts(cfg.vocab)], 2)
    return {o.uid: o.tokens.tolist() for o in outs}, eng


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store_path, fn, args, queue):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M

    try:
        M.init_process_group("gloo", rank=rank, world_size=world,
                             store=dist.FileStore(store_path, world))
        queue.put((rank, fn(*args), None))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails the test
        queue.put((rank, None, traceback.format_exc()))
    finally:
        M.destroy_process_group()


def _spawn(tmp_path, world, fn, *args):
    """``fn(*args)`` on every rank of a ``world``-rank gloo group; the
    ranks' results in rank order (a rank's exception fails the test)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp_path.mkdir(parents=True, exist_ok=True)
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = [queue.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [err for _, _, err in got if err is not None]
    assert not errors, errors[0]
    return [res for _, res, _ in sorted(got, key=lambda g: g[0])]


def _mesh_serve(arch, model_axis):
    """One rank's mesh run: streams, routed capacity, pool slots, and each
    pool leaf's shape beside the one ``cache_placement`` cuts."""
    from repro_torch.launch.mesh import auto_mesh
    from repro_torch.utils import tree_leaves

    cfg = _cfg(arch)
    mesh = auto_mesh(model_axis)
    params = api.init_model(cfg, device="cpu", seed=0)
    streams, eng = _serve(cfg, params, mesh=mesh)
    sizes = SH.mesh_sizes(mesh)
    full = api.make_caches(cfg, B, CTX, device="meta")
    want = []
    for keys, leaf in SH._leaves(full):
        spec = SH.cache_placement(SH._path(keys), leaf.shape, mesh, B)
        want.append(tuple(n // SH._axis_size(sizes, ax) for n, ax in zip(leaf.shape, spec)))
    got = [tuple(t.shape) for t in tree_leaves(eng.pool.caches)]
    return dict(streams=streams, kb=eng.scheduler.routed_capacity, rows=eng.pool.rows,
                row0=eng.pool.row0, shapes=got, placed=want, stats=eng.stats())


@pytest.mark.parametrize("arch", ["mod-paper-60m", "olmoe-1b-7b"])
def test_mesh_2x2_streams_equal_the_partitioned_reference(arch, tmp_path):
    cfg = _cfg(arch)
    ref, ref_eng = _serve(cfg, api.init_model(cfg, device="cpu", seed=0), data_shards=2)
    ranks = _spawn(tmp_path, 4, _mesh_serve, arch, 2)
    for r, got in enumerate(ranks):
        assert got["streams"] == ref, f"rank {r}: mesh decode diverged from data_shards=2"
        assert got["kb"] == ref_eng.scheduler.routed_capacity == 2
        assert got["rows"] == B // 2 and got["row0"] == (r // 2) * (B // 2)
        assert got["shapes"] == got["placed"]
        s = got["stats"]
        assert (s["data_shards"], s["model_shards"], s["routed_kb"]) == (2, 2, 2)
        assert s["mean_routed_frac"] == ref_eng.stats()["mean_routed_frac"]
    # the pool really is cut: slots over data, kv heads over model
    k_shape = ranks[0]["shapes"][0]
    assert k_shape[0] == B // 2 and k_shape[2] == cfg.attn.n_kv_heads // 2


def _tp_decode(arch, steps):
    """A (1, 2) mesh: ``steps`` decode steps on this rank's weight shards
    and kv heads (the logits gathered over the vocab)."""
    from repro_torch.launch.mesh import auto_mesh

    cfg = _cfg(arch)
    params, spmd = SH.shard_params(api.init_model(cfg, device="cpu", seed=0), cfg,
                                   SH.shard_ctx(auto_mesh(2)))
    caches = api.make_caches(SH.local_cache_config(cfg, spmd), B, CTX, device="cpu")
    return _decode_steps(params, caches, cfg, steps, spmd)


def _decode_steps(params, caches, cfg, steps, spmd=None):
    rng = np.random.default_rng(5)
    out = []
    with torch.no_grad():
        for i in range(steps):
            tok = torch.as_tensor(rng.permutation(cfg.vocab)[:B])[:, None]
            active = torch.as_tensor([True] * 6 + [i % 2 == 0, False])
            logits, caches, aux = api.model_decode(params, caches, cfg, tok,
                                                   torch.full((B,), i, dtype=torch.int32),
                                                   active, spmd=spmd)
            out.append((logits.numpy(), aux["mod/decode_routed"].numpy()))
    return out


def test_tensor_parallel_decode_within_1e5(tmp_path):
    """Dense and MoE on a (1, 2) mesh against the unsharded model."""
    for arch in ("mod-paper-60m", "olmoe-1b-7b"):
        cfg = _cfg(arch)
        params = api.init_model(cfg, device="cpu", seed=0)
        ref = _decode_steps(params, api.make_caches(cfg, B, CTX, device="cpu"), cfg, 4)
        for got in _spawn(tmp_path / arch, 2, _tp_decode, arch, 4):
            for (gl, gr), (rl, rr) in zip(got, ref):
                np.testing.assert_allclose(gl, rl, atol=1e-5, rtol=0)
                np.testing.assert_array_equal(gl.argmax(-1), rl.argmax(-1))
                np.testing.assert_array_equal(gr, rr)


def test_serve_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.serve", "--spmd", "--model-axis", "2", "--device",
           "cpu", "--smoke", "--batch", "4", "--requests", "6", "--prompt-len", "12",
           "--min-prompt-len", "6", "--gen", "4"]
    run = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "[serve] SPMD mesh: data=1 x model=2 (2 ranks, gloo, cpu)" in run.stdout
    assert "[serve] shard-local routing: data_shards=1 global kb=1" in run.stdout
