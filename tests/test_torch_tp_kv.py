"""Tensor-parallel training with kv heads shared by ranks and with tied
embeddings, and serving over a pod axis: four gloo ranks (CPU) against the
JAX package.

One 4-rank spawn holds, on every rank:

- on the mesh (1, 4), a dense smoke model (``mod-paper-60m``, 2 layers,
  f32) at 8 query / 2 kv heads (ranks {0, 1} hold kv head 0, {2, 3} head
  1), at 8 / 1 (MQA: every rank the one head) and with
  ``tie_embeddings=True`` (the table D-split, the logits summed over the
  ranks): the loss within 1e-5 of JAX's, each gradient leaf within 2e-5
  of the leaf's largest |grad| (a shared K/V leaf holds its heads' whole
  gradient, summed over the ranks that hold them), and two steps of clip,
  cosine LR and AdamW as tests/test_torch_mesh_train.py holds them (the
  clip norm counts each kv head once);
- a checkpoint saved on (1, 4) at 8 / 2 (each kv head gathered once)
  resuming in one process with the same next loss;
- on the mesh ("pod", "data", "model") = (2, 1, 2), the engine's greedy
  streams equal to the JAX engine's at ``data_shards=2``, the slots cut
  pod-major.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as TC  # noqa: E402
from repro_torch.train import loop as L  # noqa: E402
from tests.test_torch_mesh_train import (  # noqa: E402
    LOSS_RTOL,
    _collect,
    _ctx,
    _local,
    _one_mesh,
    _start,
    _tcfg,
)
from tests.test_torch_tp_families import (  # noqa: E402
    SERVE_B,
    case_batch,
    case_config,
    check_loss_and_grads,
    check_steps,
    host_tree,
    jax_init,
    jax_run,
    jax_streams,
    mesh_streams,
)

DENSE = "mod-paper-60m"
# name -> (attn fields, other config fields) of a (1, 4) case
CASES = {"gqa 8/2": ((("n_heads", 8), ("n_kv_heads", 2)), {}),
         "mqa 8/1": ((("n_heads", 8), ("n_kv_heads", 1)), {}),
         "tied": ((), {"tie_embeddings": True})}
CKPT_CASE = "gqa 8/2"


def _case(name):
    attn, kw = CASES[name]
    return attn or None, kw


def _port_cfg(name):
    attn, kw = _case(name)
    return case_config(TC, DENSE, dict(attn) if attn else None, **kw)


def _checkpoint(ckdir, batch):
    """One step on (1, 4) from a fresh init, saved (every rank gathers, rank
    0 writes), then the next step's loss."""
    from repro_torch.checkpoint import CheckpointManager

    cfg = _port_cfg(CKPT_CASE)
    spmd = _ctx(1, 4)
    trainer = L.Trainer(cfg, _tcfg(), None, ckpt=CheckpointManager(ckdir, async_save=False),
                        device="cpu", spmd=spmd, log_fn=lambda s: None)
    state = trainer.init_or_resume()
    local = _local(batch, spmd)
    state, _ = trainer.step_fn(state, local)
    trainer.save(state, wait=True)
    torch.distributed.barrier()
    state, metrics = trainer.step_fn(state, local)
    return int(state["step"]), float(metrics["loss"])


def _rank(trees, batches, ckdir):
    out = {}
    spmd = _ctx(1, 4)
    for name in CASES:
        out[name] = _one_mesh(_port_cfg(name), spmd, trees[name], batches[name])
    out["checkpoint"] = _checkpoint(ckdir, batches[CKPT_CASE])
    pod = _ctx(1, 2, pod=2)
    out["pod"] = dict(coords=pod.coords(), data_rank=pod.data_rank,
                      **mesh_streams(case_config(TC, DENSE), trees["pod"], pod.mesh))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of the 4-rank spawn, and the checkpoint
    directory; the JAX references compile while the ranks run."""
    trees = {name: host_tree(jax_init(DENSE, *_case(name)[:1], **_case(name)[1])[1])
             for name in CASES}
    trees["pod"] = host_tree(jax_init(DENSE)[1])
    batches = {name: case_batch(jax_init(DENSE, *_case(name)[:1], **_case(name)[1])[0])
               for name in CASES}
    base = tmp_path_factory.mktemp("tp_kv")
    ckdir = str(base / "ckpt")
    started = _start(base, 4, _rank, trees, batches, ckdir)
    for name in CASES:
        attn, kw = _case(name)
        jax_run(DENSE, attn, **kw)
    jax_streams(DENSE, data_shards=2)
    return dict(ranks=_collect(*started), ckdir=ckdir, batches=batches)


@pytest.mark.parametrize("name", list(CASES))
def test_tp4_loss_and_grads_match_jax(runs, name):
    attn, kw = _case(name)
    for r, ranks in enumerate(runs["ranks"]):
        check_loss_and_grads(ranks[name], jax_run(DENSE, attn, **kw), _port_cfg(name), 4, r)


@pytest.mark.parametrize("name", list(CASES))
def test_tp4_train_steps_match_jax(runs, name):
    attn, kw = _case(name)
    for r, ranks in enumerate(runs["ranks"]):
        check_steps(ranks[name], jax_run(DENSE, attn, **kw), _port_cfg(name), 4, r)


def test_tp4_kv_state_holds_each_head_once(runs):
    """A rank's state holds its kv head only (the placement's bytes), the
    same on the ranks that share a head and different across heads."""
    ranks = runs["ranks"]
    for name in ("gqa 8/2", "mqa 8/1"):
        assert len({r[name]["bytes"] for r in ranks}) == 1
    wk = [i for i, p in enumerate(_paths(_port_cfg(CKPT_CASE))) if p.endswith("attn/wk")][0]
    g = [r[CKPT_CASE]["params"][wk] for r in ranks]
    assert g[0].shape[-1] == _port_cfg(CKPT_CASE).head_dim
    np.testing.assert_array_equal(g[0], g[1])
    np.testing.assert_array_equal(g[2], g[3])
    assert not np.array_equal(g[0], g[2])


def _paths(cfg):
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import api

    full = api.init_model(cfg, device="meta", generator=torch.Generator())
    return [SH._path(k) for k, _ in SH._leaves(full)]


def test_tp4_checkpoint_resumes_in_one_process(runs):
    from repro_torch.checkpoint import CheckpointManager

    ck = runs["ranks"][0]["checkpoint"]
    assert all(r["checkpoint"] == ck for r in runs["ranks"])
    step, loss = ck
    assert step == 2
    trainer = L.Trainer(_port_cfg(CKPT_CASE), _tcfg(), None,
                        ckpt=CheckpointManager(runs["ckdir"]), device="cpu",
                        log_fn=lambda s: None)
    state = trainer.init_or_resume()
    assert int(state["step"]) == 1
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in runs["batches"][CKPT_CASE].items()}
    state, metrics = trainer.step_fn(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_RTOL)


def test_pod_mesh_engine_streams_match_jax_data_shards(runs):
    """("pod", "data", "model") = (2, 1, 2): each pod holds half the slots
    (pod-major), tensor parallel within it; the streams are JAX's
    partitioned ``data_shards=2`` run's."""
    want = jax_streams(DENSE, data_shards=2)
    for r, ranks in enumerate(runs["ranks"]):
        pod = ranks["pod"]
        assert pod["coords"] == {"pod": r // 2, "data": 0, "model": r % 2}
        assert pod["data_rank"] == r // 2
        assert (pod["rows"], pod["row0"]) == (SERVE_B // 2, (r // 2) * SERVE_B // 2)
        assert pod["shapes"] == pod["placed"], r
        assert pod["streams"] == want, f"rank {r}"
