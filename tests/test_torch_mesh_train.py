"""The port's mesh trainer over several processes (CPU, gloo) against the
JAX package's single-device training.

``mod-paper-60m`` and ``olmoe-1b-7b`` at smoke size cut to 2 layers (one
group: a full and a routed block), f32, backend
``pallas_fused`` (fused kernels' plain versions under pure DP, the
gather/scatter fallback under TP, FSDP and MoE), the same weights (the
JAX tree carried by ``from_jax_params``) and one global batch of 8 rows
with an uneven loss mask (a local mean of means would be off). On the
meshes (2, 1), (1, 2), (2, 1)+fsdp (one 2-rank spawn) and (2, 2),
(2, 2)+fsdp (one 4-rank spawn), every rank holds:

- the loss within 1e-5 (relative) of JAX's ``value_and_grad(model_loss)``
  and each gradient leaf within 2e-5 of that leaf's largest |grad| (the
  tolerances of tests/test_torch_train.py; JAX's own mesh gate allows
  2e-5), cut to the rank's placement;
- two full steps (clip, cosine LR, AdamW) against JAX's
  ``make_train_step``: loss and grad norm within 1e-5, the AdamW moments
  within 2e-5 (m) / 4e-5 (v) of the leaf's largest value, and the
  parameters: every element within AdamW's own sensitivity bound, 2·lr a
  step (an element whose gradient is near its leaf's rounding noise can
  take any update in [-lr, lr]: ``m̂/(√v̂+ε)`` with ε = 1e-8), and all but
  0.1% of each leaf's elements within 1e-5 + 2e-6 of the leaf's largest
  |value| (measured: at most 2 elements of a leaf past it, by ≤ 5e-5);
- its parameter and moment bytes equal to the placement, below the
  unsharded state wherever the rule cuts a leaf.

In the 2-rank spawn, beside those: ``microbatches=2`` on the MoE model
against the port's own single-process run (rank r's microbatch i is its
slice of global microbatch i); the stochastic router's selection equal to
one process's; a checkpoint saved on (2, 1)+fsdp resuming on (1, 2) and
in one process with the same next loss; a checkpoint of the JAX package
loading into the mesh trainer; DP over a ("pod", "data", "model") mesh;
the serving engine's config taking that mesh. And the training CLI under
``torchrun``.

The spawned ranks import this module to find their function, so JAX and
the JAX package are imported inside the parent's functions only
(:func:`_jax_modules`).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as TC  # noqa: E402
from repro_torch.data.loader import rank_rows  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.train import loop as L  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mod-paper-60m", "olmoe-1b-7b")
MESHES = {2: ((2, 1, False), (1, 2, False), (2, 1, True)), 4: ((2, 2, False), (2, 2, True))}
CASES = [(arch, world, mesh) for world, meshes in MESHES.items() for mesh in meshes
         for arch in ARCHS]
B, S, LR = 8, 32, 1e-3
LAYERS = 2  # one group: a full block and a routed block (MoE in both for olmoe)
LOSS_RTOL, GRAD_TOL, M_TOL, V_TOL, P_TOL = 1e-5, 2e-5, 2e-5, 4e-5, 2e-6
P_OUTLIERS = 1e-3  # the share of a leaf's parameters that may pass P_TOL, within 2·lr a step


def _mesh_id(mesh):
    d, m, fsdp = mesh
    return f"{d}x{m}" + ("+fsdp" if fsdp else "")


def _cfg(arch, **kw):
    cfg = dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype="float32",
                              n_layers=LAYERS, **kw)
    return TC.with_mod_backend(cfg, "pallas_fused")


def _jax_modules():
    """JAX and the JAX package's modules the references use (imported here,
    in the parent only)."""
    import types

    import jax
    from repro import config as JC
    from repro.checkpoint import CheckpointManager
    from repro.models import api
    from repro.optim import adamw_init
    from repro.train import loop

    return types.SimpleNamespace(jax=jax, C=JC, CheckpointManager=CheckpointManager, api=api,
                                 adamw_init=adamw_init, loop=loop)


def _tcfg(microbatches=1):
    return TC.TrainConfig(global_batch=B, seq_len=S, microbatches=microbatches,
                          optim=TC.OptimConfig(lr=LR, warmup_steps=1, total_steps=10))


def _batch(vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    # rows keep 50-100% of their positions: the rank means of means differ
    keep = rng.random((B, S)) < np.linspace(0.5, 1.0, B)[:, None]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": keep.astype(np.float32)}


def _local(batch, spmd, microbatches=1):
    """This rank's rows of a global numpy batch, as the ShardedLoader lays
    them out."""
    rows = rank_rows(B, spmd.data_shards, spmd.data_rank, microbatches)
    return {k: (torch.as_tensor(v[rows]).long() if v.dtype.kind == "i" else torch.as_tensor(v[rows]))
            for k, v in batch.items()}


def _np(tensors):
    return [t.detach().numpy().copy() for t in tensors]


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _ctx(d, m, fsdp=False, pod=1):
    """The training context of a (pod, data, model) mesh (``mesh_ctx``)."""
    from repro_torch.launch.mesh import mesh_ctx

    return mesh_ctx(TC.MeshConfig(pod=pod, data=d, model=m, fsdp=fsdp))


def _one_mesh(cfg, spmd, tree, batch):
    """Loss and gradients of the first step, then two steps: everything the
    parent holds against JAX, on this rank's shards."""
    layout = L.MeshLayout(cfg, spmd)
    state = L.make_train_state(cfg, "cpu", params=from_jax_params(tree, "cpu"), spmd=spmd)
    local = _local(batch, spmd)
    loss, aux, grads = L.make_grads_fn(cfg, _tcfg(), spmd, layout)(state["params"], local, 0)
    step = L.make_train_step(cfg, _tcfg(), spmd)
    metrics = []
    for _ in range(2):
        state, m = step(state, local)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(coords=spmd.coords(), loss=float(loss), grads=_np(grads), metrics=metrics,
                params=_np(tree_leaves(state["params"])), m=_np(tree_leaves(state["opt"]["m"])),
                v=_np(tree_leaves(state["opt"]["v"])), bytes=L.state_bytes(state),
                placed=layout.placed_bytes())


def _selection(cfg, spmd, logits):
    """The stochastic router's selection of this rank's rows under a
    training call on ``spmd``."""
    from repro_torch.core import router as R

    part = torch.as_tensor(logits)[rank_rows(B, spmd.data_shards, spmd.data_rank)]
    with SH.model_parallel(spmd, batch=True):
        idx, _, _ = R.mod_select(part, cfg.mod.capacity(S), cfg.mod,
                                 torch.Generator().manual_seed(11))
    return idx.numpy()


def _checkpoint(tree, batch, ckdir):
    """One step on (2, 1)+fsdp, saved; its next loss; that checkpoint
    resumed on (1, 2) and stepped."""
    from repro_torch.checkpoint import CheckpointManager

    cfg = _cfg("mod-paper-60m")
    out = {}
    for key, (d, m, fsdp) in (("fsdp", (2, 1, True)), ("tp", (1, 2, False))):
        spmd = _ctx(d, m, fsdp)
        trainer = L.Trainer(cfg, _tcfg(), None, ckpt=CheckpointManager(ckdir, async_save=False),
                            device="cpu", spmd=spmd, log_fn=lambda s: None)
        state = trainer.init_or_resume()
        local = _local(batch, spmd)
        if key == "fsdp":
            state, _ = trainer.step_fn(state, local)
            trainer.save(state, wait=True)
            torch.distributed.barrier()
        state, metrics = trainer.step_fn(state, local)
        out[key] = (int(state["step"]), float(metrics["loss"]))
    return out


def _jax_checkpoint_into_mesh(ckdir):
    """The JAX package's checkpoint restored on a (1, 2) mesh: this rank's
    parameters and moments, and the step."""
    from repro_torch.checkpoint import CheckpointManager

    cfg = _cfg("mod-paper-60m")
    spmd = _ctx(1, 2)
    trainer = L.Trainer(cfg, _tcfg(), None, ckpt=CheckpointManager(ckdir), device="cpu",
                        spmd=spmd, log_fn=lambda s: None)
    state = trainer.init_or_resume()
    return dict(coords=spmd.coords(), step=int(state["step"]),
                params=_np(tree_leaves(state["params"])), m=_np(tree_leaves(state["opt"]["m"])))


def _vlm_batch(spmd):
    """The ShardedLoader's first batch of a qwen2-vl smoke run with two
    microbatches (stub embeddings, M-RoPE positions (3, B, S)) on ``spmd``
    (None: one process, the whole batch), as numpy arrays."""
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import stub_frontend

    cfg = dataclasses.replace(TC.smoke_config(TC.get_config("qwen2-vl-7b")), dtype="float32")
    loader = ShardedLoader(SyntheticLM(cfg.vocab, S, seed=0), B, torch.device("cpu"), spmd=spmd,
                           microbatches=2, transform=stub_frontend(cfg, 0))
    try:
        return {k: v.numpy() for k, v in next(loader).items()}
    finally:
        loader.close()


def _rank(world, trees, batches, extra):
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        for d, m, fsdp in MESHES[world]:
            spmd = _ctx(d, m, fsdp)
            out[(arch, (d, m, fsdp))] = _one_mesh(cfg, spmd, trees[arch], batches[arch])
    if world != 2:
        return out
    # MoE with two microbatches on (2, 1)
    cfg = _cfg("olmoe-1b-7b")
    spmd = _ctx(2, 1)
    state = L.make_train_state(cfg, "cpu", params=from_jax_params(trees["olmoe-1b-7b"], "cpu"),
                               spmd=spmd)
    loss, _, grads = L.make_grads_fn(cfg, _tcfg(2), spmd)(
        state["params"], _local(batches["olmoe-1b-7b"], spmd, 2), 0)
    out["micro"] = (float(loss), _np(grads))
    # the stochastic router: the selection and the loss of (2, 1)
    cfg = _cfg("mod-paper-60m", mod=dataclasses.replace(
        _cfg("mod-paper-60m").mod, router_type="stochastic"))
    out["selection"] = _selection(cfg, spmd, extra["logits"])
    state = L.make_train_state(cfg, "cpu", params=from_jax_params(trees["mod-paper-60m"], "cpu"),
                               spmd=spmd)
    loss, _, grads = L.make_grads_fn(cfg, _tcfg(), spmd)(
        state["params"], _local(batches["mod-paper-60m"], spmd), 3)
    out["stochastic"] = (float(loss), _np(grads))
    out["loader"] = (spmd.data_rank, _vlm_batch(spmd))
    # DP over a ("pod", "data", "model") mesh
    pod = _ctx(1, 1, pod=2)
    out["pod"] = dict(axes=pod.data_axes, shards=pod.data_shards,
                      **_one_mesh(_cfg("mod-paper-60m"), pod, trees["mod-paper-60m"],
                                  batches["mod-paper-60m"]))
    from repro_torch.serve import EngineConfig

    out["pod_serving"] = EngineConfig(batch_size=4, ctx=16, mesh=pod.mesh).mesh is pod.mesh
    out["checkpoint"] = _checkpoint(trees["mod-paper-60m"], batches["mod-paper-60m"],
                                    extra["ckdir"])
    out["jax_checkpoint"] = _jax_checkpoint_into_mesh(extra["jax_ckdir"])
    return out


# ---------------------------------------------------------------------------
# References (the parent process)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """(config, initial tree) of the JAX package."""
    J = _jax_modules()
    jc = dataclasses.replace(J.C.smoke_config(J.C.get_config(arch)), dtype="float32",
                             n_layers=LAYERS)
    return jc, J.jax.jit(J.api.init_model, static_argnums=1)(J.jax.random.PRNGKey(0), jc)


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX's initial tree, loss and gradients, and its two train steps'
    metrics and states, on the global batch."""
    J = _jax_modules()
    jax, JC, JAPI, JLOOP = J.jax, J.C, J.api, J.loop
    jc, jp = _jax_init(arch)
    batch = _batch(jc.vocab)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JAPI.model_loss(p, jc, b)[0]))(jp, batch)
    jt = JC.TrainConfig(global_batch=B, seq_len=S,
                        optim=JC.OptimConfig(lr=LR, warmup_steps=1, total_steps=10))
    step = jax.jit(JLOOP.make_train_step(jc, jt))
    state = {"params": jp, "opt": J.adamw_init(jp), "step": jax.numpy.zeros((), jax.numpy.int32)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(tree=host(jp), batch=batch, loss=float(loss), grads=host(grads),
                metrics=metrics, state=host(state))


def _port_leaves(jtree):
    """A JAX-layout tree of numpy leaves as the port's (path, tensor) leaves."""
    port = from_jax_params(jtree, "cpu")
    return [(SH._path(keys), leaf) for keys, leaf in SH._leaves(port)]


def _cut(path, full, cfg, mesh, coords):
    d, m, fsdp = mesh
    return SH.cut_leaf(path, full, cfg, {"data": d, "model": m}, coords, fsdp).numpy()


def _jax_checkpoint_state():
    """A train state the JAX package's CheckpointManager writes for the
    mesh trainer to load: JAX's initial parameters, moments of their
    shapes (0.5·p and p²), step 2."""
    J = _jax_modules()
    _, jp = _jax_init("mod-paper-60m")
    tree_map = J.jax.tree.map
    return {"params": jp, "opt": {"m": tree_map(lambda p: 0.5 * p, jp),
                                  "v": tree_map(lambda p: p * p, jp),
                                  "count": J.jax.numpy.asarray(2, J.jax.numpy.int32)},
            "step": J.jax.numpy.asarray(2, J.jax.numpy.int32)}


def _start(tmp_path, world, fn, *args):
    """:func:`tests.test_torch_mesh._spawn` in two halves: start the ranks
    (this one), then :func:`_collect` their results."""
    import torch.multiprocessing as mp

    from tests.test_torch_mesh import _rank_main

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp_path.mkdir(parents=True, exist_ok=True)
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp_path / "store"), fn, args,
                                                   queue)) for r in range(world)]
    for p in procs:
        p.start()
    return queue, procs


def _collect(queue, procs):
    try:
        got = [queue.get(timeout=240) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [err for _, _, err in got if err is not None]
    assert not errors, errors[0]
    return [res for _, res, _ in sorted(got, key=lambda g: g[0])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of the 2-rank and the 4-rank spawn, and the
    checkpoint directory of the 2-rank one. The JAX references compile
    while the ranks run."""
    host = lambda t: _jax_modules().jax.tree.map(np.asarray, t)  # noqa: E731
    trees = {arch: host(_jax_init(arch)[1]) for arch in ARCHS}
    batches = {arch: _batch(_jax_init(arch)[0].vocab) for arch in ARCHS}
    base = tmp_path_factory.mktemp("mesh_train")
    jax_ckdir = str(base / "jax_ckpt")
    ck = _jax_modules().CheckpointManager(jax_ckdir, async_save=False)
    ck.save(2, _jax_checkpoint_state(), wait=True)
    logits = np.random.default_rng(2).standard_normal((B, S)).astype(np.float32)
    extra = dict(logits=logits, ckdir=str(base / "ckpt"), jax_ckdir=jax_ckdir)
    started = {world: _start(base / f"world{world}", world, _rank, world, trees, batches, extra)
               for world in MESHES}
    for arch in ARCHS:
        _jax_run(arch)
    out = {world: _collect(*started[world]) for world in MESHES}
    out["ckdir"] = extra["ckdir"]
    return out


@pytest.mark.parametrize("arch,world,mesh", CASES,
                         ids=[f"{a}-{_mesh_id(m)}" for a, _, m in CASES])
def test_mesh_loss_and_grads_match_jax(runs, arch, world, mesh):
    ref = _jax_run(arch)
    cfg = _cfg(arch)
    grads = _port_leaves(ref["grads"])
    for r, ranks in enumerate(runs[world]):
        got = ranks[(arch, mesh)]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        for (path, full), g in zip(grads, got["grads"]):
            want = _cut(path, full, cfg, mesh, got["coords"])
            assert g.shape == want.shape, (path, r)
            np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_TOL * np.abs(full.numpy()).max()
                                       + 1e-12, err_msg=f"{path} rank {r}")


@pytest.mark.parametrize("arch,world,mesh", CASES,
                         ids=[f"{a}-{_mesh_id(m)}" for a, _, m in CASES])
def test_mesh_train_steps_match_jax(runs, arch, world, mesh):
    """Two steps of clip, cosine LR and AdamW on the rank's shards."""
    ref = _jax_run(arch)
    cfg = _cfg(arch)
    want = {k: _port_leaves(v) for k, v in (("params", ref["state"]["params"]),
                                             ("m", ref["state"]["opt"]["m"]),
                                             ("v", ref["state"]["opt"]["v"]))}
    for r, ranks in enumerate(runs[world]):
        got = ranks[(arch, mesh)]
        np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=LOSS_RTOL)
        for key, tol in (("m", M_TOL), ("v", V_TOL)):
            for (path, full), t in zip(want[key], got[key]):
                np.testing.assert_allclose(
                    t, _cut(path, full, cfg, mesh, got["coords"]), rtol=0,
                    atol=tol * np.abs(full.numpy()).max() + 1e-12, err_msg=f"{key} {path} rank {r}")
        for (path, full), t in zip(want["params"], got["params"]):
            err = np.abs(t - _cut(path, full, cfg, mesh, got["coords"]))
            np.testing.assert_array_less(err, 2 * LR * 2, err_msg=f"{path} rank {r}")
            far = int((err > 1e-5 + P_TOL * np.abs(full.numpy()).max()).sum())
            assert far <= P_OUTLIERS * err.size, (path, r, far, err.size, err.max())


@pytest.mark.parametrize("arch,world,mesh", CASES,
                         ids=[f"{a}-{_mesh_id(m)}" for a, _, m in CASES])
def test_rank_state_bytes_equal_the_placement(runs, arch, world, mesh):
    full = sum(t.numel() * (t.element_size() + 8)
               for t in tree_leaves(from_jax_params(_jax_run(arch)["tree"], "cpu")))
    for got in runs[world]:
        entry = got[(arch, mesh)]
        assert entry["bytes"] == entry["placed"]
        # the rule cuts the big leaves under TP and FSDP: well under the whole
        assert entry["bytes"] < 0.7 * full if (mesh[1] > 1 or mesh[2]) else entry["bytes"] == full


def test_microbatches_on_moe_match_one_process(runs):
    cfg = _cfg("olmoe-1b-7b")
    ref = _jax_run("olmoe-1b-7b")
    params = L._trainable(from_jax_params(ref["tree"], "cpu"))
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in ref["batch"].items()}
    loss, _, grads = L.make_grads_fn(cfg, _tcfg(2))(params, batch, 0)
    leaves = [(SH._path(k), g) for (k, _), g in zip(SH._leaves(params), grads)]
    for got in runs[2]:
        mloss, mgrads = got["micro"]
        np.testing.assert_allclose(mloss, float(loss), rtol=LOSS_RTOL)
        for (path, full), g in zip(leaves, mgrads):
            np.testing.assert_allclose(g, full.detach().numpy(), rtol=0,
                                       atol=GRAD_TOL * float(full.abs().max()) + 1e-12,
                                       err_msg=path)


def test_stochastic_router_selects_as_one_process(runs):
    from repro_torch.core import router as R

    cfg = _cfg("mod-paper-60m")
    cfg = dataclasses.replace(cfg, mod=dataclasses.replace(cfg.mod, router_type="stochastic"))
    logits = np.random.default_rng(2).standard_normal((B, S)).astype(np.float32)
    want, _, _ = R.mod_select(torch.as_tensor(logits), cfg.mod.capacity(S), cfg.mod,
                              torch.Generator().manual_seed(11))
    for r, got in enumerate(runs[2]):
        np.testing.assert_array_equal(got["selection"], want.numpy()[r * B // 2:(r + 1) * B // 2])
    params = L._trainable(from_jax_params(_jax_run("mod-paper-60m")["tree"], "cpu"))
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in _jax_run("mod-paper-60m")["batch"].items()}
    loss, _, grads = L.make_grads_fn(cfg, _tcfg())(params, batch, 3)
    for got in runs[2]:
        np.testing.assert_allclose(got["stochastic"][0], float(loss), rtol=LOSS_RTOL)
        for g, full in zip(got["stochastic"][1], grads):
            np.testing.assert_allclose(g, full.numpy(), rtol=0,
                                       atol=GRAD_TOL * float(full.abs().max()) + 1e-12)


def test_loader_gives_each_rank_its_rows_of_the_global_microbatches(runs):
    """A rank's batch is its rows of each global microbatch in turn
    (``rank_rows``), cut on the batch dim ``batch_placement`` gives each
    leaf: M-RoPE positions on dim 1, the rest on dim 0."""
    whole = _vlm_batch(None)
    assert set(whole) == {"labels", "embeds", "positions"}
    for got in runs[2]:
        data_rank, mine = got["loader"]
        rows = rank_rows(B, 2, data_rank, microbatches=2)
        for k, v in whole.items():
            np.testing.assert_array_equal(mine[k], v[:, rows] if k == "positions" else v[rows],
                                          err_msg=k)


def test_pod_axis_is_data_parallel_and_serving_refuses_it(runs):
    ref = _jax_run("mod-paper-60m")
    grads = _port_leaves(ref["grads"])
    for got in runs[2]:
        pod = got["pod"]
        assert pod["axes"] == ("pod", "data") and pod["shards"] == 2
        assert set(pod["coords"]) == {"pod", "data", "model"}
        np.testing.assert_allclose(pod["loss"], ref["loss"], rtol=LOSS_RTOL)
        for (path, full), g in zip(grads, pod["grads"]):  # replicated: the whole gradient
            np.testing.assert_allclose(g, full.numpy(), rtol=0,
                                       atol=GRAD_TOL * np.abs(full.numpy()).max() + 1e-12)
        assert got["pod_serving"]  # the engine takes the pod mesh (tests/test_torch_tp_kv.py)


def test_checkpoint_resumes_across_meshes_and_in_one_process(runs):
    from repro_torch.checkpoint import CheckpointManager

    ck = runs[2][0]["checkpoint"]
    for got in runs[2]:
        assert got["checkpoint"] == ck  # every rank the same step and loss
    (step_f, loss_f), (step_t, loss_t) = ck["fsdp"], ck["tp"]
    assert step_f == step_t == 2
    np.testing.assert_allclose(loss_t, loss_f, rtol=LOSS_RTOL)
    # the same checkpoint in one process
    cfg = _cfg("mod-paper-60m")
    trainer = L.Trainer(cfg, _tcfg(), None, ckpt=CheckpointManager(runs["ckdir"]), device="cpu",
                        log_fn=lambda s: None)
    state = trainer.init_or_resume()
    assert int(state["step"]) == 1
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in _jax_run("mod-paper-60m")["batch"].items()}
    state, metrics = trainer.step_fn(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), loss_f, rtol=LOSS_RTOL)


def test_jax_checkpoint_loads_into_the_mesh_trainer(runs):
    state = _jax_modules().jax.tree.map(np.asarray, _jax_checkpoint_state())
    cfg = _cfg("mod-paper-60m")
    want = {"params": _port_leaves(state["params"]), "m": _port_leaves(state["opt"]["m"])}
    for got in (ranks["jax_checkpoint"] for ranks in runs[2]):
        assert got["step"] == 2
        for key in ("params", "m"):
            for (path, full), t in zip(want[key], got[key]):
                np.testing.assert_array_equal(t, _cut(path, full, cfg, (1, 2, False),
                                                      got["coords"]), err_msg=path)


def test_rank_rows_and_refusals():
    np.testing.assert_array_equal(rank_rows(8, 2, 1), [4, 5, 6, 7])
    # microbatch i of rank r: its slice of global microbatch i
    np.testing.assert_array_equal(rank_rows(8, 2, 1, microbatches=2), [2, 3, 6, 7])
    with pytest.raises(ValueError, match="not divisible"):
        rank_rows(6, 2, 0, microbatches=2)
    tcfg = dataclasses.replace(_tcfg(), optim=TC.OptimConfig(grad_compression="int8"))
    with pytest.raises(NotImplementedError, match="grad_compression"):
        L.make_train_step(_cfg("mod-paper-60m"), tcfg)
    # kv heads that do not divide the model axis train (tests/test_torch_tp_kv.py)
    mqa = dataclasses.replace(_cfg("mod-paper-60m"), attn=dataclasses.replace(
        _cfg("mod-paper-60m").attn, n_kv_heads=1))
    SH.check_tensor_parallel(mqa, 2)
    assert SH.kv_copies(mqa, 2) == 2


@pytest.mark.parametrize("remat,gathers", [("none", 1), ("full", 2)])
def test_fsdp_gathers_each_layer_group_where_it_runs(monkeypatch, remat, gathers):
    """``model_forward`` gathers the FSDP leaves outside the layer groups
    once; ``run_groups`` gathers each group's inside its remat boundary:
    once a step without remat, again in the backward's recomputation
    under ``remat="full"`` (a rank holds one group's gathered weights at a
    time)."""
    from repro_torch.models import api

    calls = []
    real = SH.gather_data

    def spy(params, spmd, skip=()):
        calls.append(tuple(skip))
        return real(params, spmd, skip)

    monkeypatch.setattr(SH, "gather_data", spy)
    cfg = dataclasses.replace(_cfg("mod-paper-60m", remat=remat), n_layers=4)
    params = L._trainable(api.init_model(cfg, device="cpu", seed=0))
    batch = {k: (torch.as_tensor(v[:2]).long() if v.dtype.kind == "i" else
                 torch.as_tensor(v[:2])) for k, v in _batch(cfg.vocab).items()}
    loss, _ = api.model_loss(params, cfg, batch)
    loss.backward()
    n_groups = len(params["groups"])
    assert n_groups == 2
    assert calls.count(("groups",)) == 1
    assert calls.count(()) == gathers * n_groups


def test_pipeline_stages_on_a_mesh_raise():
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="pp_stages=2"):
        make_mesh(TC.MeshConfig(pod=2, data=1, model=1, pp_stages=2))


def test_train_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--spmd", "--model-axis", "2", "--device", "cpu",
           "--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt")]
    run = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-4000:]
    line = next(x for x in run.stdout.splitlines() if x.startswith("[train] mesh:"))
    assert "data=1 x model=2 (2 ranks, gloo, cpu), fsdp=False" in line
    got, placed = (int(v) for v in
                   line.split("moments) ")[1].replace(" bytes a rank, placement", "").split())
    assert got == placed
    assert "done at step 2" in run.stdout
    assert (tmp_path / "ckpt" / "step_00000002" / "manifest.json").exists()
