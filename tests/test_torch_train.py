"""The port's training path against the JAX package, on the CPU.

Same weights (the JAX tree carried across by ``repro_torch.params``), same
batches, f32, at ``smoke_config(mod-paper-60m)`` and its ``-vanilla``
twin:

- ``model_loss``: the loss within 1e-5 relative, every gradient leaf
  against ``jax.grad`` within 2e-5 of that leaf's largest JAX entry (the
  two frameworks sum matmuls and reductions in different orders; the
  largest difference seen is 1.6e-6 of the leaf's scale), and the routed
  masks of every MoD layer exactly equal, for the backends xla, pallas and
  pallas_fused (JAX's Pallas kernels in interpret mode);
- a 20-step trajectory of the port's ``Trainer`` against the JAX
  ``make_train_step``: losses within 1e-4 relative while every routed mask
  agrees (measured: 1.7e-5; AdamW's early steps are close to lr·sign(g),
  so last-bit gradient differences near zero move single weights by up to
  2·lr), and within 1e-2 relative over all 20 steps: once the weights have
  drifted by that much, a near-tie in a router's top-k can flip one token's
  routing (at this size, step 8), which moves the loss by a few 1e-3;
- which kernels the training forward reaches under each backend; full
  rematerialisation, microbatch accumulation, resume and the NaN circuit
  breaker; the CPU training CLI.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import routing as JROUT  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import routing as TROUT  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import blocks as TBLK  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.train import Trainer, make_train_state, make_train_step  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5  # of the leaf's largest |grad|
TRAJ_RTOL_SAME_ROUTING = 1e-4
TRAJ_RTOL = 1e-2


def _cfgs(arch="mod-paper-60m", backend="xla", **kw):
    jc = JC.with_mod_backend(
        dataclasses.replace(JC.smoke_config(JC.get_config(arch)), dtype="float32", **kw), backend)
    tc = TC.with_mod_backend(
        dataclasses.replace(TC.smoke_config(TC.get_config(arch)), dtype="float32", **kw), backend)
    return jc, tc


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """These models are small: with the suite's parallel workers, torch's
    default of one thread per core oversubscribes the machine and each
    tiny op waits on spinning threads. Two threads per worker here."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(jc, seed=0):
    return jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def _batch(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _grads_tree(params):
    return tree_map(lambda p: p.grad, params)


@pytest.fixture
def masks_of(monkeypatch):
    """Record the routed mask of every token_topk decision, in both packages
    (JAX through a debug callback, so it works under jit and grad)."""
    seen = {"jax": [], "torch": []}
    jreal, treal = JROUT.decide_tokens, TROUT.decide_tokens

    def jrec(*a, **k):
        d = jreal(*a, **k)
        jax.debug.callback(lambda m: seen["jax"].append(np.asarray(m)), d.mask)
        return d

    def trec(*a, **k):
        d = treal(*a, **k)
        seen["torch"].append(d.mask.numpy())
        return d

    monkeypatch.setattr(JROUT, "decide_tokens", jrec)
    monkeypatch.setattr(TROUT, "decide_tokens", trec)
    return seen


CASES = [("mod-paper-60m", "xla"), ("mod-paper-60m", "pallas"), ("mod-paper-60m", "pallas_fused"),
         ("mod-paper-60m-vanilla", "xla")]


@pytest.mark.parametrize("arch,backend", CASES)
def test_model_loss_and_grads_match_jax(arch, backend, masks_of):
    jc, tc = _cfgs(arch, backend)
    jp = _jax_params(jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    batch = _batch(jc.vocab)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JAPI.model_loss(p, jc, b), has_aux=True))(jp, batch)
    tl, taux = TAPI.model_loss(tp, tc, _torch_batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-4, atol=1e-6)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jg))
    tleaves, tdef = jax.tree.flatten(to_numpy_tree(_grads_tree(tp)))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)
    n_mod = len(tp["groups"]) if jc.mod.enabled else 0
    assert len(masks_of["torch"]) == len(masks_of["jax"]) == n_mod
    for t, j in zip(masks_of["torch"], masks_of["jax"]):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
def test_training_forward_reaches_the_backends_kernels(backend, monkeypatch):
    """pallas_fused runs the routed blocks through the fused wrappers and
    never gather/scatter; xla and pallas the reverse."""
    _, tc = _cfgs(backend=backend)
    calls = []
    import repro_torch.core.routing as R
    import repro_torch.models.attention as A

    for mod, name in ((R.KR, "gather_rows"), (R.KR, "scatter_add_rows"),
                      (A, "routed_attention"), (TBLK, "routed_mlp_scatter")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    params = TAPI.init_model(tc, device="cpu", seed=1)
    TAPI.model_forward(params, tc, _torch_batch(_batch(tc.vocab)))
    n = len(params["groups"])
    if backend == "pallas_fused":
        assert sorted(set(calls)) == ["routed_attention", "routed_mlp_scatter"]
        assert calls.count("routed_attention") == n
    else:
        assert sorted(set(calls)) == ["gather_rows", "scatter_add_rows"]
        assert calls.count("gather_rows") == n


def _loss_and_grads(params, cfg, batch, generator=None):
    for p in tree_leaves(params):
        p.grad = None
        p.requires_grad_(True)
    loss, _ = TAPI.model_loss(params, cfg, batch, generator)
    loss.backward()
    return float(loss), [p.grad.clone() for p in tree_leaves(params)]


@pytest.mark.parametrize("router_type", ["learned", "stochastic"])
def test_full_remat_gives_the_same_loss_and_grads(router_type):
    """remat="full" recomputes each group in the backward; the stochastic
    router redraws the same selection there (its seed is per group). So
    does remat="selective", which keeps the products' outputs."""
    _, tc = _cfgs(backend="pallas_fused")
    tc = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, router_type=router_type))
    params = TAPI.init_model(tc, device="cpu", seed=2)
    batch = _torch_batch(_batch(tc.vocab, seed=3))
    l0, g0 = _loss_and_grads(params, tc, batch, torch.Generator().manual_seed(7))
    l1, g1 = _loss_and_grads(params, dataclasses.replace(tc, remat="full"), batch,
                             torch.Generator().manual_seed(7))
    assert l0 == l1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    l2, g2 = _loss_and_grads(params, dataclasses.replace(tc, remat="selective"), batch,
                             torch.Generator().manual_seed(7))
    assert l0 == l2
    for a, b in zip(g0, g2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_stochastic_router_selects_from_the_generator():
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, router_type="stochastic"))
    params = TAPI.init_model(tc, device="cpu", seed=2)
    x = torch.randn(2, 32, tc.d_model, generator=torch.Generator().manual_seed(0))
    mp = params["groups"][0]["mod"]
    d1 = TROUT.decide_tokens(mp, x, tc, torch.Generator().manual_seed(1))
    d2 = TROUT.decide_tokens(mp, x, tc, torch.Generator().manual_seed(1))
    d3 = TROUT.decide_tokens(mp, x, tc, torch.Generator().manual_seed(2))
    learned = TROUT.decide_tokens(mp, x, dataclasses.replace(
        tc, mod=dataclasses.replace(tc.mod, router_type="learned")))
    assert torch.equal(d1.idx, d2.idx) and not torch.equal(d1.idx, d3.idx)
    assert not torch.equal(d1.idx, learned.idx)
    assert (d1.mask.sum(1) == tc.mod.capacity(32)).all()
    torch.testing.assert_close(d1.gate, torch.take_along_dim(d1.logits, d1.idx, 1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        TROUT.decide_tokens(mp, x, tc)


def _tcfg(steps, microbatches=1, ckpt_dir="unused", ckpt_every=10**6):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    return (JC.TrainConfig(global_batch=4, seq_len=32, microbatches=microbatches,
                           optim=JC.OptimConfig(**kw), log_every=10**6),
            TC.TrainConfig(global_batch=4, seq_len=32, microbatches=microbatches,
                           optim=TC.OptimConfig(**kw), log_every=10**6, ckpt_dir=ckpt_dir,
                           ckpt_every=ckpt_every, async_ckpt=False))


def test_trainer_trajectory_matches_jax_20_steps(tmp_path, masks_of):
    steps = 20
    jc, tc = _cfgs()
    jt, tt = _tcfg(steps, ckpt_dir=str(tmp_path))
    jp = _jax_params(jc, 1)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    src = JSyntheticLM(jc.vocab, 32, seed=0)
    jlosses = []
    for i in range(steps):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, src.batch(i, 4)))
        jlosses.append(float(m["loss"]))
    loader = ShardedLoader(SyntheticLM(tc.vocab, 32, seed=0), 4, torch.device("cpu"))
    trainer = Trainer(tc, tt, loader, device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    assert int(state["step"]) == steps and len(trainer.heartbeats) == steps
    n_mod = len(state["params"]["groups"])
    same = [all((a == b).all() for a, b in zip(masks_of["jax"][i * n_mod:(i + 1) * n_mod],
                                                masks_of["torch"][i * n_mod:(i + 1) * n_mod]))
            for i in range(steps)]
    first_flip = same.index(False) if False in same else steps
    assert first_flip >= 5  # routing starts out identical
    np.testing.assert_allclose(tlosses[:first_flip], jlosses[:first_flip],
                               rtol=TRAJ_RTOL_SAME_ROUTING)
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJ_RTOL)
    assert tlosses[-1] < tlosses[0] - 0.5  # it trains


def test_microbatch_accumulation_matches_the_full_batch():
    _, tc = _cfgs(backend="pallas_fused")
    batch = _torch_batch(_batch(tc.vocab, B=4, seed=4))
    out = []
    for n in (1, 2):
        _, tt = _tcfg(4, microbatches=n)
        state = make_train_state(tc, "cpu", seed=3)
        state, m = make_train_step(tc, tt)(state, batch)
        out.append(m)
    np.testing.assert_allclose(float(out[1]["loss"]), float(out[0]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out[1]["grad_norm"]), float(out[0]["grad_norm"]), rtol=1e-5)


def test_resume_continues_the_same_run(tmp_path):
    _, tc = _cfgs()

    def run(directory, chunks):
        losses = []
        for n in chunks:
            _, tt = _tcfg(6, ckpt_dir=str(directory), ckpt_every=2)
            loader = ShardedLoader(SyntheticLM(tc.vocab, 32, seed=0), 4, torch.device("cpu"))
            trainer = Trainer(tc, tt, loader, device="cpu", log_fn=lambda m: None)
            state = trainer.init_or_resume()
            state, m = trainer.run(state, n)
            losses.append(m["loss"])
        return state, losses

    straight, l1 = run(tmp_path / "a", [5])
    resumed, l2 = run(tmp_path / "b", [3, 3])  # the second run resumes from step 2
    assert int(resumed["step"]) == int(straight["step"]) == 5
    assert l1[-1] == l2[-1]
    for a, b in zip(tree_leaves(straight["params"]), tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_nan_loss_trips_the_circuit_breaker(tmp_path):
    _, tc = _cfgs()
    _, tt = _tcfg(3, ckpt_dir=str(tmp_path))
    loader = ShardedLoader(SyntheticLM(tc.vocab, 32, seed=0), 4, torch.device("cpu"))
    trainer = Trainer(tc, tt, loader, ckpt=CheckpointManager(str(tmp_path)), device="cpu",
                      log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", seed=0)
    with torch.no_grad():
        state["params"]["final_norm"]["scale"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        trainer.run(state, 1)


def test_train_cli_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
           "--steps", "3", "--backend", "pallas_fused", "--dtype", "float32",
           "--ckpt-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "[trainer] fresh init" in out.stdout
    assert "done at step 3" in out.stdout
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
