"""The port's optimizer and checkpoint format against the JAX package (CPU).

- AdamW, the cosine schedule and global-norm clipping against
  ``repro.optim`` on the same trees: f32 and bf16 leaves, 1-D leaves
  without weight decay, several steps. The port evaluates the JAX
  expressions op for op, so f32 values agree to 1e-6 relative (XLA may
  fuse a multiply-add or take a power in another way); bf16 weights
  within one bf16 ulp.
- Checkpoints both ways: a directory the port writes restores in the JAX
  ``CheckpointManager`` and the reverse, every bf16 bit kept; a corrupt
  newest step falls back to the previous one.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule  # noqa: E402,E501
from repro_torch.train.loop import make_train_state, state_from_host, state_to_host  # noqa: E402
from repro_torch.utils import flatten_dict, tree_leaves  # noqa: E402

OPT = dict(lr=3e-3, min_lr_ratio=0.1, warmup_steps=3, total_steps=12, weight_decay=0.1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((6, 5)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
        "emb": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
    }


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_adamw_matches_jax_over_several_steps():
    jp = jax.tree.map(jnp.asarray, _tree())
    tp = {k: _to_torch(v) for k, v in _tree().items()}
    jopt, topt = j_adamw_init(jp), adamw_init(tp)
    jcfg, tcfg = JC.OptimConfig(**OPT), TC.OptimConfig(**OPT)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in _tree().items()}
        g["emb"] = g["emb"].astype(ml_dtypes.bfloat16)
        jlr = j_cosine(jnp.int32(step), jcfg)
        tlr = cosine_schedule(step, tcfg)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        jp, jopt = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), jopt, jcfg, jlr)
        adamw_update(tp, {k: _to_torch(v) for k, v in g.items()}, topt, tcfg, float(tlr))
    assert int(topt["count"]) == int(jopt["count"]) == 5
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        for mom in ("m", "v"):
            np.testing.assert_allclose(_np(topt[mom][k]), np.asarray(jopt[mom][k]), rtol=1e-6,
                                       atol=1e-9)
    assert tp["emb"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tp["emb"]), np.asarray(jp["emb"], np.float32), rtol=2 ** -7)
    # weight decay only on ndim >= 2: with a zero gradient a 1-D leaf stays put
    z = {k: torch.zeros_like(v) for k, v in tp.items()}
    before = {k: v.clone() for k, v in tp.items()}
    adamw_update(tp, z, {"m": {k: torch.zeros(v.shape) for k, v in tp.items()},
                         "v": {k: torch.zeros(v.shape) for k, v in tp.items()},
                         "count": torch.zeros((), dtype=torch.int32)}, tcfg, 1e-2)
    assert torch.equal(tp["b"], before["b"]) and not torch.equal(tp["w"], before["w"])


def test_cosine_schedule_matches_jax():
    for kw in (OPT, dict(lr=1e-3, warmup_steps=0, total_steps=7, min_lr_ratio=0.0)):
        jcfg, tcfg = JC.OptimConfig(**kw), TC.OptimConfig(**kw)
        for step in range(0, 15):
            np.testing.assert_allclose(float(cosine_schedule(step, tcfg)),
                                       float(j_cosine(jnp.int32(step), jcfg)), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    tree = _tree(2)
    jg, jn = j_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    tg, tn = clip_by_global_norm([_to_torch(v) for v in tree.values()], max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for t, k in zip(tg, tree):
        assert t.dtype == _to_torch(tree[k]).dtype
        np.testing.assert_allclose(_np(t), np.asarray(jg[k], np.float32), rtol=1e-6, atol=1e-7)


def _cfgs():
    jc = JC.smoke_config(JC.get_config("mod-paper-60m"))  # bf16 weights
    tc = TC.smoke_config(TC.get_config("mod-paper-60m"))
    return jc, tc


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_port_checkpoint_restores_in_jax_with_every_bit(tmp_path):
    _, tc = _cfgs()
    state = make_train_state(tc, "cpu", seed=1)
    with torch.no_grad():
        for m in tree_leaves(state["opt"]["m"]):
            m.normal_()
    state["step"] = torch.tensor(7, dtype=torch.int32)
    state["opt"]["count"] = torch.tensor(7, dtype=torch.int32)
    CheckpointManager(str(tmp_path), async_save=False).save(7, state_to_host(state))
    step, restored = JCheckpointManager(str(tmp_path)).restore_latest()
    assert step == 7
    want = flatten_dict(state_to_host(state))
    got = flatten_dict(restored)
    assert set(got) == set(want)
    for key, t in want.items():
        a = got[key]
        if t.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16, key
            np.testing.assert_array_equal(_bits(a), t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(a, t.numpy())
    # the JAX trainer's state layout: stacked groups, opt/{m,v,count}, step
    jc, _ = _cfgs()
    spec = JLOOP.train_state_specs(jax.random.PRNGKey(0), jc)
    jflat = flatten_dict(jax.tree.map(lambda s: s, spec))
    assert set(jflat) == set(got)
    for key, s in jflat.items():
        assert tuple(s.shape) == tuple(got[key].shape) and str(s.dtype) == str(got[key].dtype), key


def test_jax_checkpoint_restores_in_the_port_with_every_bit(tmp_path):
    jc, tc = _cfgs()
    jstate = jax.jit(JLOOP.make_train_state, static_argnums=1)(jax.random.PRNGKey(3), jc)
    JCheckpointManager(str(tmp_path), async_save=False).save(5, jstate)
    step, tree = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 5
    state = state_from_host(tree, "cpu")
    assert int(state["step"]) == 0 and state["params"]["groups"][0]["mod"]["block"]["attn"][
        "wq"].requires_grad
    back = flatten_dict(state_to_host(state))
    jflat = flatten_dict(jax.tree.map(np.asarray, jstate))
    assert set(back) == set(jflat)
    for key, a in jflat.items():
        t = back[key]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), _bits(a))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_corrupt_newest_step_falls_back_and_retention_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((3,), float(step)), "s": torch.tensor(step)})
    mgr.wait()
    assert mgr.available_steps() == [2, 3]
    manifest = tmp_path / "step_00000003" / "manifest.json"
    meta = json.loads(manifest.read_text())
    meta["tensors"]["x"]["sha"] = "0" * 16
    manifest.write_text(json.dumps(meta))
    step, tree = mgr.restore_latest()
    assert step == 2 and torch.equal(tree["x"], torch.full((3,), 2.0))
