"""``remat="selective"`` on every family, against the port's other modes
and the JAX package's ``"selective"``, on the CPU.

The dense decoder (``mod-paper-60m``, backends xla and pallas_fused), MoE
(``olmoe-1b-7b``), Mamba2 (``mamba2-1.3b``), the Zamba2 hybrid, the
enc-dec (``whisper-tiny``) and the VLM backbone (``qwen2-vl-7b``), each at
``smoke_config``, f32, with the same weights (the port's init, carried to the JAX layout by
``to_numpy_tree``) and one numpy batch:

- the loss and every gradient under ``"selective"`` are bitwise those of
  ``"none"`` and ``"full"``;
- they are within 1e-5 (loss, relative) and 1e-4 of each leaf's largest
  |grad| of JAX's ``remat="selective"`` (the family test files'
  tolerances);
- the bytes a model call keeps for its backward order as ``full <
  selective < none``: autograd's saved tensors, counted by
  ``torch.autograd.graph.saved_tensors_hooks`` (parameters left out), plus
  the product outputs the selective policy keeps (its checkpoint holds
  them beside autograd's, so the hooks never see them: they are counted
  where the policy saves them). Among those is the router's
  ``bsd,d->bs`` einsum, which lowers to a ``bmm`` of batch 1;
- the policy classifies a product by its batch extent, not its name;
- one (2, 1)+fsdp mesh of two gloo ranks under ``"selective"``, on packed
  rows (``repro_torch.data.packing``), against one process: the loss
  within 1e-6 and each gradient shard within 2e-5 of the leaf's largest
  |grad| (``tests/test_torch_mesh_train.py``'s tolerance).

The spawned ranks import this module to find their function, so JAX and
the JAX package are imported inside the parent's functions only
(:func:`_jax`).
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as TC  # noqa: E402
from repro_torch.data.packing import pack_documents  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.params import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.train import loop as L  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

CASES = {"dense-xla": ("mod-paper-60m", "xla"), "dense-fused": ("mod-paper-60m", "pallas_fused"),
         "moe": ("olmoe-1b-7b", None), "ssm": ("mamba2-1.3b", None),
         "hybrid": ("zamba2-2.7b", None), "encdec": ("whisper-tiny", None),
         "vlm": ("qwen2-vl-7b", None)}
B, S = 2, 32
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # loss relative; of the leaf's largest |grad|
MESH_LOSS_RTOL, MESH_GRAD_TOL = 1e-6, 2e-5
POLICY = torch.utils.checkpoint.CheckpointPolicy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (tests/test_torch_ssm.py
    says why: a worker thread beside JAX's has computed ``exp`` off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """JAX and the JAX package's modules (imported here, in the parent only)."""
    import jax
    from repro import config as JC
    from repro.models import api as JAPI

    return types.SimpleNamespace(jax=jax, C=JC, api=JAPI)


def _cfg(C, case, remat):
    arch, backend = CASES[case]
    cfg = dataclasses.replace(C.smoke_config(C.get_config(arch)), dtype="float32", remat=remat)
    return C.with_mod_backend(cfg, backend) if backend else cfg


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    """The port's initial weights of the case as the JAX tree (numpy
    leaves, group leaves stacked), which both packages then load."""
    return to_numpy_tree(TAPI.init_model(_cfg(TC, case, "none"), device="cpu", seed=0))


def _batch(cfg):
    """One numpy batch of the family's inputs (the stub frontends' as the
    family test files draw them)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.family == "encdec":
        batch["enc_emb"] = (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model))
                            * 0.02).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i" and k != "positions"
            else torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _loss_and_grads(case, remat):
    """The port's loss and gradients (zeros where the loss does not reach a
    leaf, as ``jax.grad`` gives: the VLM's token embedding)."""
    tc = _cfg(TC, case, remat)
    tp = tree_map(lambda t: t.requires_grad_(True), from_jax_params(_jax_params(case), "cpu"))
    loss, _ = TAPI.model_loss(tp, tc, _tb(_batch(tc)))
    loss.backward()
    return loss.detach(), tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tp)


@pytest.mark.parametrize("case", list(CASES))
def test_selective_is_bitwise_none_and_full(case):
    loss, grads = _loss_and_grads(case, "selective")
    for other in ("none", "full"):
        l2, g2 = _loss_and_grads(case, other)
        assert torch.equal(loss, l2), other
        for a, b in zip(tree_leaves(grads), tree_leaves(g2)):
            assert torch.equal(a, b), other


@pytest.mark.parametrize("case", list(CASES))
def test_selective_matches_jax_selective(case):
    J = _jax()
    jc = _cfg(J.C, case, "selective")
    batch = _batch(jc)
    (jl, _), jg = J.jax.jit(J.jax.value_and_grad(
        lambda p, b: J.api.model_loss(p, jc, b), has_aux=True))(_jax_params(case), batch)
    tl, tg = _loss_and_grads(case, "selective")
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jleaves, jdef = J.jax.tree.flatten(J.jax.tree.map(np.asarray, jg))
    tleaves, tdef = J.jax.tree.flatten(to_numpy_tree(tg))
    assert jdef == tdef
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t, j, rtol=0, atol=GRAD_TOL * np.abs(j).max() + 1e-12)


def _saved(case, remat, monkeypatch):
    """(bytes a model call keeps for its backward, the ops whose outputs the
    selective policy kept)."""
    tc = _cfg(TC, case, remat)
    tp = tree_map(lambda t: t.requires_grad_(True), from_jax_params(_jax_params(case), "cpu"))
    params = {t.untyped_storage().data_ptr() for t in tree_leaves(tp)}
    kept, ops = {}, []

    def keep(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params:
            kept[ptr] = t.untyped_storage().nbytes()

    def pack(t):
        keep(t)
        return t

    real = T.save_dots

    def recording(ctx, func, *args, **kwargs):
        decision = real(ctx, func, *args, **kwargs)
        if decision == POLICY.MUST_SAVE and not ctx.is_recompute:
            keep(ctx.op_output)
            ops.append(func)
        return decision

    monkeypatch.setattr(T, "save_dots", recording)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = TAPI.model_loss(tp, tc, _tb(_batch(tc)))
    return sum(kept.values()), ops


@pytest.mark.parametrize("case", list(CASES))
def test_saved_bytes_order_full_selective_none(case, monkeypatch):
    full, _ = _saved(case, "full", monkeypatch)
    selective, ops = _saved(case, "selective", monkeypatch)
    none, _ = _saved(case, "none", monkeypatch)
    assert full < selective < none, (full, selective, none)
    assert torch.ops.aten.mm.default in ops
    if _cfg(TC, case, "none").mod.enabled:  # the router's bsd,d->bs einsum
        assert torch.ops.aten.bmm.default in ops


def test_policy_classifies_a_product_by_its_batch_extent():
    seen = []

    def record(ctx, func, *args, **kwargs):
        decision = T.save_dots(ctx, func, *args, **kwargs)
        if not ctx.is_recompute and func.overloadpacket in (
                torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm):
            seen.append((str(func), decision == POLICY.MUST_SAVE))
        return decision

    x = torch.randn(2, 4, 8, requires_grad=True)
    w = torch.randn(8, 16)

    def body(x):
        a = x @ w  # mm
        b = torch.nn.functional.linear(x, w.T, torch.ones(16))  # addmm
        c = torch.einsum("bsd,df->bsf", x, w)  # bmm of batch 1
        d = torch.einsum("bsf,btf->bst", a, b + c)  # bmm over b: recomputed
        return d.sum()

    ctx = functools.partial(torch.utils.checkpoint.create_selective_checkpoint_contexts, record)
    torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False, context_fn=ctx).backward()
    assert seen == [("aten.mm.default", True), ("aten.addmm.default", True),
                    ("aten.bmm.default", True), ("aten.bmm.default", False)]


def test_an_unknown_remat_mode_raises():
    tc = _cfg(TC, "dense-xla", "offload")
    params = TAPI.init_model(tc, device="cpu", seed=0)
    with pytest.raises(ValueError, match="offload"):
        TAPI.model_forward(params, tc, {"tokens": torch.zeros((1, 8), dtype=torch.long)})


# ---------------------------------------------------------------------------
# A mesh: (2, 1)+fsdp on two gloo ranks, packed rows
# ---------------------------------------------------------------------------


def _packed_batch(vocab, rows):
    """``rows`` rows of S tokens packed from documents of 3-40 tokens."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, vocab, int(n)) for n in rng.integers(3, 41, 4 * rows)]
    packed = list(pack_documents(docs, S))[:rows]
    assert len(packed) == rows
    return {k: np.stack([r[k] for r in packed]) for k in packed[0]}


def _fsdp_rank(tree, batch):
    from tests.test_torch_mesh_train import _cfg as mesh_cfg
    from tests.test_torch_mesh_train import _ctx, _local, _np, _tcfg

    cfg = mesh_cfg("mod-paper-60m", remat="selective")
    spmd = _ctx(2, 1, fsdp=True)
    state = L.make_train_state(cfg, "cpu", params=from_jax_params(tree, "cpu"), spmd=spmd)
    loss, _, grads = L.make_grads_fn(cfg, _tcfg(), spmd)(state["params"], _local(batch, spmd), 0)
    return dict(coords=spmd.coords(), loss=float(loss), grads=_np(grads))


def test_fsdp_mesh_selective_on_packed_rows_matches_one_process(tmp_path):
    from tests.test_torch_mesh import _spawn
    from tests.test_torch_mesh_train import B as MESH_B
    from tests.test_torch_mesh_train import _cfg as mesh_cfg
    from tests.test_torch_mesh_train import _cut, _port_leaves, _tcfg

    cfg = mesh_cfg("mod-paper-60m", remat="none")
    tree = to_numpy_tree(TAPI.init_model(cfg, device="cpu", seed=0))
    batch = _packed_batch(cfg.vocab, MESH_B)
    assert 0 < batch["loss_mask"].mean() < 1
    ranks = _spawn(tmp_path, 2, _fsdp_rank, tree, batch)
    state = L.make_train_state(cfg, "cpu", params=from_jax_params(tree, "cpu"))
    loss, _, grads = L.make_grads_fn(cfg, _tcfg())(state["params"], _tb(batch), 0)
    full = [(path, torch.as_tensor(g)) for (path, _), g in
            zip(_port_leaves(tree), [g.detach().numpy() for g in grads])]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], float(loss), rtol=MESH_LOSS_RTOL)
        for (path, g_full), g in zip(full, got["grads"]):
            want = _cut(path, g_full, cfg, (2, 1, True), got["coords"])
            assert g.shape == want.shape, (path, r)
            np.testing.assert_allclose(g, want, rtol=0, atol=MESH_GRAD_TOL * float(
                g_full.abs().max()) + 1e-12, err_msg=f"{path} rank {r}")
