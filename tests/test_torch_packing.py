"""Document packing (``repro_torch.data.packing``) against the JAX package's
``repro.data.packing``, and a training step on packed rows, on the CPU.

- ``pack_documents`` yields the JAX package's rows (tokens, labels,
  segment ids, loss mask: values and dtypes) over ``tests/test_data.py``'s
  property cases and their fixed grid;
- the loader hands a packing source's rows over as they are: integer
  leaves as int64, the f32 mask as f32;
- one ``Trainer`` step of ``mod-paper-60m`` (smoke, f32) on packed rows
  with two microbatches: its loss within 1e-5 (relative) of the JAX train
  step's on the same rows. Both read ``loss_mask`` and neither reads
  ``segment_ids``: the documents of a row attend to one another.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data.packing import pack_documents as jax_pack_documents  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.packing import pack_documents  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.train import Trainer, make_train_state  # noqa: E402
from tests.helpers import property_cases  # noqa: E402

GRID = [([3], 4), ([1, 40, 7, 2], 16), ([8] * 8, 32), ([5, 9], 31)]
_packing_cases = property_cases(
    "docs,seq_len", GRID,
    lambda st: dict(docs=st.lists(st.integers(1, 40), min_size=1, max_size=8),
                    seq_len=st.integers(4, 32)),
    max_examples=20,
)
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch on the calling thread only (tests/test_torch_ssm.py
    says why: a worker thread beside JAX's has computed ``exp`` off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_rows(docs, seq_len, pad_id=0):
    rng = np.random.default_rng(0)
    arrays = [rng.integers(1, 100, size=n) for n in docs]
    got = list(pack_documents(arrays, seq_len, pad_id))
    want = list(jax_pack_documents(arrays, seq_len, pad_id))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    return got


@_packing_cases
def test_rows_equal_jax(docs, seq_len):
    _same_rows(docs, seq_len)


@pytest.mark.parametrize("docs,seq_len", GRID)
@pytest.mark.parametrize("pad_id", [0, 7])
def test_rows_equal_jax_on_the_grid(docs, seq_len, pad_id):
    rows = _same_rows(docs, seq_len, pad_id)
    assert sum(int((r["segment_ids"] > 0).sum()) for r in rows) <= sum(docs)


class PackedSource:
    """Global batches of rows packed from a seeded stream of documents."""

    def __init__(self, vocab, seq_len, seed=0):
        rng = np.random.default_rng(seed)
        docs = [rng.integers(1, vocab, int(n)) for n in rng.integers(3, 41, 64)]
        self.rows = list(pack_documents(docs, seq_len))

    def batch(self, step, batch_size):
        rows = self.rows[step * batch_size:(step + 1) * batch_size]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def test_the_loader_keeps_each_leafs_kind():
    loader = ShardedLoader(PackedSource(256, S), B, torch.device("cpu"))
    try:
        batch = next(loader)
    finally:
        loader.close()
    assert {k: v.dtype for k, v in batch.items()} == {
        "tokens": torch.int64, "labels": torch.int64, "segment_ids": torch.int64,
        "loss_mask": torch.float32}
    assert 0 < float(batch["loss_mask"].mean()) < 1


def test_packed_trainer_step_with_microbatches_matches_jax(tmp_path):
    steps, n = 2, 2
    jc = dataclasses.replace(JC.smoke_config(JC.get_config("mod-paper-60m")), dtype="float32")
    tc = dataclasses.replace(TC.smoke_config(TC.get_config("mod-paper-60m")), dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=steps)
    jt = JC.TrainConfig(global_batch=B, seq_len=S, microbatches=n, optim=JC.OptimConfig(**kw),
                        log_every=10**6)
    tt = TC.TrainConfig(global_batch=B, seq_len=S, microbatches=n, optim=TC.OptimConfig(**kw),
                        log_every=10**6, ckpt_dir=str(tmp_path), ckpt_every=10**6,
                        async_ckpt=False)
    source = PackedSource(jc.vocab, S)
    jp = jax.jit(JAPI.init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    jstate = {"params": jp, "opt": JLOOP.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(JLOOP.make_train_step(jc, jt))
    jlosses = []
    for i in range(steps):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, source.batch(i, B)))
        jlosses.append(float(m["loss"]))
    loader = ShardedLoader(source, B, torch.device("cpu"), microbatches=n)
    trainer = Trainer(tc, tt, loader, device="cpu", log_fn=lambda m: None)
    state = make_train_state(tc, "cpu", params=from_jax_params(jax.tree.map(np.asarray, jp),
                                                               "cpu"))
    tlosses = []
    for _ in range(steps):
        state, m = trainer.run(state, 1)
        tlosses.append(m["loss"])
    loader.close()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
