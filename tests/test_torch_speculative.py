"""Self-speculative decoding of the port against the JAX package (CPU, f32,
the smoke-size model of ``tests/helpers.tiny_cfg``, torch on one thread).

- Window functions (``api.model_{draft,verify,fused}_window``): drafts equal
  JAX's and logits match within 1e-5 on caches both packages prefilled from
  the same prompt; fused == draft + verify exactly; the drafter leaves the
  caller's cache tree (and a paged pool's residual tensors, which a
  materialized tree holds) bitwise unchanged.
- Pool functions: ``paged_collect_rows`` and the window scatter
  (``paged_scatter_rows_q``) equal JAX's on the same logical caches, with
  positions past the mapped extent and past ``ctx`` (ring wrap) masked to
  the scratch page, unquantized and quantized; ``truncate``'s cases of
  ``tests/test_paged_properties.py``, and a seeded acquire / alloc /
  truncate / release / prefix op sequence whose tables, refcounts, cache
  counts and free list equal the JAX pool's after every op.
- Scheduler and config: the verify-budget admission cap and the
  validation errors are JAX's, message for message; the CLI flags.
- Padded engine streams: greedy streams and the ``speculative_*`` stats,
  ``padded_token_fraction`` and ``step_count`` equal the JAX engine's, and
  greedy and sampled streams equal the port's non-speculative engine's, for
  the dense and the MoD model at (n, draft ratio) = (1, 0.0), (3, 0.125)
  and (2, capacity ratio). Sampled streams are held against the port's own
  engine only: the port draws token ``i`` from a generator of (seed, i),
  JAX from ``fold_in(key, i)``, so the two draw different tokens by design.

The ragged, prefix and quantized engines, the verify budget and
``run_stream`` are in ``tests/test_torch_speculative_engines.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import api as JAPI  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import cache as JCACHE  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServingEngine, add_engine_args  # noqa: E402
from repro_torch.serve import quant as TQ  # noqa: E402
from repro_torch.serve.cache import (  # noqa: E402
    _RESERVED,
    NULL_PAGE,
    SCRATCH_PAGE,
    PagedCachePool,
    _leaves,
    flatten,
)
from repro_torch.serve.scheduler import Scheduler  # noqa: E402
from tests.test_torch_paged import model_pair, run_both  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t) -> np.ndarray:
    a = t.detach().cpu() if isinstance(t, torch.Tensor) else t
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.element_size() == 1 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _jax_index(keys):
    """(JAX path, layer index or None) of a port cache leaf: the port keeps
    one leaf per layer group (``groups``, g, ...), JAX stacks them."""
    if keys[0] == "groups":
        return ("groups",) + keys[2:], keys[1]
    return keys, None


def _jax_leaves(tree):
    return {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(jtree, template):
    """The port's cache tree holding a JAX cache tree's values."""
    jl = _jax_leaves(jtree)
    out = []
    for keys, _ in _leaves(template):
        path, g = _jax_index(keys)
        v = np.asarray(jl[path] if g is None else jl[path][g])
        out.append(torch.from_numpy(v.copy()))
    from repro_torch.serve.cache import unflatten

    return unflatten(template, out)


def _draft_cfgs(jc, tc, ratio):
    return (dataclasses.replace(jc, mod=dataclasses.replace(jc.mod, capacity_ratio=ratio)),
            dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, capacity_ratio=ratio)))


def _prefilled(B=3, S=6, ctx=16, seed=1):
    """(JAX cfg/params/caches, port cfg/params/caches, tokens, pos): both
    packages prefill the same prompts."""
    jc, jp, tc, tp = model_pair(True)
    toks = np.random.default_rng(seed).integers(1, jc.vocab - 1, size=(B, S))
    jl, jcaches = JAPI.model_prefill(jp, jc, {"tokens": jnp.asarray(toks, jnp.int32)}, ctx)
    tl, tcaches = TAPI.model_prefill(tp, tc, {"tokens": torch.as_tensor(toks)}, ctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int64)
    return (jc, jp, jcaches), (tc, tp, tcaches), nxt[:, None], np.full((B,), S, np.int32)


# ---------------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.0, 0.125])
@pytest.mark.parametrize("window", ["draft", "verify", "fused"])
def test_window_functions_match_jax(window, ratio):
    """Drafts equal JAX's, logits within 1e-5, aux stacks (routed masks
    exact) and collected rows within 1e-5."""
    (jc, jp, jcaches), (tc, tp, tcaches), tok, pos = _prefilled()
    active = np.asarray([True, True, False])
    n = 3
    jcd, tcd = _draft_cfgs(jc, tc, ratio)
    jargs = (jnp.asarray(tok, jnp.int32), jnp.asarray(pos), jnp.asarray(active))
    targs = (torch.as_tensor(tok), torch.as_tensor(pos), torch.as_tensor(active))
    if window == "draft":
        jd = JAPI.model_draft_window(jp, jcd, jcaches, *jargs, n)
        td = TAPI.model_draft_window(tp, tcd, tcaches, *targs, n)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert td.shape == (n, 3)
        return
    jspec = JCACHE.PagedCachePool(jc, 3, 16, 4).step_spec()
    tspec = PagedCachePool(tc, 3, 16, 4, torch.device("cpu")).spec

    def jcollect(c, p):
        return tuple(JCACHE.paged_collect_rows(jspec, c, p))

    def tcollect(c, p):
        from repro_torch.serve.cache import paged_collect_rows

        return tuple(paged_collect_rows(tspec, c, p))

    if window == "verify":
        feed = np.concatenate([tok[:, 0][None], np.asarray(
            JAPI.model_draft_window(jp, jcd, jcaches, *jargs, n))]).astype(np.int64)
        jl, jaux, jrows = JAPI.model_verify_window(jp, jc, jcaches, jnp.asarray(feed, jnp.int32),
                                                   jargs[1], jargs[2], collect=jcollect)
        tl, taux, trows = TAPI.model_verify_window(tp, tc, tcaches, torch.as_tensor(feed),
                                                   targs[1], targs[2], collect=tcollect)
    else:
        jd, jl, jaux, jrows = JAPI.model_fused_window(jp, jc, jcaches, *jargs, n,
                                                      collect=jcollect)
        td, tl, taux, trows = TAPI.model_fused_window(tp, tc, tcaches, *targs, n,
                                                      collect=tcollect)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tl.shape == (n + 1, 3, jc.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    assert set(taux) == set(jaux)
    np.testing.assert_array_equal(taux["mod/decode_routed"].numpy(),
                                  np.asarray(jaux["mod/decode_routed"]))
    # rows: port leaf j (one layer) against its JAX leaf's layer, per step
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(JAPI.make_caches(jc, 1, 16))[0]]
    tkeys = [k for k, _ in _leaves(TAPI.make_caches(tc, 1, 16, "cpu"))]
    for j, i in enumerate(tspec.paged_ids):
        path, g = _jax_index(tkeys[i])
        jj = [jpaths[i2] for i2 in jspec.paged_ids].index(path)
        np.testing.assert_allclose(trows[j].numpy(), np.asarray(jrows[jj])[:, g],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_fused_window_equals_two_pass_exactly(mod):
    """At an equal draft config the fused chain is draft + verify,
    deduplicated: same drafts, bitwise the same logits and aux."""
    _, _, tc, tp = model_pair(mod)
    caches = TAPI.make_caches(tc, 2, 16, "cpu")
    tok = torch.tensor([[3], [7]])
    pos = torch.zeros(2, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    fresh = [t.clone() for t in flatten(caches)]
    from repro_torch.serve.cache import unflatten

    df, lf, af, _ = TAPI.model_fused_window(tp, tc, unflatten(caches, fresh), tok, pos, act, 3)
    d2 = TAPI.model_draft_window(tp, tc, caches, tok, pos, act, 3)
    feed = torch.cat([tok[:, 0][None], d2])
    l2, a2, _ = TAPI.model_verify_window(tp, tc, caches, feed, pos, act)
    assert torch.equal(df, d2)
    assert torch.equal(lf, l2)
    assert set(af) == set(a2) and all(torch.equal(af[k], a2[k]) for k in af)


def test_draft_window_leaves_the_callers_caches_unchanged():
    """The port's decode step writes caches in place; the drafter runs on a
    clone, so the caller's tree, and the paged pool's residual tensors a
    materialized tree holds, keep every bit."""
    _, (tc, tp, tcaches), tok, pos = _prefilled()
    before = [t.clone() for t in flatten(tcaches)]
    act = torch.ones(3, dtype=torch.bool)
    for ratio in (0.0, 0.125, tc.mod.capacity_ratio):
        tcd = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, capacity_ratio=ratio))
        TAPI.model_draft_window(tp, tcd, tcaches, torch.as_tensor(tok), torch.as_tensor(pos),
                                act, 4)
        assert all(torch.equal(a, b) for a, b in zip(flatten(tcaches), before))
    # a materialized pool: its residual leaves are the pool's own tensors
    pool = PagedCachePool(tc, 3, 16, 4, torch.device("cpu"))
    for s in range(3):
        pool.acquire(s)
        assert pool.alloc_pages(s, 8)
    pool.write_slot(0, TAPI.model_prefill(tp, tc, {"tokens": torch.arange(1, 7)[None]}, 16)[1])
    resid = [r.clone() for r in pool.resid]
    pages = [p.clone() for p in pool.pages]
    table = pool.device_table()
    TAPI.model_draft_window(tp, tc, pool.materialize(table), torch.tensor([[5], [0], [0]]),
                            torch.tensor([6, 0, 0], dtype=torch.int32), act, 3)
    assert all(torch.equal(a, b) for a, b in zip(pool.resid, resid))
    assert all(torch.equal(a, b) for a, b in zip(pool.pages, pages))


def test_zero_draft_ratio_routes_no_row():
    from repro_torch.core.routing import batch_capacity_k

    tc = model_pair(True)[2]
    zero = dataclasses.replace(tc, mod=dataclasses.replace(tc.mod, capacity_ratio=0.0))
    assert batch_capacity_k(zero, 4) == 0
    assert batch_capacity_k(tc, 4) == 1


# ---------------------------------------------------------------------------
# Pool functions: collect + window scatter, truncate
# ---------------------------------------------------------------------------

QUANTS = {"none": None, "int8-page": ("int8", "page"), "fp8-head": ("fp8", "head")}


@pytest.mark.parametrize("quant", list(QUANTS))
def test_collect_rows_and_window_scatter_match_jax(quant):
    """A speculative window (n=3) over random logical caches: each step
    writes fresh rows at ``(pos + j) % ctx`` (the ring), the rows at ``pos +
    j`` are collected after the step, then scattered in one call with rows
    past a slot's limit (and past ``ctx``, where collection clips) masked to
    the scratch page. Collected rows, pages and scales equal JAX's bitwise
    (the scratch page, where invalid rows collide, excepted)."""
    jc, _, tc, _ = model_pair(True)
    B, ctx, p, n = 3, 16, 4, 3
    q = QUANTS[quant]
    jq = JQ.QuantConfig(kv=q[0], granularity=q[1]) if q else None
    tq = TQ.QuantConfig(kv=q[0], granularity=q[1]) if q else None
    jpool = JCACHE.PagedCachePool(jc, B, ctx, p, quant=jq)
    tpool = PagedCachePool(tc, B, ctx, p, torch.device("cpu"), quant=tq)
    for pool in (jpool, tpool):
        for s, upto in enumerate((16, 8, 16)):
            pool.acquire(s)
            assert pool.alloc_pages(s, upto)
    np.testing.assert_array_equal(tpool.table_np, jpool.table_np)
    jspec = jpool.step_spec()
    rng = np.random.default_rng(3)

    def rand(shape, dtype):
        if np.dtype(dtype).kind == "i":
            return rng.integers(-1, ctx, size=shape).astype(dtype)
        return (rng.standard_normal(shape) * 3).astype(dtype)

    flat, treedef = jax.tree_util.tree_flatten(JAPI.make_caches(jc, B, ctx))
    arrs = [rand(x.shape, x.dtype) for x in flat]
    pos = np.asarray([3, 6, 13], np.int32)  # slot 1 passes its limit, slot 2 ctx
    limit = np.asarray([16, 8, 16], np.int32)
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(JAPI.make_caches(jc, B, ctx))[0]]
    tkeys = [k for k, _ in _leaves(tpool._template)]
    jrows, trows = [], []
    for j in range(n + 1):
        # the step's ring writes (G, B) + tail at (pos + j) % ctx, the same
        # values in both layouts
        at = (pos + j) % ctx
        for i in jspec.paged_ids:
            leaf = arrs[i]  # (G, B, ctx) + tail
            leaf[:, np.arange(B), at] = rand(leaf[:, :, 0].shape, leaf.dtype)
        jcaches = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in arrs])
        tcaches = _port_tree(jcaches, tpool._template)
        jrows.append(JCACHE.paged_collect_rows(jspec, jcaches, jnp.asarray(pos + j)))
        trows.append(tpool.collect_rows(tcaches, torch.as_tensor(pos + j)))
    offs = np.arange(n + 1)[:, None]
    w_slot = np.tile(np.arange(B, dtype=np.int32), n + 1)
    w_pos = (pos[None] + offs).reshape(-1).astype(np.int32)
    w_valid = (pos[None] + offs < limit[None]).reshape(-1)
    assert w_valid.sum() == 4 + 2 + 3  # masked: past the limit, and the wrap
    jstack = [jnp.stack([r[k] for r in jrows]) for k in range(len(jspec.paged_ids))]
    jflat = [jnp.moveaxis(r, 0, ax).reshape(r.shape[1:ax + 1] + (-1,) + r.shape[ax + 2:])
             for r, ax in zip(jstack, jspec.paged_axes)]
    new_pages, new_scales = JCACHE.paged_scatter_rows_q(
        jspec, jflat, jpool.pages, jpool.scales, jpool.device_table(), jnp.asarray(w_slot),
        jnp.asarray(w_pos), jnp.asarray(w_valid))
    tflat = [torch.stack([r[k] for r in trows]).reshape((-1,) + tuple(trows[0][k].shape[1:]))
             for k in range(len(tpool.spec.paged_ids))]
    tpool.scatter_rows(tflat, tpool.device_table(), torch.as_tensor(w_slot).long(),
                       torch.as_tensor(w_pos), torch.as_tensor(w_valid))
    keep = np.ones(tpool.n_pages, bool)
    keep[SCRATCH_PAGE] = False
    jpaged = [jpaths[i] for i in jspec.paged_ids]
    for j, i in enumerate(tpool.spec.paged_ids):
        path, g = _jax_index(tkeys[i])
        jj = jpaged.index(path)
        np.testing.assert_array_equal(trows_stack := torch.stack([r[j] for r in trows]).numpy(),
                                      np.asarray(jstack[jj])[:, g])
        assert trows_stack.shape[:2] == (n + 1, B)
        np.testing.assert_array_equal(_bits(tpool.pages[j])[keep],
                                      _bits(np.asarray(new_pages[jj])[g])[keep])
    assert len(tpool.scales) == len(new_scales)
    for ts, js in zip(tpool.scales, new_scales):
        np.testing.assert_array_equal(ts.numpy()[keep], np.asarray(js)[keep])


SLOTS, CTX, PAGE, CHUNK = 3, 32, 4, 8


def _tpool(n_pages=None):
    return PagedCachePool(model_pair(True)[2], SLOTS, CTX, PAGE, torch.device("cpu"),
                          n_pages=n_pages, prefix_chunk=CHUNK)


def _jpool(n_pages=None):
    return JCACHE.PagedCachePool(model_pair(True)[0], SLOTS, CTX, PAGE, n_pages=n_pages,
                                 prefix_chunk=CHUNK)


def _check(pool):
    """Every book of the port pool recomputed from its raw structures."""
    assert pool.ref[:_RESERVED].sum() == 0 and pool.cache_cnt[:_RESERVED].sum() == 0
    free = list(pool.free)
    assert all(p >= _RESERVED for p in free) and len(free) == len(set(free))
    ref = np.zeros_like(pool.ref)
    for s in range(pool.batch_size):
        n = int(pool.n_mapped[s])
        row = pool.table_np[s]
        assert (row[:n] >= _RESERVED).all() and len(set(row[:n].tolist())) == n
        assert np.isin(row[n:], (NULL_PAGE, SCRATCH_PAGE)).all()
        np.add.at(ref, row[:n], 1)
    np.testing.assert_array_equal(ref, pool.ref)
    cnt = np.zeros_like(pool.cache_cnt)
    for e in pool.prefix.values():
        for pid in e.pages:
            cnt[pid] += 1
    np.testing.assert_array_equal(cnt, pool.cache_cnt)
    idle = {p for p in range(_RESERVED, pool.n_pages)
            if pool.ref[p] == 0 and pool.cache_cnt[p] == 0}
    assert set(free) == idle


def test_truncate_releases_tail_pages():
    pool = _tpool()
    pool.acquire(0)
    assert pool.alloc_pages(0, 16)  # 4 pages
    free_before = len(pool.free)
    assert pool.truncate(0, 5) == 2  # keep ceil(5/4) = 2 pages
    assert int(pool.n_mapped[0]) == 2
    assert (pool.table_np[0, 2:] == NULL_PAGE).all()
    assert len(pool.free) == free_before + 2
    _check(pool)


def test_truncate_keeps_prefix_pinned_pages_off_the_free_list():
    pool = _tpool()
    pool.acquire(0)
    tokens = (np.arange(2 * CHUNK) % 5).astype(np.int32)
    assert pool.alloc_pages(0, len(tokens))
    snap = pool.snapshot_resid(pool.read_slot(0))
    pool.prefix_register(0, tokens, {CHUNK: snap, 2 * CHUNK: snap})
    free_before = len(pool.free)
    assert pool.truncate(0, 0) == 4  # all 4 decref'd, every one pinned
    assert int(pool.n_mapped[0]) == 0
    assert len(pool.free) == free_before
    assert (pool.cache_cnt[_RESERVED:] > 0).sum() == 4
    _check(pool)


def test_truncate_on_shared_prefix_leaves_other_slot_readable():
    pool = _tpool()
    long = (np.arange(2 * CHUNK + 2) % 5).astype(np.int32)
    pool.acquire(0)
    assert pool.alloc_pages(0, len(long))
    pool.prefix_register(0, long, {CHUNK: pool.snapshot_resid(pool.read_slot(0))})
    for slot in (1, 2):
        pool.acquire(slot)
        m = pool.prefix_match(long)
        assert m is not None and m[1].n_tokens == CHUNK
        pool.prefix_attach(slot, m[0])
    shared = [int(p) for p in pool.table_np[1, : CHUNK // PAGE]]
    assert shared == [int(p) for p in pool.table_np[2, : CHUNK // PAGE]]
    pool.truncate(1, 0)  # slot 1 rolls its whole window back
    assert [int(p) for p in pool.table_np[2, : CHUNK // PAGE]] == shared
    assert all(pool.ref[p] >= 1 for p in shared)
    _check(pool)


def test_truncate_beyond_mapped_extent_is_a_noop():
    pool = _tpool()
    pool.acquire(0)
    assert pool.alloc_pages(0, 6)
    assert pool.truncate(0, CTX) == 0
    assert int(pool.n_mapped[0]) == 2
    _check(pool)


def test_truncate_mid_page_keeps_the_partial_page():
    pool = _tpool()
    pool.acquire(0)
    assert pool.alloc_pages(0, 8)
    assert pool.truncate(0, PAGE + 1) == 0  # position 5 still needs page 2
    assert int(pool.n_mapped[0]) == 2
    assert pool.truncate(0, PAGE) == 1
    assert int(pool.n_mapped[0]) == 1
    _check(pool)


@pytest.mark.parametrize("seed,pressure", [(s, p) for s in range(3) for p in (False, True)])
def test_seeded_pool_ops_match_jax_pool(seed, pressure):
    """Random acquire / alloc / truncate / release / prefix ops on both
    pools (under page pressure too): after every op the port's page table,
    mapped counts, refcounts, cache counts, free list (in order), prefix
    keys and each op's result equal the JAX pool's."""
    n_pages = _RESERVED + (SLOTS * CTX // PAGE) // 2 if pressure else None
    tp, jp = _tpool(n_pages), _jpool(n_pages)
    rng = np.random.default_rng(seed)
    base = np.arange(CTX, dtype=np.int32) % 7
    prompts = [base[:L].copy() for L in (CHUNK + 1, 2 * CHUNK, 3 * CHUNK + 2)]
    prompts += [np.concatenate([base[:CHUNK], base[:L] + 1]).astype(np.int32) for L in (3, CHUNK)]
    live = [False] * SLOTS
    for _ in range(60):
        op = rng.choice(["acquire", "alloc", "truncate", "release", "prefix"])
        slot = int(rng.integers(SLOTS))
        upto = int(rng.integers(0, CTX + 1))
        tokens = prompts[int(rng.integers(len(prompts)))]
        got = []
        for pool in (tp, jp):
            r = None
            if op == "acquire":
                pool.acquire(slot)
            elif op in ("alloc", "truncate") and live[slot]:
                r = pool.alloc_pages(slot, upto) if op == "alloc" else pool.truncate(slot, upto)
            elif op == "release":
                pool.release(slot)
            elif op == "prefix":
                pool.acquire(slot)
                m = pool.prefix_match(tokens)
                if m is not None:
                    pool.prefix_attach(slot, m[0])
                r = pool.alloc_pages(slot, len(tokens))
                if r:
                    snap = ({} if pool is tp else pool.snapshot_resid_slot(slot))
                    covered = int(pool.n_mapped[slot]) * PAGE
                    pool.prefix_register(slot, tokens, {
                        end: snap for end in range(CHUNK, len(tokens) + 1, CHUNK)
                        if end <= covered})
            got.append(r)
        if op in ("acquire", "prefix"):
            live[slot] = True
        elif op == "release":
            live[slot] = False
        assert got[0] == got[1], op
        np.testing.assert_array_equal(tp.table_np, jp.table_np)
        np.testing.assert_array_equal(tp.n_mapped, jp.n_mapped)
        np.testing.assert_array_equal(tp.ref, jp.ref)
        np.testing.assert_array_equal(tp.cache_cnt, jp.cache_cnt)
        assert list(tp.free) == list(jp.free)
        assert list(tp.prefix) == list(jp.prefix)
        _check(tp)


# ---------------------------------------------------------------------------
# Scheduler, config, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 4, 8, 13])
def test_scheduler_admission_cap_matches_jax(budget):
    t, j = Scheduler(4, verify_token_budget=budget), JScheduler(4, verify_token_budget=budget)
    for n_active in range(5):
        for cost in (1, 2, 4):
            assert (t.speculative_admission_cap(n_active, cost)
                    == j.speculative_admission_cap(n_active, cost))
    if budget is not None:
        with pytest.raises(ValueError, match="verify_cost must be positive"):
            t.speculative_admission_cap(0, 0)
    assert Scheduler(4, verify_token_budget=8).speculative_admission_cap(3, 4) == 0


@pytest.mark.parametrize("setting", [
    dict(speculate=2), dict(speculate=0, page_size=4), dict(speculate=2, page_size=4,
                                                            draft_ratio=1.5),
    dict(speculate=2, page_size=4, draft_ratio=-0.1), dict(page_size=4, spec_verify_budget=8),
])
def test_speculative_config_errors_are_jaxs(setting):
    with pytest.raises(ValueError) as jerr:
        JEngineConfig(batch_size=2, ctx=32, **setting)
    with pytest.raises(ValueError) as terr:
        EngineConfig(batch_size=2, ctx=32, **setting)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["ssm", "non_causal"])
def test_speculative_engine_errors_are_jaxs(case):
    """A family without batched prefill, and non-causal attention, raise
    at engine construction with JAX's messages."""
    jc, jp, tc, tp = model_pair(True)
    kw = dict(batch_size=2, ctx=32, page_size=4, speculate=2)
    if case == "ssm":
        from repro import config as JC
        from repro_torch import config as TC

        jc, tc = (C.smoke_config(C.get_config("mamba2-1.3b")) for C in (JC, TC))
        tp = TAPI.init_model(tc, device="cpu", seed=0)
        jp = {}  # the check comes before the JAX engine reads its weights
    else:
        jc = dataclasses.replace(jc, attn=dataclasses.replace(jc.attn, causal=False))
        tc = dataclasses.replace(tc, attn=dataclasses.replace(tc.attn, causal=False))
    with pytest.raises(ValueError) as terr:
        ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as jerr:
        JServingEngine(jp, jc, engine=JEngineConfig(**kw))
    assert str(terr.value) == str(jerr.value)


def test_later_paths_still_raise_beside_speculation():
    """A ``mesh`` that is not a ``DeviceMesh`` raises beside speculation
    (a real one raises JAX's ``NotImplementedError``,
    tests/test_torch_spmd.py); the capacity ladder raises JAX's
    ``NotImplementedError`` at the engine (a round already runs two
    capacity ratios); a fault injector rides a speculative engine
    (tests/test_torch_faults.py)."""
    with pytest.raises(ValueError, match="mesh"):
        EngineConfig(batch_size=2, ctx=16, page_size=4, speculate=2, mesh="data")
    jc, jp, tc, tp = model_pair(True)
    kw = dict(batch_size=2, ctx=16, page_size=4, speculate=2, adaptive_capacity=True)
    with pytest.raises(NotImplementedError, match="adaptive_capacity") as terr:
        ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        JServingEngine(jp, jc, engine=JEngineConfig(**kw))
    assert str(terr.value) == str(jerr.value)


def test_cli_flags_build_the_speculative_config():
    import argparse

    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    ns = ap.parse_args(["--page-size", "16", "--speculate", "3", "--draft-ratio", "0.125",
                        "--verify-budget", "8"])
    ec = EngineConfig.from_args(ns, batch_size=4, ctx=64)
    assert (ec.speculate, ec.draft_ratio, ec.spec_verify_budget) == (3, 0.125, 8)
    ec = EngineConfig.from_args(ap.parse_args(["--page-size", "16"]), batch_size=4, ctx=64)
    assert (ec.speculate, ec.draft_ratio, ec.spec_verify_budget) == (None, 0.0, None)


# ---------------------------------------------------------------------------
# Padded engine: streams and stats
# ---------------------------------------------------------------------------

SPEC_STATS = ("steps", "speculative_rounds", "speculative_accept_rate",
              "speculative_tokens_per_round", "padded_token_fraction", "mean_occupancy",
              "mean_routed_frac", "generated_tokens", "prefill_tokens_computed")


def assert_stats_equal(ts, js, keys=SPEC_STATS):
    for k in keys:
        a, b = ts[k], js[k]
        assert a == b or (a != a and b != b), (k, a, b)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=L) for L in (5, 9, 3, 12)]


def _port_streams(mod, sampled, **engine):
    _, _, tc, tp = model_pair(mod)
    eng = ServingEngine(tp, tc, EngineConfig(batch_size=4, ctx=32, page_size=4, prefill_chunk=4,
                                             **engine), device="cpu")
    for i, p in enumerate(_prompts()):
        eng.submit(Request(tokens=p, max_new_tokens=8, seed=100 + i,
                           temperature=0.9 if sampled and i % 2 else 0.0))
    return {o.uid: o.full_sequence.tolist() for o in eng.run()}, eng


WINDOWS = [(1, 0.0), (3, 0.125), (2, "capacity")]


@pytest.mark.parametrize("n,ratio", WINDOWS, ids=["n1-r0", "n3-r0.125", "n2-capacity"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mod", [True, False], ids=["mod", "dense"])
def test_padded_speculative_streams(mod, sampled, n, ratio):
    ratio = model_pair(mod)[2].mod.capacity_ratio if ratio == "capacity" else ratio
    base, beng = _port_streams(mod, sampled)
    spec, eng = _port_streams(mod, sampled, speculate=n, draft_ratio=ratio)
    assert spec == base, f"speculate={n} draft_ratio={ratio} changed tokens"
    st = eng.stats()
    assert st["speculative_rounds"] > 0
    assert 1.0 <= st["speculative_tokens_per_round"] <= n + 1
    assert st["steps"] == beng.stats()["steps"] == eng.step_count
    eng.scheduler.check_invariants(eng.slots, len(spec))
    assert st["pages_in_use"] == 0.0
    if sampled:
        return
    t, teng, j, jeng = run_both(_prompts(), 8, mod=mod, batch_size=4, ctx=32, page_size=4,
                                prefill_chunk=4, speculate=n, draft_ratio=ratio)
    assert t == spec and j == spec
    assert_stats_equal(teng.stats(), jeng.stats())
    assert teng.step_count == jeng.step_count


def test_greedy_dense_accepts_nearly_everything():
    """Dense greedy self-speculation drafts with the verifier itself: every
    draft lands but where a request's budget cuts the window (13 tokens =
    3 rounds of 4 + a round of 1), as in JAX."""
    prompts = [np.arange(1, 6)] * 4
    t, teng, j, jeng = run_both(prompts, 13, mod=False, batch_size=4, ctx=32, page_size=4,
                                prefill_chunk=4, speculate=3)
    assert t == j
    st = teng.stats()
    assert st["speculative_accept_rate"] >= 0.75
    assert st["speculative_tokens_per_round"] > 2.0
    assert_stats_equal(st, jeng.stats())
