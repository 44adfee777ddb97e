"""The port's prefix cache on the CPU against the JAX package:
``kvcache/prefix.py`` (``PrefixCache``) on twin page allocators driven by
the same script, the paged store's prefix helpers (``copy_page_masked``,
``views_from_pages``, ``chunk_cache_from_views``) on fp32, int8 and int4
stores, and the continuous engine with ``prefix_cache`` on against the
reference's engine, run for run, in all four paged run loops (single-step
and fused × monolithic and chunk 8) over fp32, int8 and int4 pages; the
copy-on-write boundary page, eviction under page pressure, the store's
lifetime across runs and the refusals.

Tolerances: records, counters, refcounts, free lists, tokens, engine
statistics and the stores' entry metadata exactly; the helpers bit for bit
(int8 and int4 pages dequantize in exact power-of-two steps, so their views
are exact too).  Warm ≡ cold in tokens is checked on the port's own fp32
engines, as the reference's ``tests/test_prefix_cache.py`` does.  The
smoke llama2-7b runs at fp32 with zero router biases; the routers are
redrawn at unit scale (``tests/test_torch_chunked.py``) so no decision sits
at a near-tie that summation order could flip.  The reference's engines
run its jnp path (``use_kernels=False``, a third of the Pallas interpret
mode's time): what is under test here is engine and store logic, and the
port's kernels are held against the Pallas kernels elsewhere
(``tests/test_torch_kernels.py``).  The reference's engines are
shared by compiled geometry; each script starts them with a fresh engine's
host state (scheduler, page allocator, prefix cache, no stashed store), and
they are handed a ``jax.numpy`` whose ``asarray`` copies numpy arrays
(``tests/test_torch_decode_loop.py`` says why)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kvcache import paged as jpaged
from repro.kvcache import prefix as jprefix
from repro.models import model as jmodel
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kvcache import history, paged, prefix
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LanguageModel
from repro_torch.serve import config as tconfig
from repro_torch.serve.engine import ContinuousBatchingEngine

torch.set_num_threads(2)

SEED = 0
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=False)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "epoch_shrinks", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "page_size", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer",
         "prefix_hits", "prefix_misses", "prefix_tokens_saved",
         "prefix_records")


class _CopyingNumpy:
    """``jax.numpy`` whose ``asarray`` copies a numpy array."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


@pytest.fixture(autouse=True)
def _reference_copies_host_arrays(monkeypatch):
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())


def _world(redraw):
    """(the reference's jnp tree, the port's model) from seed-0 params:
    routers redrawn at unit scale with zero bias, or (``redraw`` False)
    the plain tree, whose warm-start bias keeps every token."""
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    if redraw:
        fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, ref), model


@pytest.fixture(scope="module")
def worlds():
    return {"skip": _world(True), "plain": _world(False)}


def _shared_prompts(prefix_len, tails, seed):
    """Prompts sharing a ``prefix_len``-token prefix with fresh tails."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, CFG.vocab_size, (prefix_len,), dtype=np.int32)
    return [np.concatenate(
        [head, rng.integers(0, CFG.vocab_size, (t,), dtype=np.int32)])
        for t in tails]


# ---------------------------------------------------------------------------
# PrefixCache against the reference's, on twin allocators
# ---------------------------------------------------------------------------

def _records(pc):
    return sorted((r.key, r.tokens, r.entries, r.pages, r.gates.tobytes(),
                   r.in_use, r.stamp) for r in pc._records.values())


def _state(pc):
    a = pc.alloc
    a.check_conservation(pc.page_pins())
    return (_records(pc), pc.hits, pc.misses, pc.tokens_saved, len(pc),
            a.refcount.tolist(), list(a._free), a.fill.tolist(),
            a.block_table.tolist(), pc.page_pins())


def _cache_script(mod, alloc_mod, block, reuse):
    """Publish, lookup (hits, misses, the len − 1 cap), pin, evict under a
    pin, a second prompt sharing a prefix, the record cap, clear: the
    state after every step."""
    a = alloc_mod.PageAllocator(num_pages=40, page_size=4, max_slots=3,
                                slot_entry_capacity=64)
    pc = mod.PrefixCache(a, block=block, reuse=reuse, max_records=9)
    rng = np.random.default_rng(block)
    nA = 2
    toks = rng.integers(0, 50, (13,)).astype(np.int32)
    gates = (rng.random((nA, 13)) < 0.5).astype(np.float32)
    trace = []
    n = alloc_mod.prefill_entry_count(gates, 13, reuse)
    assert a.ensure(0, n)
    trace.append(pc.publish(toks, gates, a.chain(0)))
    a.release(0)
    trace.append(_state(pc))
    for probe in (toks, toks[:7], np.concatenate([toks, [1, 2]]),
                  toks[::-1].copy(), toks[:1]):
        rec = pc.lookup(probe)
        trace.append(None if rec is None else (rec.length, rec.entries,
                                               rec.pages))
    rec = pc.lookup(np.concatenate([toks, [3]]))
    pc.pin(rec)
    trace.append([pc.evict_one() for _ in range(3)])
    trace.append(_state(pc))
    other = np.concatenate([toks[:8], rng.integers(50, 99, (9,))]).astype(
        np.int32)
    g2 = (rng.random((nA, 17)) < 0.5).astype(np.float32)
    assert a.ensure(1, alloc_mod.prefill_entry_count(g2, 17, reuse))
    trace.append(pc.publish(other, g2, a.chain(1)))
    trace.append(_state(pc))
    a.release(1)
    trace.append(pc.lookup(other) is not None)
    pc.unpin(rec)
    trace.append(pc.evict_one())
    trace.append(_state(pc))
    trace.append(pc.clear())
    trace.append(_state(pc))
    assert a.free_pages == a.num_pages
    return trace


@pytest.mark.parametrize("block,reuse", [(1, True), (3, True), (4, False),
                                         (5, True)])
def test_prefix_cache_matches_reference(block, reuse):
    """The same script on the port's ``PrefixCache`` over the port's
    allocator and on the reference's over the reference's: every record
    (key, tokens, entries, pages, gates, pins, LRU stamp), the hit, miss
    and saved-token counters, refcounts, free lists and conservation with
    the records' pins, step for step."""
    mine = _cache_script(prefix, paged, block, reuse)
    theirs = _cache_script(jprefix, jpaged, block, reuse)
    assert mine == theirs
    assert any(isinstance(t, tuple) for t in mine)    # a hit happened


# ---------------------------------------------------------------------------
# The store's prefix helpers against the reference's
# ---------------------------------------------------------------------------

def _jstore(kv_dtype, P=6, ps=8, seed=0):
    """A reference store with random payloads, scales and metadata."""
    rng = np.random.default_rng(seed)
    st = {k: np.asarray(v) for k, v in
          jpaged.init_store(JCFG, P, ps, kv_dtype=kv_dtype).items()}
    for k, v in st.items():
        if v.dtype == np.int8:
            st[k] = rng.integers(-128, 128, v.shape).astype(np.int8)
        elif k.endswith("scales"):
            st[k] = np.exp2(rng.integers(-6, 3, v.shape)).astype(np.float32)
        elif v.dtype == np.int32:
            st[k] = rng.integers(0, 40, v.shape).astype(np.int32)
        else:
            st[k] = rng.standard_normal(v.shape).astype(v.dtype)
    return st


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("src,dst,keep", [(1, 3, 5), (4, 0, 0), (2, 5, 8)])
def test_copy_page_masked_matches_reference(kv_dtype, src, dst, keep):
    """The copy on write of a boundary page (keep 5 of 8, none, all) on
    fp32, int8 and int4 stores: every leaf bit for bit the reference's,
    written in place (same storage, no leaf rebound) and the drop row
    unchanged."""
    st = _jstore(kv_dtype, seed=src + dst + keep)
    store = bridge.store_from_numpy(st)
    ptrs = {k: v.data_ptr() for k, v in store.items()}
    drops = {k: paged._with_drop_row(v)[-1].clone() for k, v in store.items()}
    out = paged.copy_page_masked(store, src, dst, keep)
    want = jpaged.copy_page_masked({k: jnp.asarray(v) for k, v in
                                    st.items()}, jnp.int32(src),
                                   jnp.int32(dst), jnp.int32(keep))
    assert out is store
    for k, v in store.items():
        assert v.data_ptr() == ptrs[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), k)
        assert torch.equal(paged._with_drop_row(v)[-1], drops[k])
    assert (store["pos_pages"][dst, keep:] == history.MASKED_POS).all()


@pytest.fixture(scope="module")
def packed(worlds):
    """A real fp32 prefill of a 19-token prompt (routers skipping; the
    port's, which the continuous tests hold against the reference's),
    packed by the reference's ``pack_prefill`` into its fp32, int8 and
    int4 stores at a scattered block table, with stale metadata past the
    fill."""
    model = worlds["skip"][1]
    (p,) = _shared_prompts(19, [0], seed=4)
    _, cache, pst = model.prefill(torch.from_numpy(p[None]).long())
    gates = pst["attn_gate"][:, 0].numpy()
    k, v = paged.prefill_views_from_cache(cache, CFG)
    jcache = jpaged.chunk_cache_from_views(jnp.asarray(k.numpy()),
                                           jnp.asarray(v.numpy()), JCFG)
    n = jpaged.prefill_entry_count(gates, 19, True)
    out = {}
    for kv_dtype in (None, "int8", "int4"):
        bt = np.array([7, 2, 9, 4, 0, 11, 5, 3], np.int32)
        store = jpaged.init_store(JCFG, 12, 8, kv_dtype=kv_dtype)
        store = jpaged.pack_prefill(store, jcache, jnp.asarray(gates), 19,
                                    jnp.asarray(bt), JCFG,
                                    kv_dtype=kv_dtype)
        st = {k: np.array(v) for k, v in store.items()}
        # a previous owner's entries past the fill: the fill masks them
        last, used = bt[(n - 1) // 8], (n - 1) % 8 + 1
        st["pos_pages"][last, used:] = np.arange(8 - used)
        st["l0_pages"][last, used:] = 0
        st["l1_pages"][last, used:] = 2
        out[kv_dtype] = (st, bt, n, gates)
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("live", [False, True])
def test_views_and_chunk_cache_match_reference(packed, kv_dtype, live):
    """``views_from_pages`` and ``chunk_cache_from_views`` on a store that
    the reference's ``pack_prefill`` filled from a real prefill (fp32,
    int8, int4 pages; stale entries past the fill): views and the staging
    cache layer by layer bit for bit the reference's, whether the port is
    given the whole block-table row or only the pages the fill uses (as
    its engine does); each layer's views hold exactly one entry per
    prompt token, and the positions past it are zero."""
    st, bt, n, gates = packed[kv_dtype]
    cap = 24
    jk, jv = jpaged.views_from_pages(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(bt),
        jnp.int32(n), JCFG, cap, kv_dtype=kv_dtype)
    row = bt[:-(-n // 8)] if live else bt
    k, v = paged.views_from_pages(bridge.store_from_numpy(st),
                                  torch.from_numpy(row), n, CFG, cap,
                                  kv_dtype=kv_dtype)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert (k[:, :19].abs().sum((-1, -2)) > 0).all()
    assert not k[:, 19:].any()
    cache = paged.chunk_cache_from_views(k, v, CFG)
    jcache = jpaged.chunk_cache_from_views(jk, jv, JCFG)
    jl = [(jcache["stage0"]["pos0"]["k"], jcache["stage0"]["pos0"]["v"])]
    jl += [(jcache["stages"]["pos0"]["k"][a], jcache["stages"]["pos0"]["v"][a])
           for a in range(jcache["stages"]["pos0"]["k"].shape[0])]
    assert len(cache) == len(jl) == CFG.num_layers
    for ce, (a, b) in zip(cache, jl):
        assert ce["k"].dtype == torch.float32 and ce["k"].shape == (
            1, cap, CFG.num_kv_heads, CFG.resolved_head_dim)
        np.testing.assert_array_equal(ce["k"].numpy(), np.asarray(a))
        np.testing.assert_array_equal(ce["v"].numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Engines against the reference's engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_engines(worlds):
    """The reference's prefix-cache engines by compiled geometry, built
    once for the module.  ``get`` hands one out with ``decode_steps`` set
    (read only at run time) and a fresh engine's host state: scheduler
    (its probe wired), page allocator, prefix cache, no warm admissions and
    no stashed store."""
    engines = {}

    def get(world, decode_steps=1, **kw):
        key = (world,) + tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = jengine.ContinuousBatchingEngine(
                JCFG, worlds[world][0], kv_mode="paged", **kw)
        eng = engines[key]
        eng.decode_steps = decode_steps
        eng.scheduler = jsched.Scheduler(
            eng.max_slots, eng.max_len, buckets=eng.scheduler.buckets,
            prefill_chunk=eng.prefill_chunk)
        eng.allocator = jpaged.PageAllocator(
            eng.num_pages, eng.page_size, eng.max_slots,
            slot_entry_capacity=eng.max_len * eng.n_attn)
        eng._store = None
        if eng.prefix is not None:
            eng.prefix = jprefix.PrefixCache(
                eng.allocator, block=eng.prefix.block,
                reuse=eng.prefix.reuse, max_records=eng.prefix.max_records)
            eng.scheduler.prefix_probe = eng._prefix_probe
            eng._warm_pending = {}
        return eng

    return get


def _no_leaks(eng):
    """Free pages + record-pinned pages tile the pool exactly."""
    pins = eng.prefix.page_pins() if eng.prefix is not None else {}
    eng.allocator.check_conservation(pins)
    assert eng.allocator.free_pages == eng.num_pages - len(pins)


def _drive(eng, prompts, budgets):
    uids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    res = eng.run()
    return [res["results"][u] for u in uids], res["stats"]


def _script_pair(worlds, ref_engines, world, script, decode_steps=1, **kw):
    """The same runs (each a list of (prompt, max_new_tokens)) on one port
    engine and one reference engine: after each run tokens, every STATS
    field, each request's finish reason and KV accounting, the records,
    the allocators and the stashed stores' entry metadata equal, and no
    page leaks.  Returns the port engine and its per-run stats."""
    mine = ContinuousBatchingEngine(worlds[world][1], kv_mode="paged",
                                    decode_steps=decode_steps, **kw)
    theirs = ref_engines(world, decode_steps=decode_steps, **kw)
    stats = []
    for run in script:
        prompts, budgets = zip(*run)
        res, st = _drive(mine, prompts, budgets)
        jres, jst = _drive(theirs, prompts, budgets)
        for r, jr in zip(res, jres):
            np.testing.assert_array_equal(r.tokens, jr.tokens)
            assert (r.finish_reason, r.kv_stored, r.kv_dense) == \
                (jr.finish_reason, jr.kv_stored, jr.kv_dense)
        for name in STATS:
            assert getattr(st, name) == getattr(jst, name), name
        assert _records(mine.prefix) == _records(theirs.prefix)
        assert mine.allocator.refcount.tolist() == \
            theirs.allocator.refcount.tolist()
        assert list(mine.allocator._free) == list(theirs.allocator._free)
        _no_leaks(mine)
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(mine._store[k].numpy(),
                                          np.asarray(theirs._store[k]), k)
        stats.append((st, res))
    return mine, stats


def _three_runs(seed=7):
    p1, p2 = _shared_prompts(24, (4, 6), seed)
    return p1, p2, [[(p1, 4)], [(p2, 8)],
                    [(np.concatenate([p2, p2[:3]]), 4)]]


@pytest.mark.parametrize("decode_steps,chunk,kv_dtype", [
    (1, 0, None), (1, 8, "int8"), (8, 0, "int4"), (8, 8, None)])
def test_engine_warm_prefix_matches_reference(worlds, ref_engines,
                                              decode_steps, chunk,
                                              kv_dtype):
    """``tests/test_prefix_cache.py``'s three runs (a cold publish, a warm
    admission over the 24-token prefix, a third prompt riding the
    republished longer prefix) on the port's engine and the reference's
    in each paged loop (single-step and fused, monolithic and chunk 8)
    and page format: equal run for run; the warm runs really hit; fp32
    pages give the tokens of a cold engine, bit for bit."""
    p1, p2, script = _three_runs()
    kw = dict(max_slots=2, max_len=48, page_size=8, prefix_cache=True,
              prefix_block=8, prefill_chunk=chunk, kv_dtype=kv_dtype)
    eng, stats = _script_pair(worlds, ref_engines, "skip", script,
                              decode_steps=decode_steps, **kw)
    (s1, _), (s2, r2), (s3, _) = stats
    assert (s1.prefix_hits, s1.prefix_misses) == (0, 1)
    assert s1.prefix_records > 0
    assert (s2.prefix_hits, s2.prefix_tokens_saved) == (1, 24)
    assert s3.prefix_hits == 1 and s3.prefix_tokens_saved == 24
    if kv_dtype is None:
        cold = ContinuousBatchingEngine(
            worlds["skip"][1], kv_mode="paged", decode_steps=decode_steps,
            **dict(kw, prefix_cache=False))
        (want,), _ = _drive(cold, [p2], [8])
        np.testing.assert_array_equal(r2[0].tokens, want.tokens)
        assert (r2[0].kv_stored, r2[0].kv_dense) == (want.kv_stored,
                                                     want.kv_dense)


def test_engine_cow_boundary_matches_reference(worlds, ref_engines,
                                               monkeypatch):
    """A record whose entries end mid-page forces the copy on write
    (plain params: every gate fires, 2 entries a token; block 2, page 16):
    equal to the reference's engine, the copy really ran, and the warm
    tokens equal a cold engine's."""
    p1, p2 = _shared_prompts(10, (2, 4), seed=3)
    copies = []
    orig = paged.copy_page_masked

    def counted(store, src, dst, keep):
        copies.append((src, dst, keep))
        return orig(store, src, dst, keep)

    monkeypatch.setattr(paged, "copy_page_masked", counted)
    kw = dict(max_slots=2, max_len=48, page_size=16, prefix_cache=True,
              prefix_block=2)
    eng, stats = _script_pair(worlds, ref_engines, "plain",
                              [[(p1, 2)], [(p2, 6)]], **kw)
    assert stats[1][0].prefix_hits == 1
    assert len(copies) == 1 and copies[0][2] % 16 != 0
    cold = ContinuousBatchingEngine(worlds["plain"][1], kv_mode="paged",
                                    **dict(kw, prefix_cache=False))
    (want,), _ = _drive(cold, [p2], [6])
    np.testing.assert_array_equal(stats[1][1][0].tokens, want.tokens)


@pytest.mark.parametrize("decode_steps", [1, 8])
def test_engine_tight_pool_matches_reference(worlds, ref_engines,
                                             monkeypatch, decode_steps):
    """A pool too small for everyone (4 slots, 12 pages of 8 for
    ``tests/test_prefix_cache.py``'s 4 prompts sharing a 16-token prefix,
    24 tokens each): records are evicted and residents preempted,
    single-step and fused; equal to the reference's engine, no preemption
    while an unpinned record was left to evict, every page conserved, and
    the tokens those of a roomy cold engine."""
    prompts = _shared_prompts(16, (4, 6, 8, 2), seed=11)
    events = []
    evict = prefix.PrefixCache.evict_one
    preempt = ContinuousBatchingEngine._preempt_youngest

    def evicted(pc):
        out = evict(pc)
        if out is not None:
            events.append("evict")
        return out

    def preempted(eng, rs, exclude):
        idle = [r for r in eng.prefix._records.values() if not r.in_use]
        events.append("preempt" if not idle else "preempt-with-records")
        return preempt(eng, rs, exclude)

    monkeypatch.setattr(prefix.PrefixCache, "evict_one", evicted)
    monkeypatch.setattr(ContinuousBatchingEngine, "_preempt_youngest",
                        preempted)
    kw = dict(max_slots=4, max_len=48, page_size=8, prefix_cache=True,
              prefix_block=8, num_pages=12)
    eng, stats = _script_pair(worlds, ref_engines, "skip",
                              [[(p, 24) for p in prompts]],
                              decode_steps=decode_steps, **kw)
    st, res = stats[0]
    assert "evict" in events and "preempt" in events, events
    assert "preempt-with-records" not in events
    assert st.preemptions > 0 and st.prefix_hits > 0
    roomy = ContinuousBatchingEngine(worlds["skip"][1], max_slots=4,
                                     max_len=48, kv_mode="paged")
    want, _ = _drive(roomy, prompts, [24] * 4)
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r.tokens, w.tokens)
    eng.prefix.clear()
    eng.allocator.check_conservation()
    assert eng.allocator.free_pages == eng.num_pages


# ---------------------------------------------------------------------------
# The store's lifetime, refusals, the launcher
# ---------------------------------------------------------------------------

def test_store_outlives_a_run_and_a_raise_drops_it(worlds, monkeypatch):
    """A clean run stashes its store and the next takes it (one store for
    three runs).  A run made to raise in the warm suffix's
    ``prefill_chunk`` stashes nothing; the next run starts from a zeroed
    store with an empty cache: the dead run's request is requeued and
    prefilled cold (a miss, no hit), its tokens a cold engine's, and the
    pool is conserved with the new records' pins."""
    model = worlds["skip"][1]
    made = []
    init = paged.init_store

    def recorded(*a, **k):
        made.append(init(*a, **k))
        return made[-1]

    monkeypatch.setattr(paged, "init_store", recorded)
    p1, p2, script = _three_runs(seed=9)
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                   kv_mode="paged", page_size=8,
                                   prefix_cache=True, prefix_block=8)
    for run in script:
        _drive(eng, *zip(*run))
        assert eng._store is made[0]
        _no_leaks(eng)
    assert len(made) == 1 and len(eng.prefix) > 0

    def broken(*a, **k):
        raise RuntimeError("chunk forward failed")

    eng.submit(np.concatenate([p2, [5, 6, 7]]).astype(np.int32), 6)
    model.prefill_chunk = broken
    try:
        with pytest.raises(RuntimeError, match="chunk forward failed"):
            eng.run()
    finally:
        del model.prefill_chunk
    assert eng._store is None and eng._warm_pending
    out = eng.run()
    st = out["stats"]
    assert len(made) == 2 and eng._store is made[1]
    assert (st.prefix_hits, st.prefix_misses) == (0, 1)
    assert not eng._warm_pending and st.requests_completed == 1
    _no_leaks(eng)
    cold = ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                    kv_mode="paged", page_size=8)
    (want,), _ = _drive(cold, [np.concatenate([p2, [5, 6, 7]]).astype(
        np.int32)], [6])
    (got,) = out["results"].values()
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_prefix_refusals(worlds):
    """``prefix_cache`` without paged KV is refused by the config, and on
    mamba2-2.7b (no KV to page) by the engine, with the reference's
    exception types."""
    for mod in (tconfig, jconfig):
        with pytest.raises(mod.ConfigError, match="paged"):
            mod.EngineConfig(kv=mod.KVConfig(kv_mode="dense",
                                             prefix_cache=True))
    mcfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                               dtype="float32")
    m = LanguageModel(mcfg, device="cpu", seed=0)
    with pytest.raises(ValueError) as mine:
        ContinuousBatchingEngine(m, max_slots=1, max_len=32,
                                 kv_mode="paged", prefix_cache=True)
    jm = jget_config("mamba2-2.7b").smoke()
    with pytest.raises(ValueError) as theirs:
        jengine.ContinuousBatchingEngine(jm, None, max_slots=1, max_len=32,
                                         kv_mode="paged", prefix_cache=True)
    assert type(mine.value).__name__ == type(theirs.value).__name__


def test_launcher_prefix_cache_on_cpu(capsys):
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--continuous", "--paged-kv", "--prefix-cache",
                       "--batch", "2", "--prompt-len", "40",
                       "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "requests: 4" in out and "prefix cache: 3 warm / 1 cold" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device",
                           "cpu", "--continuous", "--prefix-cache"])
