"""The port's chunked (resumable) prefill on the CPU against the JAX
package: ``skip_block.routed_attention_chunk`` and ``model.prefill_chunk``
chunk by chunk, chunked against the port's own monolithic prefill (the
reference's bounds), the scheduler's chunk planner (``plan_step`` with
``token_budget``, ``prefill_advance``, ``abort_prefill``) on the same call
sequences as the reference's ``Scheduler``, and the continuous engine at
``prefill_chunk`` 8 against the reference's engine: dense and paged, the
in-flight abort under page pressure, budget deferral, fused epochs.

Tolerances: gate logs, tokens, engine statistics, the paged store's entry
metadata (pos, l0, l1 pages) and planner traces exactly; fp32 activations
and logits ≤ 1e-4·max|ref| and the cache rows a chunk writes ≤ 1e-5·max
(sums in another order); chunked against the port's monolithic prefill
the reference's own bounds (``tests/test_chunked_prefill.py``: logits
within 2e-2 absolute and relative, equal argmax, cache rows within 1e-5).
Routers are redrawn at unit scale with zero bias, so routing really skips
(fp32 smoke config).  The reference's engines are shared by compiled
geometry: its engine reads ``decode_steps`` and ``step_tokens`` only at
run time, so one engine serves runs that differ in them, and each run
gets a fresh engine's host state (scheduler, page allocator, no stashed
store), its compiled steps kept.  Its engine is handed a ``jax.numpy``
whose ``asarray`` copies numpy arrays (``tests/test_torch_decode_loop.py``
says why)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import skip_block as jskip
from repro.kvcache import paged as jpaged
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import skip_block
from repro_torch.kvcache import paged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.quant import quantize_params
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.errors import ConfigError

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4             # x max|ref|: fp32 activations and logits
TOL_CACHE = 1e-5       # x max|ref|: the cache rows a chunk writes
CAP = 24               # the model-level staging caches' rows
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
# the reference's chunk functions, jitted once for the module
JCHUNK_BLOCK = jax.jit(partial(jskip.routed_attention_chunk, cfg=JCFG))
JPREFILL_CHUNK = jax.jit(partial(jmodel.prefill_chunk, cfg=JCFG))
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "epoch_shrinks", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "page_size", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer")


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


@pytest.fixture(scope="module")
def world():
    """(reference numpy tree, its jnp copy, the port's model)."""
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
    fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return ref, jax.tree_util.tree_map(jnp.asarray, ref), model


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, want, tol=TOL):
    out, want = np.asarray(out, np.float32), np.asarray(want, np.float32)
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _ref_layers(jparams):
    """The reference's per-layer blocks (stage0, then each slice of the
    scan-stacked stages)."""
    out = [jparams["stack"]["stage0"]["pos0"]]
    st = jparams["stack"]["stages"]["pos0"]
    n = jax.tree_util.tree_leaves(st)[0].shape[0]
    out += [jax.tree_util.tree_map(lambda a, i=i: a[i], st) for i in range(n)]
    return out


def _jcache_layers(jcache):
    s0, st = jcache["stage0"]["pos0"], jcache["stages"]["pos0"]
    return [(s0["k"], s0["v"])] + [(st["k"][a], st["v"][a])
                                   for a in range(st["k"].shape[0])]


# ---------------------------------------------------------------------------
# Block and model level against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,t0,layer", [(4, 0, 0), (8, 0, 1), (4, 5, 1),
                                        (8, 5, 0)])
def test_routed_attention_chunk_matches_reference(world, C, t0, layer):
    """One chunk of C tokens at offset t0 through one routed attention
    block, over a cache holding a random prefix [0, t0), with a carried
    cross-layer view and Σy² carry past layer 0: the gate identical, x
    and the carry ≤ 1e-4·max, the cache rows [t0, t0 + C) ≤ 1e-5·max and
    every other row untouched."""
    _, jparams, model = world
    B, cap = 2, 16
    Hkv, dh = CFG.num_kv_heads, CFG.resolved_head_dim
    x = _x((B, C, CFG.d_model), seed=C + t0)
    kc, vc = _x((B, cap, Hkv, dh), 1), _x((B, cap, Hkv, dh), 2)
    kc[:, t0:], vc[:, t0:] = 0.0, 0.0
    prev = ((_x((B, C, Hkv, dh), 3), _x((B, C, Hkv, dh), 4)) if layer
            else None)
    sq = (x ** 2).mean(-1) * 1.5 if layer else None
    pos = np.broadcast_to(np.arange(t0, t0 + C, dtype=np.int32),
                          (B, C)).copy()
    t = torch.from_numpy
    out = skip_block.routed_attention_chunk(
        model.params()["blocks"][layer]["mixer"], t(x), t(kc.copy()),
        t(vc.copy()), torch.full((B,), t0, dtype=torch.int32),
        None if prev is None else (t(prev[0]), t(prev[1])), t(pos), CFG,
        carried_sq=None if sq is None else t(sq))
    jout = JCHUNK_BLOCK(_ref_layers(jparams)[layer]["mixer"], jnp.asarray(x),
               jnp.asarray(kc), jnp.asarray(vc), jnp.int32(t0),
               None if prev is None else tuple(map(jnp.asarray, prev)),
               jnp.asarray(pos),
               carried_sq=None if sq is None else jnp.asarray(sq))
    (x1, k1, v1, view, s), (jx1, jk1, jv1, jview, js) = out, jout
    np.testing.assert_array_equal(s["attn_gate"].numpy(),
                                  np.asarray(js["attn_gate"]))
    assert 0.0 < float(s["attn_gate"].mean()) < 1.0 or layer == 0
    _close(x1, jx1)
    _close(s["res_sq"], js["res_sq"])
    for a, b in zip(view, jview):
        _close(a, b, TOL_CACHE)
    for c, jc, orig in ((k1, jk1, kc), (v1, jv1, vc)):
        _close(c[:, t0:t0 + C], np.asarray(jc)[:, t0:t0 + C], TOL_CACHE)
        np.testing.assert_array_equal(c[:, :t0].numpy(), orig[:, :t0])
        np.testing.assert_array_equal(c[:, t0 + C:].numpy(),
                                      orig[:, t0 + C:])


def _port_chunked(params, cfg, p, C):
    """model.prefill_chunk over a prompt (the last chunk right-padded).
    Returns (per-chunk logits, cache, gates [L, 1, Tp])."""
    T0 = len(p)
    cache = pmodel.init_chunk_cache(cfg, 1, CAP, "cpu")
    logits, gates = [], []
    for s in range(0, T0, C):
        c = len(p[s:s + C])
        padded = np.pad(p[s:s + C], (0, C - c))
        lg, cache, st = pmodel.prefill_chunk(
            params, cache, torch.from_numpy(padded[None]).long(), s, cfg,
            last_index=torch.tensor([c - 1]))
        logits.append(lg)
        gates.append(st["attn_gate"].numpy())
    return logits, cache, np.concatenate(gates, axis=2)


@pytest.mark.parametrize("T0,C", [(13, 4), (16, 8), (21, 8)])
def test_prefill_chunk_matches_reference(world, T0, C):
    """``prefill_chunk`` chunk by chunk against the reference's, the last
    chunk right-padded where C does not divide T0: each chunk's gate log
    identical, its logits ≤ 1e-4·max, every layer's cache rows of the
    prompt ≤ 1e-5·max."""
    _, jparams, model = world
    (p,) = _prompts([T0], seed=T0)
    logits, cache, gates = _port_chunked(model.params(), CFG, p, C)
    jcache = jmodel.init_chunk_cache(JCFG, 1, CAP)
    for i, s in enumerate(range(0, T0, C)):
        c = len(p[s:s + C])
        padded = np.pad(p[s:s + C], (0, C - c))
        jlg, jcache, jst = JPREFILL_CHUNK(jparams, jcache,
                               {"tokens": jnp.asarray(padded[None])},
                               jnp.int32(s),
                               last_index=jnp.asarray([c - 1], jnp.int32))
        np.testing.assert_array_equal(gates[:, :, s:s + C],
                                      np.asarray(jst["attn_gate"]))
        _close(logits[i], jlg)
    for ce, (jk, jv) in zip(cache, _jcache_layers(jcache)):
        _close(ce["k"][:, :T0], np.asarray(jk)[:, :T0], TOL_CACHE)
        _close(ce["v"][:, :T0], np.asarray(jv)[:, :T0], TOL_CACHE)


@pytest.mark.parametrize("T0,C,int4", [(21, 8, False), (16, 16, False),
                                       (13, 4, False), (7, 16, False),
                                       (19, 8, True)])
def test_prefill_chunk_matches_monolithic(world, T0, C, int4):
    """Chunked against the port's monolithic ``prefill`` with the
    reference's bounds (``tests/test_chunked_prefill.py``): gate log
    identical, logits within 2e-2, argmax equal, every layer's cache rows
    within 1e-5; non-dividing chunks, one oversized chunk (T0 < C) and
    int4 weights (every linear and the lm head, group 64)."""
    params = world[2].params()
    if int4:
        params = quantize_params(params, 64, True, min_size=1 << 12)
        assert "w_int" in params["lm_head"]
    (p,) = _prompts([T0], seed=T0 + 1)
    lg_mono, cache_mono, st_mono = pmodel.prefill(
        params, torch.from_numpy(p[None]).long(), CFG)
    logits, cache, gates = _port_chunked(params, CFG, p, C)
    np.testing.assert_array_equal(st_mono["attn_gate"].numpy(),
                                  gates[:, :, :T0])
    np.testing.assert_allclose(logits[-1].numpy(), lg_mono.numpy(),
                               rtol=2e-2, atol=2e-2)
    assert int(logits[-1].argmax()) == int(lg_mono.argmax())
    for a, b in zip(cache_mono, cache):
        for k in ("k", "v"):
            np.testing.assert_allclose(b[k][:, :T0].numpy(), a[k].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_chunk_refusals():
    """A stack that is not all global attention cannot chunk:
    ``init_chunk_cache`` raises ``ValueError`` (as the reference's), and
    the engine refuses ``prefill_chunk`` > 0 on mamba2-2.7b with
    ``ConfigError`` (a ``ValueError``, naming prefill_chunk=0)."""
    mcfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                               dtype="float32")
    with pytest.raises(ValueError, match="all-global-attn"):
        pmodel.init_chunk_cache(mcfg, 1, 32, "cpu")
    with pytest.raises(ValueError, match="all-global-attn"):
        jmodel.init_chunk_cache(jget_config("mamba2-2.7b").smoke(), 1, 32)
    m = LanguageModel(mcfg, device="cpu", seed=0)
    with pytest.raises(ConfigError, match="prefill_chunk=0"):
        ContinuousBatchingEngine(m, max_slots=1, max_len=32, prefill_chunk=8)
    assert ContinuousBatchingEngine(m, max_slots=1, max_len=32,
                                    prefill_chunk=0).prefill_chunk == 0
    assert not tsched.can_chunk_prefill(mcfg)
    assert tsched.can_chunk_prefill(CFG)


# ---------------------------------------------------------------------------
# The scheduler's planner against the reference's, call for call
# ---------------------------------------------------------------------------

def _chunks(mod):
    sched = mod.Scheduler(max_slots=2, max_len=64, prefill_chunk=8)
    sched.submit(mod.Request(uid=0, tokens=np.arange(21, dtype=np.int32),
                             max_new_tokens=4))
    seen = []
    while True:
        plan = sched.plan_step()
        if plan.prefill is None:
            break
        w = plan.prefill
        seen.append((w.start, w.tokens.tolist(), w.is_first, w.is_last,
                     w.slot, plan.tokens))
        sched.prefill_advance(w)
    seen.append((sched.prefilling, sched.has_work(), sched.free_slots))
    return seen


def _whole(mod):
    sched = mod.Scheduler(max_slots=1, max_len=64)
    sched.submit(mod.Request(uid=0, tokens=np.zeros(21, np.int32),
                             max_new_tokens=4))
    plan = sched.plan_step()
    w = plan.prefill
    return [(w.start, len(w.tokens), w.is_first, w.is_last, plan.tokens)]


def _budget(mod):
    sched = mod.Scheduler(max_slots=3, max_len=64, prefill_chunk=8)
    sched.activate(mod.ActiveRequest(
        req=mod.Request(uid=9, tokens=np.zeros(4, np.int32),
                        max_new_tokens=32), slot=2, pos=4))
    for uid, n in ((0, 16), (1, 6)):
        sched.submit(mod.Request(uid=uid, tokens=np.zeros(n, np.int32),
                                 max_new_tokens=4))
    trace = []
    for budget, steps in ((4, 1), (4, 1), (4, 1), (9, 1), (12, 4), (20, 4),
                          (None, 8), (1, 1), (1, 1)):
        plan = sched.plan_step(token_budget=budget, decode_steps=steps)
        w = plan.prefill
        trace.append((plan.decode_slots, plan.tokens,
                      None if w is None else (w.req.uid, w.slot, w.start,
                                              len(w.tokens), w.is_last)))
        if w is not None:
            sched.prefill_advance(w)
            if w.is_last:
                sched.activate(mod.ActiveRequest(req=w.req, slot=w.slot,
                                                 pos=w.req.prompt_len))
    # without decode work the budget never blocks prefill
    sched2 = mod.Scheduler(max_slots=1, max_len=64, prefill_chunk=8)
    sched2.submit(mod.Request(uid=1, tokens=np.zeros(16, np.int32),
                              max_new_tokens=4))
    trace.append(sched2.plan_step(token_budget=1).prefill is not None)
    return trace


def _can_place(mod):
    sched = mod.Scheduler(max_slots=2, max_len=64, prefill_chunk=8)
    sched.submit(mod.Request(uid=0, tokens=np.zeros(8, np.int32),
                             max_new_tokens=4))
    trace = []
    plan = sched.plan_step(can_place=lambda r: False)
    trace.append((plan.prefill is None, len(sched.queue)))
    plan = sched.plan_step(can_place=lambda r: True)
    trace.append((plan.prefill is not None, len(sched.queue)))
    return trace


def _abort(mod):
    """An in-flight prompt aborted after its first chunk (requeued at its
    age and prefilled again from its first chunk), and aborted again on
    its second try."""
    sched = mod.Scheduler(max_slots=2, max_len=64, prefill_chunk=4)
    for uid, n in ((0, 10), (1, 6)):
        sched.submit(mod.Request(uid=uid, tokens=np.zeros(n, np.int32),
                                 max_new_tokens=4))
    trace = []
    plan = sched.plan_step()
    sched.prefill_advance(plan.prefill)
    pf = sched.abort_prefill()
    trace.append((pf.req.uid, pf.slot, pf.done, sched.free_slots,
                  [r.uid for r in sched.queue]))
    plan = sched.plan_step()
    w = plan.prefill
    trace.append((w.req.uid, w.slot, w.start, w.is_first))
    pf = sched.abort_prefill()
    trace.append((pf.req.uid, pf.done, [r.uid for r in sched.queue],
                  sched.has_work()))
    return trace


def _epoch_costing(mod):
    """``decode_steps`` costing with chunks
    (``tests/test_decode_loop.py:293``'s twin at prefill_chunk 4)."""
    sched = mod.Scheduler(max_slots=4, max_len=64, prefill_chunk=4)
    for uid, n in enumerate((4, 8, 6)):
        sched.submit(mod.Request(uid=uid, tokens=np.zeros((n,), np.int32),
                                 max_new_tokens=4))
    trace = []
    for steps in (1, 8, 4, 2, 8, 1, 4):
        plan = sched.plan_step(token_budget=12, decode_steps=steps)
        w = plan.prefill
        trace.append((plan.decode_slots, plan.decode_steps, plan.tokens,
                      None if w is None else (w.req.uid, w.start)))
        if w is not None:
            sched.prefill_advance(w)
            if w.is_last:
                sched.activate(mod.ActiveRequest(req=w.req, slot=w.slot,
                                                 pos=w.req.prompt_len))
    return trace


@pytest.mark.parametrize("script", [_chunks, _whole, _budget, _can_place,
                                    _abort, _epoch_costing])
def test_planner_matches_reference(script):
    """Chunk metering, the whole prompt when chunking is off, the budget's
    one-step deferral that never starves, admission gated by
    ``can_place``, the in-flight abort, and ``decode_steps`` costing: the
    port's planner gives the reference's trace call for call."""
    mine, theirs = script(tsched), script(jsched)
    assert mine == theirs
    if script is _chunks:
        assert [s[:4] for s in mine[:3]] == [
            (0, list(range(8)), True, False), (8, list(range(8, 16)),
                                               False, False),
            (16, list(range(16, 21)), False, True)]
    if script is _budget:
        assert mine[0][2] is None and mine[1][2] is not None


# ---------------------------------------------------------------------------
# Engines against the reference's engines
# ---------------------------------------------------------------------------

RUN_LEVERS = ("decode_steps", "step_tokens")


@pytest.fixture(scope="module")
def ref_engines(world):
    """The reference's engines by compiled geometry, built once for the
    module.  Each run gets ``decode_steps`` and ``step_tokens``, which the
    engine reads only at run time, and a fresh engine's host state: a new
    scheduler and page allocator and no stashed store (a drained engine
    keeps its allocator's counters and free-list order, and its store)."""
    engines = {}

    def get(**kw):
        levers = {k: kw.pop(k, None) for k in RUN_LEVERS}
        key = tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = jengine.ContinuousBatchingEngine(
                JCFG, world[1], **kw)
        eng = engines[key]
        eng.decode_steps = levers["decode_steps"] or 1
        eng.step_tokens = levers["step_tokens"]
        eng.scheduler = jsched.Scheduler(
            eng.max_slots, eng.max_len, buckets=eng.scheduler.buckets,
            prefill_chunk=eng.prefill_chunk)
        if eng.kv_mode == "paged":
            eng.allocator = jpaged.PageAllocator(
                eng.num_pages, eng.page_size, eng.max_slots,
                slot_entry_capacity=eng.max_len * eng.n_attn)
            eng._store = None
        return eng

    return get


class _StoreRecorder:
    """Wraps ``paged.init_store`` to keep the store a port run builds."""

    def __init__(self, monkeypatch):
        self.stores, orig = [], paged.init_store

        def rec(*a, **k):
            self.stores.append(orig(*a, **k))
            return self.stores[-1]
        monkeypatch.setattr(paged, "init_store", rec)


def _drive(eng, prompts, budgets):
    uids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    res = eng.run()
    return ([res["results"][u].tokens for u in uids],
            [res["results"][u] for u in uids], res["stats"], eng)


def _run_pair(world, ref_engines, monkeypatch, prompts, budgets, **kw):
    """The same submits through the port's engine and the reference's:
    tokens, every STATS field, each request's finish reason and KV
    accounting equal; paged, every page back and the store's entry
    metadata equal."""
    rec = _StoreRecorder(monkeypatch)
    mine = _drive(ContinuousBatchingEngine(world[2], **kw), prompts, budgets)
    theirs = _drive(ref_engines(**kw), prompts, budgets)
    (toks, res, st, eng), (jtoks, jres, jst, jeng) = mine, theirs
    for a, b in zip(toks, jtoks):
        np.testing.assert_array_equal(a, b)
    for name in STATS:
        assert getattr(st, name) == getattr(jst, name), name
    for r, jr in zip(res, jres):
        assert (r.finish_reason, r.kv_stored, r.kv_dense) == \
            (jr.finish_reason, jr.kv_stored, jr.kv_dense)
    if eng.kv_mode == "paged":
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages
        (store,) = rec.stores
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(store[k].numpy(),
                                          np.asarray(jeng._store[k]), k)
    return st


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_engine_chunked_matches_reference(world, ref_engines, monkeypatch,
                                          kv_mode):
    """Prompts longer and shorter than the chunk, non-dividing lengths
    (9 → 2 chunks, 21 → 3, 5 → 1, 30 → 4), two slots: the port's engine at
    chunk 8 equals the reference's, and a resident decodes between a
    prompt's chunks."""
    geom = dict(max_slots=2, max_len=48, kv_mode=kv_mode, prefill_chunk=8,
                **({"page_size": 8} if kv_mode == "paged" else {}))
    st = _run_pair(world, ref_engines, monkeypatch, _prompts([9, 21, 5, 30]),
                   [5] * 4, **geom)
    assert st.prefill_chunks == 10 and st.interleaved_steps > 0


@pytest.mark.parametrize("lens,num_pages,aborts", [
    ((10, 12, 8), 12, 0), ((12, 6, 8), 12, 1)])
def test_engine_chunked_abort_under_pressure(world, ref_engines,
                                             monkeypatch, lens, num_pages,
                                             aborts):
    """The reference's pool (3 slots, max_len 32, 12 pages of 4, chunk 4)
    under page pressure: prompts 10/12/8 preempt a resident; with 12/6/8 a
    resident's headroom pass also aborts the in-flight chunked prefill
    (its pages released, the request requeued) on this model's weights.  Tokens and statistics equal the
    reference's, and the preemptions and aborts really ran."""
    st = _run_pair(world, ref_engines, monkeypatch, _prompts(list(lens)),
                   [8] * 3, max_slots=3, max_len=32, kv_mode="paged",
                   prefill_chunk=4, num_pages=num_pages, page_size=4)
    assert st.preemptions > 0 and st.prefill_aborts == aborts


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4, step_tokens=4),
                                dict(prefill_chunk=4, step_tokens=3),
                                dict(step_tokens=4)])
def test_engine_budget_deferral_matches_reference(world, ref_engines,
                                                  monkeypatch, kw):
    """``step_tokens`` defers prefill work past its admission iteration
    (chunked, and a monolithic prompt); the worst-case pages reserved at
    admission keep the run alive: tokens and statistics equal the
    reference's, and a deferral really ran."""
    st = _run_pair(world, ref_engines, monkeypatch, _prompts([10, 12, 8]),
                   [8] * 3, max_slots=3, max_len=32, kv_mode="paged",
                   num_pages=12, page_size=4, **kw)
    assert st.prefill_deferrals > 0


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_fused_engine_chunked_matches_reference(world, ref_engines,
                                                monkeypatch, kv_mode):
    """Fused 8-step epochs at chunk 8 (a chunk runs between epochs; dense
    first tokens stay on the device until the next epoch's sync): tokens
    and statistics equal the reference's fused engine, and the tokens
    equal the port's single-step chunked run."""
    geom = dict(max_slots=2, max_len=48, kv_mode=kv_mode, prefill_chunk=8,
                **({"page_size": 8} if kv_mode == "paged" else {}))
    prompts, budgets = _prompts([10, 5, 19, 14]), [8, 1, 8, 8]
    st = _run_pair(world, ref_engines, monkeypatch, prompts, budgets,
                   decode_steps=8, **geom)
    single = _drive(ContinuousBatchingEngine(world[2], **geom), prompts,
                    budgets)
    fused = _drive(ContinuousBatchingEngine(world[2], decode_steps=8,
                                            **geom), prompts, budgets)
    for a, b in zip(fused[0], single[0]):
        np.testing.assert_array_equal(a, b)
    assert st.prefill_chunks == 2 + 1 + 3 + 2
    assert fused[2].decode_dispatches < single[2].decode_dispatches


def test_launcher_prefill_chunk_on_cpu(capsys):
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--continuous", "--batch", "2", "--prompt-len", "20",
                       "--new-tokens", "4", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "requests: 4" in out and "chunked prefill:" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device",
                           "cpu", "--prefill-chunk", "8"])
