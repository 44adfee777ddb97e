"""The port's self-speculative decoding on the CPU against the JAX package:
``core/routing.draft_router_bias``, the host accept functions of
``serve/sampling.py``, ``can_speculate``, the model's ``verify_chunk``,
``paged_verify_chunk`` (fp32, int8 and int4 pages),
``commit_verified``, ``draft_loop`` and ``paged_draft_loop``, and the
continuous engine with ``spec_k`` > 0 against the reference's speculative
engine (dense and paged, monolithic and chunk 8) and against the port's
own plain engine; the reference's behavioural contract (overridden drafts,
a mid-window stop, preemption, rollback invariants, the warm prefix, the
fused greedy commit, the refusals) and a temperature > 0 run.

Tolerances: tokens, gates, accept outputs, engine statistics, fills, page
state and the store's leaves after a commit of the same window views
exactly; logits ≤ 1e-4·max|ref|, window KV views ≤ 1e-5·max|ref| (fp32
sums in another order).  Stochastic output is checked by its statistics,
never by bits (the accept test's uniforms come from a torch.Generator,
the reference's from JAX keys).  The smoke llama2-7b runs at fp32 with
the routers redrawn at unit scale and zero bias, so routing really skips
and no decision sits at a near-tie.  The reference's engines run its jnp
path (``use_kernels=False``): what is under test is engine and store
logic; the port's kernels are held against the Pallas kernels elsewhere.
They are shared by compiled geometry, each script starting them with a
fresh engine's host state, and are handed a ``jax.numpy`` whose
``asarray`` copies numpy arrays (``tests/test_torch_decode_loop.py`` says
why)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import routing as jrouting
from repro.kvcache import paged as jpaged
from repro.kvcache import prefix as jprefix
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import sampling as jsampling
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import routing
from repro_torch.kvcache import paged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve import sampling
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ContinuousBatchingEngine

torch.set_num_threads(2)

SEED = 0
TOL_LOGITS = 1e-4
TOL_KV = 1e-5
LENS = (9, 14, 5, 11)
MAX_NEW = 10
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=False)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "attn_keep_frac", "kv_saved_fraction", "kv_mode", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer",
         "prefix_hits", "prefix_misses", "prefix_tokens_saved",
         "spec_windows", "spec_tokens_drafted", "spec_tokens_accepted",
         "spec_entries_rolled_back", "spec_acceptance_rate")


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


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def world():
    """(the reference's numpy tree, its jnp copy, the port's model) from
    seed-0 params, routers redrawn at unit scale with zero bias."""
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


def _close(out, want, tol):
    out, want = np.asarray(out, np.float32), np.asarray(want, np.float32)
    assert out.shape == want.shape, (out.shape, want.shape)
    assert np.abs(out - want).max() <= tol * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# 1-2. The draft lever, the accept functions, the exactness condition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_draft_router_bias_matches_reference(world, keep):
    """The draft view's router biases equal the reference's (bridged) bit
    for bit, and every other leaf is the verifier's own tensor; at keep
    1.0 the view is the params themselves."""
    ref, _, model = world
    params = model.params()
    mine = routing.draft_router_bias(params, keep)
    theirs = bridge.from_reference(jax.tree_util.tree_map(
        np.asarray, jrouting.draft_router_bias(ref, keep)), CFG)
    if keep == 1.0:
        assert mine is params
        return
    n_bias = 0
    for (path, a), (_, b), (_, c) in zip(_leaves(mine), _leaves(params),
                                         _leaves(theirs)):
        if path[-2:] == ("router", "b"):
            assert torch.equal(a, c) and not torch.equal(a, b)
            n_bias += 1
        else:
            assert a is b, path
    assert n_bias == 2 * CFG.num_layers


def _leaves(tree, path=()):
    """(path, tensor) pairs of a nested dict/list, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                               path + (i,))]
    return [(path, tree)]


def _dirichletish(rng, n, V):
    p = rng.random((n, V)) ** 3 + 1e-9
    return p / p.sum(-1, keepdims=True)


def test_accept_functions_match_reference():
    """The six host functions against the reference's on seeded inputs
    (equal outputs), and the reference's fixed cases on the port's."""
    rng = np.random.default_rng(4)
    for V, k in ((2, 1), (7, 3), (33, 5)):
        p_d, p_t = _dirichletish(rng, k, V), _dirichletish(rng, k + 1, V)
        logits = rng.standard_normal((3, k + 1, V)) * 4
        for fn, args in ((sampling.softmax_probs, (logits, 0.7)),
                         (sampling.residual_distribution, (p_d, p_t[:k])),
                         (sampling.emitted_distribution, (p_d, p_t[:k]))):
            np.testing.assert_array_equal(
                fn(*args), getattr(jsampling, fn.__name__)(*args))
        tgt = rng.integers(0, V, (4, k + 1))
        drafts = np.where(rng.random((4, k)) < 0.6, tgt[:, :k],
                          rng.integers(0, V, (4, k)))
        for a, b in zip(sampling.greedy_verify(tgt, drafts),
                        jsampling.greedy_verify(tgt, drafts)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        for u in rng.random(6):
            assert sampling.inverse_cdf_sample(p_t[0], u) == \
                jsampling.inverse_cdf_sample(p_t[0], u)
        for _ in range(8):
            d = rng.integers(0, V, (k,))
            args = (d, p_d, p_t, rng.random(k), rng.random(k + 1))
            assert sampling.speculative_accept_window(*args) == \
                jsampling.speculative_accept_window(*args)

    # tests/test_speculative.py's fixed cases
    for V in (2, 7, 33):
        p_d, p_t = _dirichletish(rng, 5, V), _dirichletish(rng, 5, V)
        np.testing.assert_allclose(sampling.emitted_distribution(p_d, p_t),
                                   p_t, atol=1e-12)
    p_d, p_t = _dirichletish(rng, 4, 9), _dirichletish(rng, 4, 9)
    res = sampling.residual_distribution(p_d, p_t)
    assert (res >= 0.0).all() and not res[p_d >= p_t].any()
    np.testing.assert_allclose(res.sum(-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(sampling.residual_distribution(p_t, p_t),
                               p_t, atol=1e-12)
    acc, cor = sampling.greedy_verify(
        np.array([[3, 5, 7, 9], [3, 5, 7, 9], [1, 1, 1, 1]]),
        np.array([[3, 5, 7], [3, 4, 7], [0, 1, 1]]))
    np.testing.assert_array_equal(acc, [3, 1, 0])
    np.testing.assert_array_equal(cor, [9, 5, 1])
    p = np.full((4, 6), 1.0 / 6)
    drafts = np.array([2, 4, 1])
    a, emitted = sampling.speculative_accept_window(
        drafts, p[:3], p, np.zeros(3), np.full(4, 0.99))
    assert a == 3 and emitted[:3] == [2, 4, 1]
    assert emitted[3] == sampling.inverse_cdf_sample(p[3], 0.99)
    p_t = p.copy()
    p_t[0, 2] = 0.0
    p_t[0] /= p_t[0].sum()
    a, emitted = sampling.speculative_accept_window(
        drafts, p[:3], p_t, np.zeros(3), np.full(4, 0.5))
    assert a == 0 and emitted == [sampling.inverse_cdf_sample(
        sampling.residual_distribution(p[0], p_t[0]), 0.5)] != [2]
    p = np.array([0.25, 0.0, 0.5, 0.25])
    cdf = np.cumsum(p)
    for u in (0.0, 0.2, 0.25, 0.5, 0.74, 0.999):
        i = sampling.inverse_cdf_sample(p, u)
        assert (cdf[i] > u or i == len(p) - 1) and p[i] > 0.0
        assert i == 0 or cdf[i - 1] <= u


def test_can_speculate_matches_reference():
    for name, over in (("llama2-7b", {}),
                       ("llama2-7b", {"kv_cache_layout": "bhtd"}),
                       ("mamba2-2.7b", {})):
        cfg = dataclasses.replace(get_config(name).smoke(), **over)
        jcfg = dataclasses.replace(jget_config(name).smoke(), **over)
        assert tsched.can_speculate(cfg) == jsched.can_speculate(jcfg)
    assert tsched.can_speculate(CFG)


# ---------------------------------------------------------------------------
# 3. Model level: verify, paged verify, commit, draft loops
# ---------------------------------------------------------------------------

POOL_LEN = 32


def _seed_pool(jparams, prompts, max_len=POOL_LEN):
    """Each prompt prefilled alone in the reference and inserted into a
    slot pool: (reference pool, the port's copy, first tokens, positions)."""
    jpool = jengine.init_pool(JCFG, len(prompts), max_len)
    feed, pos = [], []
    prefill = jax.jit(partial(jmodel.prefill, cfg=JCFG, pad_to=max_len))
    insert = jax.jit(partial(jengine.pool_insert, cfg=JCFG))
    for s, p in enumerate(prompts):
        lg, cache, _ = prefill(jparams, {"tokens": jnp.asarray(p[None])})
        jpool = insert(jpool, cache, s)
        feed.append(int(jnp.argmax(lg[0])))
        pos.append(len(p))
    return (jpool, _port_pool(jpool), np.asarray(feed, np.int32),
            np.asarray(pos, np.int32))


def _pool_layers(jpool):
    s0, st = jpool["stage0"]["pos0"], jpool["stages"]["pos0"]
    return [(np.asarray(s0["k"]), np.asarray(s0["v"]))] + [
        (np.asarray(st["k"][a]), np.asarray(st["v"][a]))
        for a in range(st["k"].shape[0])]


def _port_pool(jpool):
    return [{"k": _t(k), "v": _t(v)} for k, v in _pool_layers(jpool)]


@pytest.fixture(scope="module")
def dense(world):
    return _seed_pool(world[1], _prompts([7, 12], seed=2))


def test_verify_chunk_matches_reference(world, dense):
    """A 4-column window at per-slot positions over the same pool: logits
    ≤ 1e-4·max, gates exactly, the window's KV rows ≤ 1e-5·max and every
    other pool row untouched."""
    _, jparams, model = world
    jpool, pool, feed, pos = dense
    C = 4
    win = np.concatenate([feed[:, None], np.random.default_rng(5).integers(
        0, CFG.vocab_size, (2, C - 1))], axis=1).astype(np.int32)
    jlog, jpool2, jst = jax.jit(partial(jmodel.verify_chunk, cfg=JCFG))(
        jparams, jpool, {"tokens": jnp.asarray(win)}, jnp.asarray(pos))
    pool2 = [{k: v.clone() for k, v in ce.items()} for ce in pool]
    logits, _, st = model.verify_chunk(pool2, torch.as_tensor(win).long(),
                                       torch.as_tensor(pos))
    _close(logits.numpy(), np.asarray(jlog), TOL_LOGITS)
    np.testing.assert_array_equal(st["attn_gate"].numpy(),
                                  np.asarray(jst["attn_gate"], np.float32))
    rows = np.zeros((2, POOL_LEN), bool)
    for s in range(2):
        rows[s, pos[s]:pos[s] + C] = True
    for (jk, jv), ce, ce0 in zip(_pool_layers(jpool2), pool2, pool):
        for name, want in (("k", jk), ("v", jv)):
            got = ce[name].numpy()
            _close(got[rows], want[rows], TOL_KV)
            np.testing.assert_array_equal(got[~rows], ce0[name].numpy()[~rows])


def test_draft_loop_matches_reference(world, dense):
    """γ = 3 greedy draft iterations over the same pool under the keep-0.5
    draft params: tokens and the final (feed, t) exactly, logits ≤
    1e-4·max, pool rows ≤ 1e-5·max."""
    ref, jparams, model = world
    jpool, pool, feed, pos = dense
    n = 3
    jdraft = jax.tree_util.tree_map(jnp.asarray,
                                    jrouting.draft_router_bias(ref, 0.5))
    jpool2, jout = jax.jit(partial(jmodel.draft_loop, n_steps=n, cfg=JCFG))(
        jdraft, jpool, feed, pos, jax.random.PRNGKey(1))
    pool2 = [{k: v.clone() for k, v in ce.items()} for ce in pool]
    _, out = pmodel.draft_loop(routing.draft_router_bias(model.params(), 0.5),
                               pool2, feed, pos, n_steps=n, cfg=CFG)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    for k in ("feed", "t"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    _close(out["logits"].numpy(), np.asarray(jout["logits"]), TOL_LOGITS)
    for (jk, jv), ce in zip(_pool_layers(jpool2), pool2):
        _close(ce["k"].numpy(), jk, TOL_KV)
        _close(ce["v"].numpy(), jv, TOL_KV)


PAGE, PAGES, PAGED_LEN = 8, 48, 40


def _seed_store(jparams, prompts, kv_dtype, headroom):
    """The prompts prefilled in the reference and packed into its store
    (``headroom`` entries reserved past each): (reference store, the
    port's copy, allocator, first tokens, positions)."""
    nA = CFG.num_layers
    alloc = paged.PageAllocator(PAGES, PAGE, len(prompts),
                                slot_entry_capacity=PAGED_LEN * nA)
    jstore = jpaged.init_store(JCFG, PAGES, PAGE, kv_dtype=kv_dtype)
    prefill = jax.jit(partial(jmodel.prefill, cfg=JCFG))
    pack = jax.jit(partial(jpaged.pack_prefill, cfg=JCFG, kv_dtype=kv_dtype))
    feed = []
    for i, p in enumerate(prompts):
        lg, c, st = prefill(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        m = jpaged.prefill_entry_count(g, len(p), True)
        assert alloc.ensure(i, m + headroom)
        jstore = pack(jstore, c, jnp.asarray(g), jnp.int32(len(p)),
                      jnp.asarray(alloc.block_table[i]))
        alloc.append(i, m, nA * len(p))
        feed.append(int(jnp.argmax(lg[0])))
    store = bridge.store_from_numpy({k: np.asarray(v)
                                     for k, v in jstore.items()})
    pos = np.asarray([len(p) for p in prompts], np.int32)
    return jstore, store, alloc, np.asarray(feed, np.int32), pos


def _store_np(store):
    return {k: v.numpy().copy() for k, v in store.items()}


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_verify_and_commit_match_reference(world, kv_dtype):
    """A 4-column window over the committed prefix of a store (tentative
    entries appended above the fill first, which must stay invisible):
    logits ≤ 1e-4·max, gates exactly, window views ≤ 1e-5·max, the store
    unchanged; then ``commit_verified`` of the same views with committed
    0, partial and C columns: every store leaf and the fills exactly."""
    _, jparams, model = world
    C, nA = 4, CFG.num_layers
    jstore, store, alloc, feed, pos = _seed_store(
        jparams, _prompts([9, 13], seed=3), kv_dtype, headroom=2 * C * nA)
    fill, bt = alloc.fill.copy(), alloc.block_table[:, :6].copy()
    # junk entries above the fill, as a draft would leave them
    junk = jax.jit(partial(jmodel.paged_draft_loop, n_steps=2, cfg=JCFG))
    jstore, _ = junk(jparams, jstore, feed, pos, fill, np.ones(2, bool),
                     jax.random.PRNGKey(0), bt)
    store = bridge.store_from_numpy({k: np.asarray(v)
                                     for k, v in jstore.items()})
    before = _store_np(store)
    win = np.concatenate([feed[:, None], np.random.default_rng(6).integers(
        0, CFG.vocab_size, (2, C - 1))], axis=1).astype(np.int32)
    jlog, jst = jax.jit(partial(jmodel.paged_verify_chunk, cfg=JCFG))(
        jparams, jstore, {"tokens": jnp.asarray(win)}, jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(fill))
    logits, st = model.paged_verify_chunk(
        store, torch.as_tensor(win).long(), torch.as_tensor(pos), _t(bt),
        _t(fill))
    _close(logits.numpy(), np.asarray(jlog), TOL_LOGITS)
    gates = np.asarray(jst["attn_gate"], np.float32)
    np.testing.assert_array_equal(st["attn_gate"].numpy(), gates)
    for got, want in zip(st["kv_token"], jst["kv_token"]):
        _close(got.numpy(), np.asarray(want), TOL_KV)
    for k, v in _store_np(store).items():
        np.testing.assert_array_equal(v, before[k], k)

    bk, bv = (np.asarray(x) for x in jst["kv_token"])
    jcommit = jax.jit(partial(jmodel.commit_verified, cfg=JCFG))
    act = np.asarray([True, True])
    for committed in ([0, 0], [1, 3], [C, C]):
        committed = np.asarray(committed, np.int32)
        port = bridge.store_from_numpy(before)
        jout, jfill = jcommit(jstore, bk, bv, gates, pos, bt, fill,
                              committed, act)
        _, pfill = pmodel.commit_verified(
            port, _t(bk), _t(bv), _t(gates), _t(pos), _t(bt), _t(fill),
            _t(committed), _t(act), CFG)
        np.testing.assert_array_equal(pfill.numpy(), np.asarray(jfill))
        for k, v in _store_np(port).items():
            np.testing.assert_array_equal(v, np.asarray(jout[k]), k)


def test_paged_draft_loop_matches_reference(world):
    """γ = 3 greedy paged draft iterations under the keep-0.5 draft params:
    tokens, final (feed, t, fill) and the store's entry metadata exactly,
    logits ≤ 1e-4·max, page payloads ≤ 1e-5·max."""
    ref, jparams, model = world
    n, nA = 3, CFG.num_layers
    jstore, store, alloc, feed, pos = _seed_store(
        jparams, _prompts([6, 10], seed=4), None, headroom=n * nA)
    fill, bt = alloc.fill.copy(), alloc.block_table[:, :6].copy()
    act = np.ones(2, bool)
    jdraft = jax.tree_util.tree_map(jnp.asarray,
                                    jrouting.draft_router_bias(ref, 0.5))
    jstore, jout = jax.jit(partial(jmodel.paged_draft_loop, n_steps=n,
                                   cfg=JCFG))(
        jdraft, jstore, feed, pos, fill, act, jax.random.PRNGKey(1), bt)
    _, out = pmodel.paged_draft_loop(
        routing.draft_router_bias(model.params(), 0.5), store, feed, pos,
        fill, act, None, bt, n_steps=n, cfg=CFG)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    for k in ("feed", "t", "fill"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    _close(out["logits"].numpy(), np.asarray(jout["logits"]), TOL_LOGITS)
    got = _store_np(store)
    for k in ("pos_pages", "l0_pages", "l1_pages"):
        np.testing.assert_array_equal(got[k], np.asarray(jstore[k]), k)
    for k in ("k_pages", "v_pages"):
        _close(got[k], np.asarray(jstore[k]), TOL_KV)


# ---------------------------------------------------------------------------
# 4-6. Engines against the reference's engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_engines(world):
    """The reference's engines by compiled geometry, built once for the
    module; ``get`` hands one out with a fresh engine's host state
    (scheduler, page allocator, prefix cache, no stashed store, no draft
    override)."""
    engines = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = jengine.ContinuousBatchingEngine(
                JCFG, world[1], **kw)
        eng = engines[key]
        eng.draft_override = None
        eng.scheduler = jsched.Scheduler(
            eng.max_slots, eng.max_len, buckets=eng.scheduler.buckets,
            prefill_chunk=eng.prefill_chunk)
        if eng.kv_mode == "paged":
            eng.allocator = jpaged.PageAllocator(
                eng.num_pages, eng.page_size, eng.max_slots,
                slot_entry_capacity=eng.max_len * eng.n_attn)
            eng._store = None
            if eng.prefix is not None:
                eng.prefix = jprefix.PrefixCache(
                    eng.allocator, block=eng.prefix.block,
                    reuse=eng.prefix.reuse,
                    max_records=eng.prefix.max_records)
                eng.scheduler.prefix_probe = eng._prefix_probe
                eng._warm_pending = {}
        return eng

    return get


def _drive(eng, prompts, budgets, stop_token=None, override=None):
    eng.draft_override = override
    uids = [eng.submit(p, b, stop_token=stop_token)
            for p, b in zip(prompts, budgets)]
    res = eng.run()
    return [res["results"][u] for u in uids], res["stats"]


def _geometry(kv_mode, spec_k, chunk=0, **kw):
    return dict(dict(max_slots=3, max_len=48, kv_mode=kv_mode,
                     spec_k=spec_k, prefill_chunk=chunk), **kw)


def _pair(world, ref_engines, prompts, budgets, stop_token=None,
          override=None, **kw):
    """The same submits through a port engine and the reference's engine:
    tokens, finish reasons, per-request KV accounting and every STATS
    field equal.  ``override`` is a factory: each engine gets a fresh
    hook from it.  Returns (the port's results, stats, engine)."""
    mine = ContinuousBatchingEngine(world[2], **kw)
    res, st = _drive(mine, prompts, budgets, stop_token,
                     override and override())
    jres, jst = _drive(ref_engines(**kw), prompts, budgets, stop_token,
                       override and override())
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert (r.finish_reason, r.kv_stored, r.kv_dense) == \
            (jr.finish_reason, jr.kv_stored, jr.kv_dense)
    for name in STATS:
        assert getattr(st, name) == getattr(jst, name), name
    return res, st, mine


def _plain(world, prompts, budgets, stop_token=None, **kw):
    kw = dict(kw, spec_k=0)
    return _drive(ContinuousBatchingEngine(world[2], **kw), prompts, budgets,
                  stop_token)[0]


def _same_tokens(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)


def _no_leaks(eng):
    pins = eng.prefix.page_pins() if eng.prefix is not None else {}
    eng.allocator.check_conservation(pins)
    assert eng.allocator.free_pages == eng.num_pages - len(pins)


@pytest.mark.parametrize("kv_mode,spec_k,chunk", [
    ("dense", 1, 0), ("dense", 4, 0), ("dense", 4, 8),
    ("paged", 1, 0), ("paged", 4, 0), ("paged", 4, 8)])
def test_engine_greedy_matches_reference(world, ref_engines, kv_mode,
                                         spec_k, chunk):
    """Temperature 0: the port's speculative engine ≡ the reference's
    (tokens, every statistic, the spec counters) and ≡ the port's plain
    engine in tokens (greedy identity); draft_keep 1.0 accepts all."""
    prompts = _prompts(LENS)
    kw = _geometry(kv_mode, spec_k, chunk)
    res, st, eng = _pair(world, ref_engines, prompts, [MAX_NEW] * 4, **kw)
    _same_tokens(res, _plain(world, prompts, [MAX_NEW] * 4, **kw))
    assert st.spec_windows > 0 and st.spec_tokens_drafted > 0
    assert st.spec_acceptance_rate == 1.0
    if kv_mode == "paged":
        _no_leaks(eng)
        assert eng.allocator.free_pages == eng.num_pages


def _reject(V):
    def make():
        return lambda uid, d: (d + 1) % V
    return make


def _corrupt(V):
    def make():
        rng = np.random.default_rng(7)

        def corrupt(uid, d):
            mask = rng.random(d.shape) < 0.5
            return np.where(mask, (d + rng.integers(1, V, d.shape)) % V, d)
        return corrupt
    return make


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
@pytest.mark.parametrize("hook", ["reject", "corrupt"])
def test_engine_overridden_drafts_match_reference(world, ref_engines,
                                                  kv_mode, hook):
    """``draft_override`` all-reject ((d + 1) mod V: acceptance 0, every
    window emits one corrected token, paged drafts rolled back) and random
    corruption (partial acceptance): equal to the reference's engine, and
    the tokens still the plain engine's."""
    prompts = _prompts(LENS)
    kw = _geometry(kv_mode, 4)
    make = (_reject if hook == "reject" else _corrupt)(CFG.vocab_size)
    res, st, eng = _pair(world, ref_engines, prompts, [MAX_NEW] * 4,
                         override=make, **kw)
    _same_tokens(res, _plain(world, prompts, [MAX_NEW] * 4, **kw))
    assert st.spec_tokens_drafted > 0
    if hook == "reject":
        assert st.spec_tokens_accepted == 0
        if kv_mode == "paged":
            assert st.spec_entries_rolled_back > 0
    else:
        assert 0 < st.spec_tokens_accepted < st.spec_tokens_drafted
    if kv_mode == "paged":
        _no_leaks(eng)


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_engine_mid_window_stop_matches_reference(world, ref_engines,
                                                  kv_mode):
    """A stop token inside an accepted window ends the request where the
    plain engine stops: equal to the reference's engine and the plain
    engine, finish reason "stop"."""
    prompts = _prompts((9,))
    kw = _geometry(kv_mode, 4)
    chain = _plain(world, prompts, [8], **kw)[0].tokens
    stop = int(chain[2])
    res, _, _ = _pair(world, ref_engines, prompts, [8], stop_token=stop,
                      **kw)
    _same_tokens(res, _plain(world, prompts, [8], stop_token=stop, **kw))
    assert res[0].finish_reason == "stop" and int(res[0].tokens[-1]) == stop


def test_engine_preemption_and_rollback_invariants(world, ref_engines,
                                                   monkeypatch):
    """A pool too small for every resident's window (draft_keep 0.5:
    partial acceptance): residents are preempted mid-speculation, and
    after every rollback the slot's chain is tight and the pool conserved
    (a trim spy); equal to the reference's engine, tokens a roomy plain
    engine's, trim idempotent, every page home at the end."""
    calls = []
    orig = paged.PageAllocator.trim

    def spying_trim(alloc, slot):
        freed = orig(alloc, slot)
        calls.append(freed)
        assert len(alloc._chains[slot]) == alloc.pages_for(
            int(alloc.fill[slot]))
        assert orig(alloc, slot) == 0               # idempotent
        alloc.check_conservation()
        return freed

    monkeypatch.setattr(paged.PageAllocator, "trim", spying_trim)
    prompts = _prompts(LENS)
    kw = _geometry("paged", 4, draft_keep=0.5, page_size=8, num_pages=16)
    res, st, eng = _pair(world, ref_engines, prompts, [16] * 4, **kw)
    assert st.preemptions > 0 and st.requests_completed == 4
    assert any(calls), "no window ever rolled back"
    assert 0.0 < st.spec_acceptance_rate < 1.0
    roomy = dict(kw, num_pages=None)
    _same_tokens(res, _plain(world, prompts, [16] * 4, **roomy))
    assert eng.allocator.free_pages == eng.num_pages
    assert not eng.allocator.fill.any() and not eng.allocator.block_table.any()


@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_warm_prefix_rollback_matches_reference(world, ref_engines,
                                                       chunk):
    """Speculation over a warm admission (tests/test_prefix_cache.py), its
    suffix prefilled whole or in chunks of 8: the windows over-reserve and
    roll back against a chain holding aliased pages; trim returns only
    private pages (conserved with the record pins), equal to the
    reference's engine, tokens the plain warm engine's."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, CFG.vocab_size, (16,), dtype=np.int32)
    p1, p2 = (np.concatenate([head, rng.integers(
        0, CFG.vocab_size, (t,), dtype=np.int32)]) for t in (4, 6))
    kw = _geometry("paged", 3, chunk, max_slots=2, max_len=64, page_size=8,
                   prefix_cache=True, prefix_block=8)
    mine = ContinuousBatchingEngine(world[2], **kw)
    theirs = ref_engines(**kw)
    plain = ContinuousBatchingEngine(world[2], **dict(kw, spec_k=0))
    for prompt, new in ((p1, 4), (p2, 10)):
        (r,), st = _drive(mine, [prompt], [new])
        (jr,), jst = _drive(theirs, [prompt], [new])
        (w,), _ = _drive(plain, [prompt], [new])
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        np.testing.assert_array_equal(r.tokens, w.tokens)
        for name in STATS:
            assert getattr(st, name) == getattr(jst, name), name
        _no_leaks(mine)
    assert st.prefix_hits == 1 and st.spec_windows > 0


def test_fused_greedy_commit_agrees_with_host_replay(world, monkeypatch):
    """At temperature 0 the paged engine decides and commits each window
    on the device before its one sync, and every window's committed
    counts equal the host replay's; a device count off by one raises."""
    prompts = _prompts(LENS)
    kw = _geometry("paged", 4, draft_keep=0.5)
    orig = ContinuousBatchingEngine._spec_verify_commit
    seen = []

    def spy(eng, *a, **k):
        out = orig(eng, *a, **k)
        seen.append(out[2].clone())
        return out

    monkeypatch.setattr(ContinuousBatchingEngine, "_spec_verify_commit", spy)
    eng = ContinuousBatchingEngine(world[2], **kw)
    _, st = _drive(eng, prompts, [MAX_NEW] * 4)
    assert len(seen) == st.spec_windows > 0
    assert sum(int(c.sum()) for c in seen) == st.decode_tokens - 4

    def off_by_one(eng, *a, **k):
        tgt, gates, committed = orig(eng, *a, **k)
        return tgt, gates, committed + 1

    monkeypatch.setattr(ContinuousBatchingEngine, "_spec_verify_commit",
                        off_by_one)
    with pytest.raises(RuntimeError, match="fused spec commit divergence"):
        _drive(ContinuousBatchingEngine(world[2], **kw), prompts[:1], [4])


def test_engine_refusals_match_reference(world):
    """spec_k < 0, spec_k with decode_steps > 1 (by kwargs, and by the
    config's default epoch), draft_keep outside (0, 1] and a Mamba stack:
    refused with the reference's exception types."""
    model, jparams = world[2], world[1]
    cases = [dict(spec_k=-1), dict(spec_k=4, decode_steps=4),
             dict(spec_k=2, draft_keep=0.0), dict(spec_k=2, draft_keep=1.5),
             dict(spec_k=2, draft_keep=-0.2)]
    for kw in cases:
        with pytest.raises(ValueError) as mine:
            ContinuousBatchingEngine(model, max_slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as theirs:
            jengine.ContinuousBatchingEngine(JCFG, jparams, max_slots=2,
                                             max_len=32, **kw)
        assert type(mine.value).__name__ == type(theirs.value).__name__
    fused = LanguageModel(dataclasses.replace(CFG,
                                              decode_steps_per_dispatch=4),
                          model.params(), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatchingEngine(fused, max_slots=2, max_len=32, spec_k=2)
    mcfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                               dtype="float32")
    with pytest.raises(ValueError, match="speculat") as mine:
        ContinuousBatchingEngine(LanguageModel(mcfg, device="cpu", seed=0),
                                 max_slots=1, max_len=32, spec_k=2)
    with pytest.raises(ValueError, match="speculat") as theirs:
        jengine.ContinuousBatchingEngine(jget_config("mamba2-2.7b").smoke(),
                                         None, max_slots=1, max_len=32,
                                         spec_k=2)
    assert type(mine.value).__name__ == type(theirs.value).__name__


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_engine_sampled_run_completes(world, kv_mode):
    """Temperature 0.8: every request emits its budget of in-vocabulary
    tokens, accepted ≤ drafted; with draft_keep 1.0 the draft and the
    verifier are one model, so nearly every proposal is kept (their
    probabilities differ only by summation order); the same seed gives
    the same run."""
    prompts = _prompts((7, 10))
    kw = _geometry(kv_mode, 4, temperature=0.8)
    runs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(world[2], **kw)
        uids = [eng.submit(p, 6) for p in prompts]
        out = eng.run(torch.Generator().manual_seed(3))
        runs.append([out["results"][u].tokens for u in uids])
        st = out["stats"]
        for toks in runs[-1]:
            assert toks.shape == (6,)
            assert ((0 <= toks) & (toks < CFG.vocab_size)).all()
        assert 0 < st.spec_tokens_accepted <= st.spec_tokens_drafted
        assert st.spec_acceptance_rate >= 0.9
        if kv_mode == "paged":
            _no_leaks(eng)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged_kv", [False, True])
def test_launcher_spec_on_cpu(capsys, paged_kv):
    argv = ["--smoke", "--device", "cpu",            # llama2-7b by default
            "--continuous", "--spec-k", "4", "--batch", "2",
            "--prompt-len", "24", "--new-tokens", "6"]
    launch_serve.main(argv + (["--paged-kv"] if paged_kv else []))
    out = capsys.readouterr().out
    assert "requests: 4" in out and "speculative:" in out
    for bad in (["--spec-k", "2"], ["--continuous", "--spec-k", "2",
                                    "--decode-steps", "4"],
                ["--continuous", "--draft-keep", "0.5"]):
        with pytest.raises(SystemExit):
            launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device",
                               "cpu"] + bad)
