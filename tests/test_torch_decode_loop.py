"""The port's device-resident decode epochs on the CPU against the JAX
package: ``decode_loop`` / ``paged_decode_loop`` (``model.DecodeEpoch``'s
eager loop, the body its CUDA graph captures) and the continuous engine's
fused mode (``decode_steps > 1``), dense and paged, on the same bridged
weights and inputs; also the loop against sequential port steps, the
engine's fused mode against its single-step mode, the scheduler's epoch
costing and the ``decode_steps`` plumbing.

Tolerances: tokens, ``step_active``, gates, the final carry, fills, the
paged store's entry metadata and every engine statistic exactly; KV rows
≤ 1e-4·max|ref| in fp32 (sums in another order).  In bf16 the two packages
round at other places, so the port's loop is held to the reference's
tokens on at least 90 % of (step, slot) pairs and, for every slot whose
tokens all agree (at least one), to its step_active, gates and carry
exactly and its KV rows within 2^-7·max|ref| (two bf16 ulps at the
maximum); and to its own sequential steps bit for bit.  Routers are
redrawn at unit scale with zero bias, so routing really skips.

The reference's engines are shared by geometry (``ref_engines``): each
compiles a loop per epoch length and block-table width once, and a
drained engine serves the next submits as a fresh one does.

The reference's engine hands the device copies of its host arrays
(``_reference_copies_host_arrays``): its fused paged engine passes
``jnp.asarray`` of its allocator's numpy arrays (fill, block-table rows)
to work that runs asynchronously, the CPU backend may alias them, and the
allocator updates them while that work may still read them.  Under load
its tokens changed from run to run on this test's inputs (1 of 4 runs of
one process; 2 of 5 test runs); with JAX's CPU dispatch synchronous from
the process's start 0 of 14, and with copies 0 of 4 test runs."""
import dataclasses
import re
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kvcache import paged as jpaged
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import routing
from repro_torch.kernels import ops
from repro_torch.kvcache import paged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import sample

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

torch.set_num_threads(2)

SEED = 0
STOP = 358             # request 2's sixth token in the engine tests
TOL = 1e-4
MIN_MARGIN = 1e-3
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "epoch_shrinks", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "page_size", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer")


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a))


def _redraw_routers(tree, rng):
    for k, v in tree.items():
        if k == "router":
            v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
            v["b"] = np.zeros_like(v["b"])
        elif isinstance(v, dict):
            _redraw_routers(v, rng)


class _CopyingNumpy:
    """``jax.numpy`` whose ``asarray`` copies a numpy array, so the device
    never aliases a host buffer that the caller updates afterwards."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


@pytest.fixture(autouse=True)
def _reference_copies_host_arrays(monkeypatch):
    """The reference's engine hands its allocator's arrays to the device as
    copies (see the module's docstring); its arithmetic is untouched."""
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())


def _ref_params(jcfg):
    """The reference's init, jitted, with the routers redrawn."""
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED), jcfg))
    _redraw_routers(ref, rng)
    return ref


@pytest.fixture(scope="module")
def world():
    ref = _ref_params(JCFG)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return ref, model


@pytest.fixture(scope="module")
def loops(world):
    """Per dtype: (reference config, params, port config, params, and the
    reference pool seeded from two prompts with its port copy, first-token
    feed and positions), built once."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JCFG, dtype=dtype)
        cfg = dataclasses.replace(CFG, dtype=dtype)
        ref = world[0] if dtype == "float32" else _ref_params(jcfg)
        jparams = jax.tree_util.tree_map(jnp.asarray, ref)
        params = bridge.from_reference(ref, cfg)
        out[dtype] = (jcfg, jparams, cfg, params) + _seed_pool(
            jcfg, jparams, _prompts([8, 8]), LOOP_LEN)
    return out


def _fresh(pool):
    return [{k: v.clone() for k, v in ce.items()} for ce in pool]


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# Model level: the loops against the reference's scans
# ---------------------------------------------------------------------------

LOOP_LEN = 24          # the loops' pool rows


def _seed_pool(jcfg, jparams, prompts, max_len):
    """Prefill each prompt alone in the reference and scatter it into a
    slot pool.  Returns (reference pool, the port's copy of it bit for
    bit, first-token feed, positions)."""
    jpool = jengine.init_pool(jcfg, len(prompts), max_len)
    feed, pos = [], []
    prefill = jax.jit(partial(jmodel.prefill, cfg=jcfg, pad_to=max_len))
    insert = jax.jit(partial(jengine.pool_insert, cfg=jcfg))
    for s, p in enumerate(prompts):
        lg, cache, _ = prefill(jparams, {"tokens": jnp.asarray(p[None])})
        jpool = insert(jpool, cache, s)
        feed.append(int(jnp.argmax(lg[0])))
        pos.append(len(p))
    s0, st = jpool["stage0"]["pos0"], jpool["stages"]["pos0"]
    pool = [{"k": _t(s0["k"]), "v": _t(s0["v"])}] + [
        {"k": _t(st["k"][a]), "v": _t(st["v"][a])}
        for a in range(st["k"].shape[0])]
    return jpool, pool, np.asarray(feed, np.int32), np.asarray(pos, np.int32)


def _jpool_layers(jpool):
    s0, st = jpool["stage0"]["pos0"], jpool["stages"]["pos0"]
    return [(np.asarray(s0["k"]), np.asarray(s0["v"]))] + [
        (np.asarray(st["k"][a]), np.asarray(st["v"][a]))
        for a in range(st["k"].shape[0])]


def _close(out, want, tol=TOL):
    out, want = np.asarray(out, np.float32), np.asarray(want, np.float32)
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _check_out(out, jout, exact_tokens=True) -> np.ndarray:
    """The port's loop outputs against the reference's: tokens, stacked
    outputs and carry exactly (bf16: tokens on ≥ 90 % of the pairs, and
    the rest for every slot whose tokens all agree, at least one).
    Returns the slots held."""
    toks, jtoks = out["tokens"].numpy(), np.asarray(jout["tokens"])
    if exact_tokens:
        np.testing.assert_array_equal(toks, jtoks)
    else:
        assert (toks == jtoks).mean() >= 0.9, (toks, jtoks)
    slots = np.flatnonzero((toks == jtoks).all(0))
    assert slots.size, (toks, jtoks)
    np.testing.assert_array_equal(out["step_active"].numpy()[:, slots],
                                  np.asarray(jout["step_active"])[:, slots])
    np.testing.assert_array_equal(
        out["attn_gate"].numpy()[..., slots],
        np.asarray(jout["attn_gate"], np.float32)[..., slots])
    for k in ("feed", "t", "active", "emitted") + (
            ("fill",) if "fill" in jout else ()):
        np.testing.assert_array_equal(out[k].numpy()[slots],
                                      np.asarray(jout[k])[slots], k)
    return slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_loop_matches_reference(loops, dtype):
    """A free-running epoch and one where slot 0's stop token fires
    mid-epoch, from the same pool in both packages: tokens, step_active,
    gates and the final carry exactly, the pool's KV rows ≤ 1e-4·max (fp32;
    bf16: tokens on ≥ 90 % of the pairs)."""
    jcfg, jparams, cfg, params, jpool, pool, feed, pos = loops[dtype]
    max_len, n = LOOP_LEN, 6
    act = np.ones((2,), bool)
    budget = np.full((2,), n + 1, np.int32)
    free = np.full((2,), -1, np.int32)
    key = jax.random.PRNGKey(3)
    jloop = jax.jit(partial(jmodel.decode_loop, n_steps=n, cfg=jcfg,
                            max_len=max_len))
    jpool_f, jout = jloop(jparams, jpool, feed, pos, act, budget, free, key)
    pool_f = _fresh(pool)
    _, out = pmodel.decode_loop(params, pool_f, feed, pos, act, budget,
                                free, n_steps=n, cfg=cfg, max_len=max_len)
    exact = dtype == "float32"
    slots = _check_out(out, jout, exact)
    tol = TOL if exact else 2.0 ** -7
    for (k, v), ce in zip(_jpool_layers(jpool_f), pool_f):
        _close(ce["k"].float().numpy()[slots], k[slots], tol)
        _close(ce["v"].float().numpy()[slots], v[slots], tol)
    if not exact:
        return

    ref_toks = np.asarray(jout["tokens"])
    stop_tok = int(ref_toks[2, 0])
    assert int(np.argmax(ref_toks[:, 0] == stop_tok)) < n - 1
    assert stop_tok not in ref_toks[:, 1]
    stop = np.asarray([stop_tok, -1], np.int32)
    _, jstop = jloop(jparams, jpool, feed, pos, act, budget, stop, key)
    _, out = pmodel.decode_loop(params, _fresh(pool), feed, pos, act, budget,
                                stop, n_steps=n, cfg=cfg, max_len=max_len)
    _check_out(out, jstop)


def test_decode_loop_mid_stop_freezes_kv(loops):
    """A slot that samples its stop token mid-epoch freezes its (feed, t)
    carry: pool rows past its stop position stay as they were before the
    loop, bit for bit, rows up to it equal the free run's, and the other
    slot's rows equal the free run's."""
    _, _, cfg, params, _, pool, feed, pos = loops["float32"]
    max_len, n = LOOP_LEN, 6
    pool = _fresh(pool)
    k_init = pool[0]["k"].clone()
    act = np.ones((2,), bool)
    budget = np.full((2,), n + 1, np.int32)
    free_pool = _fresh(pool)
    _, free = pmodel.decode_loop(params, free_pool, feed, pos, act, budget,
                                 np.full((2,), -1), n_steps=n, cfg=cfg,
                                 max_len=max_len)
    toks = free["tokens"].numpy()
    stop_tok = int(toks[2, 0])
    k_stop = int(np.argmax(toks[:, 0] == stop_tok))
    assert k_stop < n - 1 and stop_tok not in toks[:, 1]
    _, out = pmodel.decode_loop(params, pool, feed, pos, act, budget,
                                np.asarray([stop_tok, -1]), n_steps=n,
                                cfg=cfg, max_len=max_len)
    sa = out["step_active"].numpy()
    assert sa[:k_stop + 1, 0].all() and not sa[k_stop + 1:, 0].any()
    assert sa[:, 1].all()
    np.testing.assert_array_equal(out["tokens"].numpy()[:k_stop + 1, 0],
                                  toks[:k_stop + 1, 0])
    t_stop = int(pos[0]) + k_stop
    assert int(out["t"][0]) == t_stop and not bool(out["active"][0])
    k_frozen, k_free = pool[0]["k"], free_pool[0]["k"]
    assert torch.equal(k_frozen[0, t_stop + 1:], k_init[0, t_stop + 1:])
    assert torch.equal(k_frozen[0, :t_stop + 1], k_free[0, :t_stop + 1])
    assert not torch.equal(k_free[0, t_stop + 1:int(pos[0]) + n],
                           k_init[0, t_stop + 1:int(pos[0]) + n])
    assert torch.equal(k_frozen[1], k_free[1])


@pytest.mark.parametrize("dtype,temperature", [("float32", 0.0),
                                               ("bfloat16", 0.0),
                                               ("float32", 0.8)])
def test_decode_loop_matches_sequential_steps(loops, dtype, temperature):
    """n fused iterations ≡ n port ``decode_step`` + ``sample`` calls, bit
    for bit: tokens, final pool and, at temperature > 0, the generator's
    draws (one per step, so equally seeded generators agree)."""
    _, _, cfg, params, _, pool, feed, pos = loops[dtype]
    max_len, n = LOOP_LEN, 5
    pool, ref_pool = _fresh(pool), _fresh(pool)
    _, out = pmodel.decode_loop(
        params, pool, feed, pos, np.ones((2,), bool),
        np.full((2,), n + 1), np.full((2,), -1),
        torch.Generator().manual_seed(11), n_steps=n, cfg=cfg,
        max_len=max_len, temperature=temperature)
    gen = torch.Generator().manual_seed(11)
    f, t = torch.as_tensor(feed).long(), torch.as_tensor(pos)
    for i in range(n):
        logits, ref_pool, _ = pmodel.decode_step(params, ref_pool,
                                                 f[:, None], t, cfg)
        f, t = sample(logits, gen, temperature), t + 1
        assert torch.equal(out["tokens"][i], f)
    assert torch.equal(out["feed"], f) and torch.equal(out["t"], t)
    assert bool(out["step_active"].all())
    for a, b in zip(pool, ref_pool):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_paged_decode_loop_matches_reference(loops):
    """The paged loop over the same store in both packages: tokens, gates,
    step_active and the device-advanced fill exactly, entry metadata
    exactly, payloads ≤ 1e-4·max; and ≡ n sequential port paged steps."""
    jcfg, jparams, cfg, params = loops["float32"][:4]
    nA, n, max_len, P, ps = CFG.num_layers, 6, 32, 32, 8
    prompts = _prompts([8, 8], seed=1)
    alloc = paged.PageAllocator(P, ps, 2, slot_entry_capacity=max_len * nA)
    jstore = jpaged.init_store(jcfg, P, ps)
    feed = []
    prefill = jax.jit(partial(jmodel.prefill, cfg=jcfg))
    pack = jax.jit(partial(jpaged.pack_prefill, cfg=jcfg))
    for i, p in enumerate(prompts):
        lg, c, st = prefill(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        m = jpaged.prefill_entry_count(g, len(p), True)
        assert alloc.ensure(i, m + n * nA)         # the epoch's headroom
        jstore = pack(jstore, c, jnp.asarray(g), jnp.int32(len(p)),
                      jnp.asarray(alloc.block_table[i]))
        alloc.append(i, m, nA * len(p))
        feed.append(int(jnp.argmax(lg[0])))
    feed = np.asarray(feed, np.int32)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    fill, bt = alloc.fill.copy(), alloc.block_table[:, :4].copy()
    act, budget = np.ones((2,), bool), np.full((2,), n + 1, np.int32)
    stop = np.full((2,), -1, np.int32)
    store = bridge.store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()})
    seq_store = bridge.store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()})
    jstore, jout = jax.jit(partial(
        jmodel.paged_decode_loop, n_steps=n, cfg=jcfg, max_len=max_len))(
        jparams, jstore, feed, pos, fill, act, budget, stop,
        jax.random.PRNGKey(3), bt)
    _, out = pmodel.paged_decode_loop(params, store, feed, pos, fill, act,
                                      budget, stop, None, bt, n_steps=n,
                                      cfg=cfg, max_len=max_len)
    _check_out(out, jout)
    got = {k: v.numpy() for k, v in store.items()}
    for k in ("pos_pages", "l0_pages", "l1_pages"):
        np.testing.assert_array_equal(got[k], np.asarray(jstore[k]))
    for k in ("k_pages", "v_pages"):
        _close(got[k], np.asarray(jstore[k]))

    f, t, fl = torch.as_tensor(feed).long(), torch.as_tensor(pos), _t(fill)
    for i in range(n):
        logits, seq_store, st = pmodel.paged_decode_step(
            params, seq_store, f[:, None], t, _t(bt), fl, cfg)
        f, t = sample(logits), t + 1
        fl = fl + (1 + st["attn_gate"][1:].sum(0)).int()
        assert torch.equal(out["tokens"][i], f)
    assert torch.equal(out["fill"], fl)
    for k, v in store.items():
        assert torch.equal(v, seq_store[k]), k


# ---------------------------------------------------------------------------
# Engine level: fused epochs against the reference's fused engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_engines(world):
    """The reference's engines by geometry, built once for the module (a
    drained engine compiles nothing again for the next submits)."""
    engines = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = jengine.ContinuousBatchingEngine(
                JCFG, jax.tree_util.tree_map(jnp.asarray, world[0]), **kw)
        return engines[key]

    return get


def _drive(eng, prompts, budgets, stop_token=None):
    """Submit, drain.  Returns (tokens, results, stats, engine), the
    tokens and results in submission order."""
    uids = [eng.submit(p, b, stop_token=stop_token)
            for p, b in zip(prompts, budgets)]
    res = eng.run()
    return ([res["results"][u].tokens for u in uids],
            [res["results"][u] for u in uids], res["stats"], eng)


def _port_run(world, prompts, budgets, stop_token=None, **kw):
    return _drive(ContinuousBatchingEngine(world[1], **kw), prompts, budgets,
                  stop_token)


def _run_pair(world, ref_engines, prompts, budgets, stop_token=None, **kw):
    """The same submits through the port's engine and the reference's."""
    return (_port_run(world, prompts, budgets, stop_token, **kw),
            _drive(ref_engines(**kw), prompts, budgets, stop_token))


def _assert_same(mine, theirs, stats=STATS):
    (toks, res, st, eng), (jtoks, jres, jst, _) = mine, theirs
    for a, b in zip(toks, jtoks):
        np.testing.assert_array_equal(a, b)
    for name in stats:
        assert getattr(st, name) == getattr(jst, name), name
    for r, jr in zip(res, jres):
        assert (r.finish_reason, r.kv_stored, r.kv_dense) == \
            (jr.finish_reason, jr.kv_stored, jr.kv_dense)
    if eng.kv_mode == "paged":
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages


@pytest.mark.parametrize("kv_mode,n_steps", [("dense", 2), ("dense", 8),
                                             ("paged", 8)])
def test_fused_engine_matches_reference(world, ref_engines, kv_mode,
                                        n_steps):
    """Mixed budgets (max_new 1 included), a stop token that fires
    mid-epoch (request 2's sixth token), slots reused: tokens, finish
    reasons, KV accounting and every shared statistic equal the
    reference's fused engine; at temperature 0 the tokens also equal the
    port's single-step engine, which takes more dispatches."""
    geom = dict(max_slots=2, max_len=48, kv_mode=kv_mode,
                **({"page_size": 8} if kv_mode == "paged" else {}))
    prompts, budgets = _prompts([10, 5, 9, 14, 7]), [6, 1, 9, 4, 7]
    mine, theirs = _run_pair(world, ref_engines, prompts, budgets,
                             stop_token=STOP, decode_steps=n_steps, **geom)
    _assert_same(mine, theirs)
    assert [r.finish_reason for r in mine[1]] == ["length"] * 2 + [
        "stop"] + ["length"] * 2
    assert len(mine[0][2]) == 6
    single = _port_run(world, prompts, budgets, stop_token=STOP, **geom)
    for a, b in zip(mine[0], single[0]):
        np.testing.assert_array_equal(a, b)
    s, s1 = mine[2], single[2]
    assert s.decode_dispatches < s1.decode_dispatches
    assert s.decode_iterations >= s1.decode_iterations
    assert s.decode_tokens == s1.decode_tokens
    assert s.compiles == s.graph_replays == 0          # the CPU's eager loop
    assert s.device_s > 0.0 and s.host_s > 0.0


def test_fused_deferred_first_token_stop(world, ref_engines):
    """A dense prefill's first token stays on the device; when it is the
    stop token, the epoch's entry check kills the slot (no emission, no KV
    append) and the host finishes it with reason "stop", as the
    single-step engine does at once."""
    prompts, budgets = _prompts([10, 7]), [4, 6]
    probe = _port_run(world, prompts, budgets, max_slots=2, max_len=48)
    first = int(probe[0][0][0])
    geom = dict(max_slots=2, max_len=48, kv_mode="dense")
    mine, theirs = _run_pair(world, ref_engines, prompts, budgets,
                             stop_token=first, decode_steps=8, **geom)
    _assert_same(mine, theirs)
    r0 = mine[1][0]
    assert r0.finish_reason == "stop" and len(r0.tokens) == 1
    single = _port_run(world, prompts, budgets, stop_token=first, **geom)
    for a, b in zip(mine[0], single[0]):
        np.testing.assert_array_equal(a, b)


def test_fused_paged_preemption_matches_reference(world, ref_engines):
    """Page pressure in fused mode: epochs shrink, then the youngest other
    resident is preempted and re-prefilled.  In this pool (9 pages of 8
    entries, two 8-token prompts of 24 tokens each, epochs of up to 4
    steps) the reference's fused engine preempts; the port equals it in
    tokens and every statistic, and every page comes back."""
    prompts = _prompts([8, 8], seed=1)
    mine, theirs = _run_pair(world, ref_engines, prompts, [24, 24],
                             max_slots=2, max_len=64, kv_mode="paged",
                             page_size=8, num_pages=9, decode_steps=4)
    assert theirs[2].preemptions >= 1
    assert theirs[2].epoch_shrinks >= 1
    assert mine[2].requests_completed == 2
    _assert_same(mine, theirs)


def test_fused_engine_mamba_matches_reference(monkeypatch):
    """A Mamba stack (dense pool only; its decode step goes into the same
    epoch): fused ≡ single-step ≡ the reference's fused engine, with every
    router margin clear of the strict-`>` tie."""
    jcfg = dataclasses.replace(jget_config("mamba2-2.7b").smoke(),
                               dtype="float32", use_kernels=True)
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                              dtype="float32")
    ref = _ref_params(jcfg)
    model = LanguageModel(cfg, bridge.from_reference(ref, cfg), device="cpu")
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append(float((logits[..., 1] - logits[..., 0]).abs().min()))
        return orig(logits)

    monkeypatch.setattr(routing, "gate_from_logits", recording)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (9, 16, 9, 16)]
    runs = []
    for eng in (ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                         decode_steps=4),
                ContinuousBatchingEngine(model, max_slots=2, max_len=48),
                jengine.ContinuousBatchingEngine(
                    jcfg, jax.tree_util.tree_map(jnp.asarray, ref),
                    max_slots=2, max_len=48, decode_steps=4)):
        uids = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        runs.append(([out["results"][u].tokens for u in uids], out["stats"]))
    (fused, fs), (single, ss), (jfused, js) = runs
    for a, b, c in zip(fused, single, jfused):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for name in ("prefill_tokens", "decode_tokens", "prefill_chunks",
                 "interleaved_steps", "requests_completed",
                 "decode_dispatches", "kv_saved_fraction"):
        assert getattr(fs, name) == getattr(js, name), name
    assert fs.decode_dispatches < ss.decode_dispatches
    assert min(margins) >= MIN_MARGIN, min(margins)


def test_fused_engine_temperature(world):
    """At temperature > 0 the fused engine draws from the run's generator:
    an equally seeded run repeats its tokens, and every token is in the
    vocabulary (draws are compared by distribution, never with the
    reference's bits: ``test_temperature_sampling_by_distribution``)."""
    outs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(world[1], max_slots=2, max_len=48,
                                       temperature=0.8, decode_steps=4)
        uids = [eng.submit(p, 6) for p in _prompts([10, 5, 9])]
        res = eng.run(torch.Generator().manual_seed(5))["results"]
        outs.append([res[u].tokens for u in uids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 6 and ((a >= 0) & (a < CFG.vocab_size)).all()


# ---------------------------------------------------------------------------
# Scheduler, config plumbing, launch counters, launcher
# ---------------------------------------------------------------------------

def test_step_plan_epoch_costing_matches_reference():
    """Each decode slot costs ``decode_steps`` tokens; the prefill costs
    its prompt: ``StepPlan.tokens`` and ``plan_step(decode_steps=)`` equal
    the reference scheduler's (monolithic prefill)."""
    for mod in (tsched, jsched):
        assert mod.StepPlan(decode_slots=[0, 1], prefill=None,
                            decode_steps=8).tokens == 16
    plans = []
    for mod in (tsched, jsched):
        sched = mod.Scheduler(max_slots=4, max_len=64)
        for uid, n in enumerate((4, 8, 6)):
            sched.submit(mod.Request(uid=uid, tokens=np.zeros((n,), np.int32),
                                     max_new_tokens=4))
        trace = []
        for steps in (1, 8, 4):
            plan = sched.plan_step(decode_steps=steps)
            trace.append((plan.decode_slots, plan.decode_steps, plan.tokens,
                          plan.prefill.req.uid, plan.prefill.slot))
            if hasattr(sched, "prefill_advance"):   # the reference's chunks
                sched.prefill_advance(plan.prefill)
            sched.activate(mod.ActiveRequest(
                req=plan.prefill.req, slot=plan.prefill.slot,
                pos=plan.prefill.req.prompt_len))
        plans.append(trace)
    assert plans[0] == plans[1]


def test_decode_steps_validation_and_config_default(world):
    model = world[1]
    with pytest.raises(ValueError, match="decode_steps"):
        ContinuousBatchingEngine(model, max_slots=2, max_len=32,
                                 decode_steps=0)
    m8 = LanguageModel(dataclasses.replace(CFG, decode_steps_per_dispatch=8),
                       model.params(), device="cpu")
    assert ContinuousBatchingEngine(m8, max_slots=2,
                                    max_len=32).decode_steps == 8
    assert ContinuousBatchingEngine(m8, max_slots=2, max_len=32,
                                    decode_steps=1).decode_steps == 1
    m0 = LanguageModel(dataclasses.replace(CFG, decode_steps_per_dispatch=0),
                       model.params(), device="cpu")
    with pytest.raises(ValueError, match="decode_steps"):
        ContinuousBatchingEngine(m0, max_slots=2, max_len=32)


def test_epoch_length_refused_outside_its_buffers(loops):
    _, _, cfg, params, _, pool, feed, pos = loops["float32"]
    epoch = pmodel.DecodeEpoch(params, _fresh(pool), cfg, slots=2, n_max=4,
                               max_len=LOOP_LEN)
    epoch.load(feed, pos, np.ones((2,), bool), np.full((2,), 9),
               np.full((2,), -1))
    for n in (0, 5):
        with pytest.raises(ValueError, match="epoch length"):
            epoch.run(n)


def test_graph_launch_accounting():
    """A capture ticks the wrappers' counters without launching:
    ``set_kernel_launches`` takes the ticks back.  A replay runs the
    captured kernels without the wrappers: ``DEVICE_KERNELS`` names the
    device kernels each counted launch runs — every ``__global__`` of
    ``csrc`` once — by which ``chip_smoke.py`` holds a traced replay
    against its capture delta."""
    ops.reset_kernel_launches()
    before = ops.kernel_launches()
    assert set(before) >= {"router_stats", "fused_linear_splitk",
                           "flash_attention_splitkv", "paged_attention_split",
                           "int4_matmul_stream", "ssd_scan_tc"}
    ops.set_kernel_launches({"router_stats": 7, "fused_linear_splitk": 28})
    now = ops.kernel_launches()
    assert now["router_stats"] == 7 and now["fused_linear_splitk"] == 28
    assert now["fused_linear"] == 0
    ops.set_kernel_launches(before)
    assert ops.kernel_launches() == before

    csrc = Path(ops.__file__).parent / "csrc"
    src = re.sub(r"//[^\n]*", "", "".join(
        f.read_text() for f in sorted(csrc.glob("*.cu"))))
    kernels = re.findall(r"__global__\s+(?:void\s+)?(?:__\w+__\([^)]*\)\s*)*"
                         r"(?:void\s+)?(\w+)\s*\(", src)
    assert sorted(kernels) == sorted(ops.DEVICE_KERNELS)
    routes = {r for rs in ops.DEVICE_KERNELS.values() for r in rs}
    assert routes <= set(before)
    assert ops.device_kernel(
        "void (anonymous namespace)::splitk_stream<4>(__nv_bfloat16 const*, "
        "float const*, int)") == "splitk_stream"
    assert ops.device_kernel("void (anonymous namespace)::simt::"
                             "ssd_scan_kernel<float>(float const*)") == \
        "ssd_scan_kernel"
    assert ops.device_kernel("router_pass") == "router_pass"
    assert ops.device_kernel(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int)") is None
    got = ops.device_kernel_launches({"fused_linear_splitk": 3,
                                      "int4_matmul_stream": 1,
                                      "fused_linear_int4_stream": 2})
    assert {k: v for k, v in got.items() if v} == {
        "splitk_stream": 3, "splitk_epilogue": 3, "int4_stream": 3}


@pytest.mark.parametrize("pages_per_slot", [1, 2, 7, 64, 1088])
def test_paged_capture_bound_counts_every_table_width(pages_per_slot):
    """``chip_smoke.table_widths`` bounds the paged captures: it holds every
    width the fused paged loop can load (``j_step``: the live chain's
    power-of-two bucket clamped to pages_per_slot), no more."""
    widths = {min(1 << (j - 1).bit_length(), pages_per_slot)
              for j in range(1, pages_per_slot + 1)}
    assert chip_smoke.table_widths(pages_per_slot) == widths


@pytest.mark.parametrize("extra", [[], ["--paged-kv"]])
def test_launcher_decode_steps_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--continuous", "--batch", "2", "--prompt-len", "12",
                       "--new-tokens", "6", "--decode-steps", "4", *extra])
    out = capsys.readouterr().out
    assert "requests: 4" in out and "graphs captured 0" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device",
                           "cpu", "--decode-steps", "4"])
