"""stablelm-3b in the port (LayerNorm: the unfused path; partial rotary
0.25) on the CPU against the JAX package, and its chunked, speculative
and prefix-cache runs against the port's own plain runs.

The smoke config (2 layers, d_model 128, 4 heads of 32 dims, 8 of them
rotated) runs in fp32.  Held here: the config copy, the bridge's LayerNorm
``beta`` leaves bit for bit both ways, prefill and teacher-forced decode
steps in masked and gather mode (the reference's kernels in Pallas
interpret mode), the same with the linears quantized to int4 (every
linear through the int4 matmul), teacher-forced paged decode steps over
int8 pages, the continuous engine in the dense pool and in int8 pages,
single-step and in fused epochs, against the reference's engines (its
jnp path); then chunk 8, ``spec_k``
2 and the prefix cache against the port's whole-prompt, plain and cold
runs (tokens, each request's gate log and the KV accounting equal); and
``--arch stablelm-3b`` through the launcher.

The norms' gamma and beta are drawn away from 1 and 0 (the init's would
not show a missing term), the routers at unit scale with zero bias so
routing skips.  Tolerances (fp32): logits ≤ 1e-4·max|ref|; gate logs,
selected indices, tokens and ``ServeStats`` counts equal."""
import dataclasses
import pathlib
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kvcache import paged as jpaged
from repro.models import model as jmodel
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kvcache import paged as ppaged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine
from test_torch_gather import Recorder
from test_torch_obs import JIT_ATTRS, _CopyingNumpy
from test_torch_quant import GROUP, MIN_SIZE, quantize_all_layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root: its engine gate-log watch)

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
B, T0, STEPS, NEW = 2, 32, 3, 5
LENS = (9, 21, 32, 40)


def _cfgs(mode="masked", use_kernels=True):
    def one(cfg, **kw):
        return dataclasses.replace(
            cfg, dtype="float32",
            skip=dataclasses.replace(cfg.skip, mode=mode), **kw)
    return (one(jget_config("stablelm-3b").smoke(), use_kernels=use_kernels),
            one(get_config("stablelm-3b").smoke()))


JCFG, CFG = _cfgs()


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _fix(tree, rng):
    """Routers at unit scale with zero bias; every norm's gamma in [0.5,
    1.5) and beta in [-0.5, 0.5)."""
    for k, v in tree.items():
        if k == "router":
            v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
            v["b"] = np.zeros_like(v["b"])
        elif k in ("norm", "final_norm"):
            v["gamma"] = rng.uniform(0.5, 1.5, v["gamma"].shape).astype(
                np.float32)
            v["beta"] = rng.uniform(-0.5, 0.5, v["beta"].shape).astype(
                np.float32)
        elif isinstance(v, dict):
            _fix(v, rng)


@pytest.fixture(scope="module")
def world():
    """(reference numpy tree, jnp tree, port model)."""
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED),
                                               JCFG))
    _fix(ref, np.random.default_rng(SEED))
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return ref, jax.tree_util.tree_map(jnp.asarray, ref), model


def test_config_copy_matches_reference():
    for full in (False, True):
        a, b = jget_config("stablelm-3b"), get_config("stablelm-3b")
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    full = get_config("stablelm-3b")
    assert (full.norm_type, full.resolved_head_dim, full.rotary_pct) == (
        "layernorm", 80, 0.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_layernorm_leaves(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg))
    beta = ref["stack"]["stage0"]["pos0"]["ffn"]["norm"]["beta"]
    ref["stack"]["stage0"]["pos0"]["ffn"]["norm"]["beta"] = np.linspace(
        -1, 1, beta.shape[0]).astype(beta.dtype)
    port = bridge.from_reference(ref, cfg)
    for b in port["blocks"]:
        for sub in ("mixer", "ffn"):
            assert set(b[sub]["norm"]) == {"gamma", "beta"}
    assert set(port["final_norm"]) == {"gamma", "beta"}
    back = bridge.to_reference(port, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(ref)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(a, flat_b[path])
    own = LanguageModel(cfg, device="cpu", seed=0).params()
    bt = own["blocks"][1]["mixer"]["norm"]["beta"]
    assert bt.dtype == (torch.float32 if dtype == "float32"
                        else torch.bfloat16)
    assert torch.equal(bt, torch.zeros_like(bt))


def _jax_forced(jparams, jcfg, toks, forced):
    prefill = jax.jit(partial(jmodel.prefill, cfg=jcfg, pad_to=T0 + STEPS))
    decode = jax.jit(partial(jmodel.decode_step, cfg=jcfg))
    lg, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, gates = [np.asarray(lg)], [np.asarray(st["attn_gate"])]
    for s in range(STEPS):
        lg, cache, st = decode(
            jparams, cache, {"tokens": jnp.asarray(forced[:, s:s + 1])},
            jnp.int32(T0 + s))
        logits.append(np.asarray(lg))
        gates.append(np.asarray(st["attn_gate"]))
    return logits, gates


def _port_forced(model, toks, forced):
    lg, cache, st = model.prefill(torch.from_numpy(toks), pad_to=T0 + STEPS)
    logits, gates = [lg.numpy()], [st["attn_gate"].numpy()]
    for s in range(STEPS):
        lg, cache, st = model.decode_step(
            cache, torch.from_numpy(forced[:, s:s + 1]), T0 + s)
        logits.append(lg.numpy())
        gates.append(st["attn_gate"].numpy())
    return logits, gates


def _check_forced(pl, pg, jl, jg):
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)
    assert 0.0 < np.concatenate([g.ravel() for g in pg]).mean() < 1.0
    for a, b in zip(pl, jl):
        _close(a, b)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("mode", ["masked", "gather"])
def test_prefill_decode_match_reference(world, mode, monkeypatch):
    ref, _, model = world
    jcfg, cfg = _cfgs(mode)
    model = LanguageModel(cfg, model.params(), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, (B, T0))
    forced = rng.integers(0, CFG.vocab_size, (B, STEPS))
    rec = Recorder(monkeypatch)
    jl, jg = _jax_forced(jax.tree_util.tree_map(jnp.asarray, ref), jcfg,
                         toks, forced)
    jax.effects_barrier()
    pl, pg = _port_forced(model, toks, forced)
    if mode == "gather":
        rec.check()
    else:
        assert not rec.port and not rec.ref
    _check_forced(pl, pg, jl, jg)


def test_int4_weights_match_reference(world):
    """Every linear (and the lm head) quantized by the reference's rule
    applied to every layer: the port's unfused path runs each through the
    int4 matmul's plain version, the reference's through its Pallas
    kernel in interpret mode (its jnp path multiplies by the exact
    dequantized weights instead of the BFP product)."""
    ref, _, _ = world
    q = quantize_all_layers(ref, GROUP, True, MIN_SIZE)
    model = LanguageModel(CFG, bridge.from_reference(q, CFG), device="cpu")
    inner = model.params()["blocks"][1]["mixer"]["inner"]
    assert "w_int" in inner["wqkv"] and "w_int" in model.params()["lm_head"]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, CFG.vocab_size, (B, T0))
    forced = rng.integers(0, CFG.vocab_size, (B, STEPS))
    jl, jg = _jax_forced(jax.tree_util.tree_map(jnp.asarray, q), JCFG, toks,
                         forced)
    _check_forced(*_port_forced(model, toks, forced), jl, jg)


def test_paged_decode_int8_matches_reference(world):
    """Teacher-forced paged decode steps over int8 pages (paged attention's
    plain version) against the reference's jnp path, both from the
    reference's packed store: gates, entry metadata and codes exactly,
    logits ≤ 1e-4·max."""
    _, jparams, model = world
    params = model.params()
    rng = np.random.default_rng(4)
    lens = [12, 12]          # one prefill shape: one reference compile
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in lens]
    forced = rng.integers(0, CFG.vocab_size, (STEPS, 2))
    nA, P, ps = CFG.num_layers, 32, 8
    alloc = ppaged.PageAllocator(P, ps, 2, slot_entry_capacity=32 * nA)
    jcfg = dataclasses.replace(JCFG, use_kernels=False)
    jstore = jpaged.init_store(jcfg, P, ps, kv_dtype="int8")
    jprefill = jax.jit(partial(jmodel.prefill, cfg=jcfg))
    for i, p in enumerate(prompts):
        _, c, st = jprefill(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        n = jpaged.prefill_entry_count(g, lens[i], True)
        assert alloc.ensure(i, n + nA)
        jstore = jpaged.pack_prefill(jstore, c, jnp.asarray(g),
                                     jnp.int32(lens[i]),
                                     jnp.asarray(alloc.block_table[i]), jcfg,
                                     kv_dtype="int8")
        alloc.append(i, n, nA * lens[i])
    store = bridge.store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()})
    jstep = jax.jit(partial(jmodel.paged_decode_step, cfg=jcfg))
    t = np.array(lens, np.int32)
    for s in range(STEPS):
        for i in range(2):
            assert alloc.ensure(i, int(alloc.fill[i]) + nA)
        bt, fill = alloc.block_table.copy(), alloc.fill.copy()
        jl, jstore, jst = jstep(jparams, jstore,
                                {"tokens": jnp.asarray(forced[s][:, None])},
                                jnp.asarray(t), jnp.asarray(bt),
                                jnp.asarray(fill))
        pl, store, pst = pmodel.paged_decode_step(
            params, store, torch.from_numpy(forced[s][:, None]),
            torch.from_numpy(t), torch.from_numpy(bt),
            torch.from_numpy(fill), CFG)
        gates = pst["attn_gate"].numpy()
        np.testing.assert_array_equal(gates, np.asarray(jst["attn_gate"]))
        _close(pl, jl)
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(store[k].numpy(),
                                          np.asarray(jstore[k]))
        assert store["k_pages"].dtype == torch.int8
        for i in range(2):
            alloc.append(i, int(1 + gates[1:, i].sum()), nA)
        t = t + 1


@pytest.fixture(scope="module")
def reference_engine():
    built = {}

    def make(jcfg, params, **kw):
        eng = jengine.ContinuousBatchingEngine(
            jcfg, params, config=jconfig.EngineConfig.from_kwargs(**kw))
        key = (jcfg.skip.mode,) + tuple(sorted(kw.items()))
        first = built.setdefault(key, eng)
        for name in JIT_ATTRS:
            if hasattr(first, name):
                setattr(eng, name, getattr(first, name))
        return eng

    return make


def _serve(eng, prompts, log=None):
    uids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    if log is not None:
        chip_smoke.watch_engine(eng, log)
    out = eng.run()
    if getattr(eng, "kv_mode", "dense") == "paged":
        pins = eng.prefix.page_pins() if getattr(eng, "prefix", None) \
            else {}
        eng.allocator.check_conservation(pins)
        assert eng.allocator.free_pages + len(pins) == eng.num_pages
    return [out["results"][u] for u in uids], out["stats"]


STATS = ("prefill_tokens", "decode_tokens", "requests_completed",
         "decode_dispatches", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "pages_total", "pages_peak",
         "preemptions", "kv_entries_stored", "kv_entries_dense",
         "history_hit_rate", "history_hits_per_layer")


def _prompts(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in LENS]


@pytest.mark.parametrize("mode,kv_mode,steps", [
    ("masked", "dense", 1), ("masked", "dense", 4), ("masked", "paged", 1),
    ("masked", "paged", 4)])
def test_engines_match_reference(world, reference_engine, mode, kv_mode,
                                 steps, monkeypatch):
    _, jparams, model = world
    jcfg, cfg = _cfgs(mode, use_kernels=False)
    model = LanguageModel(cfg, model.params(), device="cpu")
    prompts = _prompts()
    geom = dict(max_slots=2, max_len=40 + NEW, decode_steps=steps,
                kv_mode=kv_mode, **({"page_size": 8, "kv_dtype": "int8"}
                                    if kv_mode == "paged" else {}))
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())
    rec = Recorder(monkeypatch)
    jres, js = _serve(reference_engine(jcfg, jparams, **geom), prompts)
    jax.effects_barrier()
    pres, ps = _serve(ContinuousBatchingEngine(model, **geom), prompts)
    if mode == "gather":
        rec.check()
    for a, b in zip(pres, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.finish_reason, a.kv_stored, a.kv_dense) == \
            (b.finish_reason, b.kv_stored, b.kv_dense)
    for name in STATS:
        assert getattr(ps, name) == getattr(js, name), name
    assert 0.0 < ps.attn_keep_frac < 1.0


def _same_runs(a, b, totals=("kv_entries_stored", "kv_entries_dense")):
    """Two port runs: tokens, each request's prompt gate log and decode
    gate columns, and the KV accounting (each request's, the keep and hit
    rates, and ``totals``) equal."""
    (ra, sa, la), (rb, sb, lb) = a, b
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert (x.kv_stored, x.kv_dense) == (y.kv_stored, y.kv_dense)
    for uid, (pg, cols) in la["gates"].items():
        pg2, cols2 = lb["gates"][uid]
        np.testing.assert_array_equal(pg, pg2)
        assert len(cols) == len(cols2)
        for u, v in zip(cols, cols2):
            np.testing.assert_array_equal(u, v)
    for name in ("attn_keep_frac", "kv_saved_fraction", "history_hit_rate",
                 *totals):
        assert getattr(sa, name) == getattr(sb, name), name


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_chunked_and_speculative_equal_plain(world, kv_mode):
    """Chunk 8 and ``spec_k`` 2 against the whole-prompt plain run of the
    same engine geometry."""
    _, _, model = world
    prompts = _prompts(7)
    geom = dict(max_slots=2, max_len=40 + NEW, kv_mode=kv_mode,
                **({"page_size": 8} if kv_mode == "paged" else {}))

    def run(**kw):
        log = {}
        res, st = _serve(ContinuousBatchingEngine(model, **geom, **kw),
                         prompts, log)
        return res, st, log

    plain = run()
    chunked = run(prefill_chunk=8)
    assert chunked[1].prefill_chunks > len(prompts)
    _same_runs(plain, chunked)
    spec = run(spec_k=2)
    assert spec[1].spec_windows > 0
    _same_runs(plain, spec)


def test_prefix_cache_warm_equals_cold(world):
    """Four requests sharing a 24-token prefix, behind a publisher: the
    paged engine with the prefix cache on (every admission warm) against
    it off; the warm run stores and counts as dense exactly the shared
    entries fewer."""
    _, _, model = world
    rng = np.random.default_rng(8)
    head = rng.integers(0, CFG.vocab_size, (24,)).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, CFG.vocab_size, (n,)).astype(np.int32)]) for n in (3, 9, 12, 5)]
    geom = dict(max_slots=2, max_len=48, kv_mode="paged", page_size=8,
                prefix_block=8)
    runs = []
    for cache in (True, False):
        eng = ContinuousBatchingEngine(model, prefix_cache=cache, **geom)
        _serve(eng, [np.concatenate([head, prompts[0][24:]])])
        log = {}
        res, st = _serve(eng, prompts, log)
        runs.append((res, st, log))
    warm, cold = runs[0][1], runs[1][1]
    assert warm.prefix_hits == len(prompts) and warm.prefix_tokens_saved > 0
    _same_runs(runs[0], runs[1], totals=())
    assert cold.kv_entries_dense - warm.kv_entries_dense == \
        CFG.num_layers * warm.prefix_tokens_saved
    assert warm.kv_entries_stored < cold.kv_entries_stored


@pytest.mark.parametrize("extra", [
    [], ["--int4"], ["--continuous", "--paged-kv", "--kv-dtype", "int4"],
    ["--continuous", "--gather"]])
def test_launcher_stablelm_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert "stablelm-3b-smoke: routing: " in out
    assert ("paged KV: peak" in out) == ("--paged-kv" in extra)
