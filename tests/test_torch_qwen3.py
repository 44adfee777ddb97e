"""qwen3-8b in the port (qk-norm, grouped-query attention) on the CPU
against the JAX package.

The smoke config runs with ``num_kv_heads=2`` (plain smoke has 4 kv heads
for 4 heads, so no GQA): G = 2 query heads a kv head.  Held here: the
config copy, the bridge's ``qnorm`` / ``knorm`` leaves bit for bit both
ways, ``project_qkv`` with qk-norm against the reference's fused path
(``use_kernels=True``, Pallas in interpret mode), prefill and
teacher-forced decode steps in masked and gather mode, teacher-forced
paged decode steps, the continuous engine in the dense pool and the paged
store (masked) and the dense pool in gather mode against the reference's
engines (its jnp path, ``use_kernels=False``), and ``--arch qwen3-8b``
through the launcher.

The per-head norm gammas are drawn away from 1 (the init's ones would
not show a missing scale), the routers at unit scale with zero bias so
routing skips.  Tolerances (fp32): logits ≤ 1e-4·max|ref|; gate logs,
selected indices, tokens and ``ServeStats`` counts equal."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kvcache import paged as jpaged
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kvcache import paged as ppaged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine
from test_torch_gather import Recorder
from test_torch_obs import JIT_ATTRS, _CopyingNumpy

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
B, T0, STEPS, NEW = 2, 32, 3, 5
LENS = (9, 21, 32, 40)


def _cfgs(mode="masked"):
    def one(cfg, **kw):
        return dataclasses.replace(
            cfg, dtype="float32", num_kv_heads=2,
            skip=dataclasses.replace(cfg.skip, mode=mode), **kw)
    return (one(jget_config("qwen3-8b").smoke(), use_kernels=True),
            one(get_config("qwen3-8b").smoke()))


JCFG, CFG = _cfgs()


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def world():
    """(reference numpy tree, jnp tree, port model): routers at unit scale
    with zero bias, qk-norm gammas in [0.5, 1.5)."""
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED),
                                               JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif k in ("qnorm", "knorm"):
                v["gamma"] = rng.uniform(0.5, 1.5, v["gamma"].shape).astype(
                    np.float32)
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return ref, jax.tree_util.tree_map(jnp.asarray, ref), model


def test_config_copy_matches_reference():
    for full in (False, True):
        a, b = jget_config("qwen3-8b"), get_config("qwen3-8b")
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    full = get_config("qwen3-8b")
    assert (full.num_heads // full.num_kv_heads, full.qk_norm) == (4, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_qk_norm_leaves(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg))
    ref["stack"]["stage0"]["pos0"]["mixer"]["inner"]["qnorm"]["gamma"] = \
        np.linspace(0.5, 1.5, cfg.resolved_head_dim).astype(
            ref["stack"]["stage0"]["pos0"]["mixer"]["inner"]["qnorm"][
                "gamma"].dtype)
    port = bridge.from_reference(ref, cfg)
    for b in port["blocks"]:
        inner = b["mixer"]["inner"]
        assert set(inner) == {"wqkv", "wo", "qnorm", "knorm"}
        assert inner["knorm"]["gamma"].shape == (cfg.resolved_head_dim,)
    back = bridge.to_reference(port, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(ref)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(a, b)
    # the port's own init: gamma ones in the model's dtype
    own = LanguageModel(cfg, device="cpu", seed=0).params()
    g = own["blocks"][0]["mixer"]["inner"]["qnorm"]["gamma"]
    assert g.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    assert torch.equal(g, torch.ones_like(g))


def test_project_qkv_with_qk_norm(world):
    ref, _, model = world
    jp = ref["stack"]["stage0"]["pos0"]["mixer"]
    pp = model.params()["blocks"][0]["mixer"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 9, CFG.d_model)).astype(np.float32)
    pos = rng.integers(0, 300, (B, 9)).astype(np.int32)
    stats = (x ** 2).mean(-1)
    jt = jax.tree_util.tree_map(jnp.asarray, jp)
    jq, jk, jv = jattn.project_qkv(jt["inner"], jnp.asarray(x),
                                   jnp.asarray(pos), JCFG, norm=jt["norm"],
                                   stats=jnp.asarray(stats))
    q, k, v = attention.project_qkv(pp["inner"], torch.from_numpy(x),
                                    torch.from_numpy(pos), CFG,
                                    norm=pp["norm"],
                                    stats=torch.from_numpy(stats))
    assert q.shape == (B, 9, 4, 64) and k.shape == (B, 9, 2, 64)
    for a, b in ((q, jq), (k, jk), (v, jv)):
        _close(a, b)
    # qk-norm is there: without it q differs
    plain = dataclasses.replace(CFG, qk_norm=False)
    q0, _, _ = attention.project_qkv(pp["inner"], torch.from_numpy(x),
                                     torch.from_numpy(pos), plain,
                                     norm=pp["norm"],
                                     stats=torch.from_numpy(stats))
    assert (q0 - q).abs().max() > 0.1 * q.abs().max()


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


@pytest.mark.parametrize("mode", ["masked", "gather"])
def test_prefill_decode_match_reference(world, mode, monkeypatch):
    _, jparams, model = world
    jcfg, cfg = _cfgs(mode)
    model = LanguageModel(cfg, model.params(), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, (B, T0))
    forced = rng.integers(0, CFG.vocab_size, (B, STEPS))
    rec = Recorder(monkeypatch)
    jl, jg = _jax_forced(jparams, jcfg, toks, forced)
    jax.effects_barrier()
    pl, pg = _port_forced(model, toks, forced)
    if mode == "gather":
        rec.check()
    else:
        assert not rec.port and not rec.ref
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)
    assert 0.0 < np.concatenate([g.ravel() for g in pg]).mean() < 1.0
    for a, b in zip(pl, jl):
        _close(a, b)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_paged_decode_matches_reference(world):
    """Teacher-forced paged decode steps (G = 2 over the entry stream,
    paged attention's plain version) against the reference's jnp path,
    both from the reference's packed store: gates and entry metadata
    exactly, logits and payloads ≤ 1e-4·max."""
    _, jparams, model = world
    params = model.params()
    rng = np.random.default_rng(4)
    lens = [12, 12]          # one prefill shape: one reference compile
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in lens]
    forced = rng.integers(0, CFG.vocab_size, (STEPS, 2))
    nA, P, ps = CFG.num_layers, 32, 8
    alloc = ppaged.PageAllocator(P, ps, 2, slot_entry_capacity=32 * nA)
    jcfg = dataclasses.replace(JCFG, use_kernels=False)
    jstore = jpaged.init_store(jcfg, P, ps)
    jprefill = jax.jit(partial(jmodel.prefill, cfg=jcfg))
    for i, p in enumerate(prompts):
        _, c, st = jprefill(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        n = jpaged.prefill_entry_count(g, lens[i], True)
        assert alloc.ensure(i, n + nA)
        jstore = jpaged.pack_prefill(jstore, c, jnp.asarray(g),
                                     jnp.int32(lens[i]),
                                     jnp.asarray(alloc.block_table[i]), jcfg)
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
        for k in ("k_pages", "v_pages"):
            _close(store[k], jstore[k])
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


def _serve(eng, prompts):
    uids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    out = eng.run()
    if getattr(eng, "kv_mode", "dense") == "paged":
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages
    return [out["results"][u] for u in uids], out["stats"]


STATS = ("prefill_tokens", "decode_tokens", "requests_completed",
         "decode_dispatches", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "pages_total", "pages_peak",
         "preemptions", "kv_entries_stored", "kv_entries_dense",
         "history_hit_rate", "history_hits_per_layer")


@pytest.mark.parametrize("mode,kv_mode,steps", [
    ("masked", "dense", 1), ("masked", "paged", 1), ("masked", "paged", 4),
    ("gather", "dense", 1), ("gather", "dense", 4)])
def test_engines_match_reference(world, reference_engine, mode, kv_mode,
                                 steps, monkeypatch):
    _, jparams, model = world
    jcfg, cfg = _cfgs(mode)
    jcfg = dataclasses.replace(jcfg, use_kernels=False)
    model = LanguageModel(cfg, model.params(), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in LENS]
    geom = dict(max_slots=2, max_len=40 + NEW, decode_steps=steps,
                kv_mode=kv_mode,
                **({"page_size": 8} if kv_mode == "paged" else {}))
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


@pytest.mark.parametrize("extra", [
    [], ["--continuous", "--paged-kv"], ["--continuous", "--gather"]])
def test_launcher_qwen3_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert "qwen3-8b-smoke: routing: " in out and "qk-norm True" in out
    assert ("paged KV: peak" in out) == ("--paged-kv" in extra)
