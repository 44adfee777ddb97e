"""grok-1-314b in the port (top-k MoE with GeGLU experts on the unfused
branch of a fused RMSNorm stack) on the CPU against the JAX package, and
its chunked, speculative and prefix-cache runs against the port's own
plain runs.  ``test_torch_arctic.py`` runs the same checks on
arctic-480b through the helpers here.

The smoke config (2 layers, d_model 128, 4 heads of 64 dims, 4 experts,
top 2) runs in fp32 at the configs' capacity factor 1.25.  Held here:
prefill and teacher-forced decode steps in masked and gather mode (the
reference's kernels in Pallas interpret mode; gates, each MoE call's
expert choices through ``ExpertRecorder``, logits, the stats' summed
``moe_lb_loss`` and ``n_moe``), the same with int4 weights (the tree bit
for bit the reference's rule, the experts dense), teacher-forced paged
decode steps over int8 pages, the continuous engine in the dense pool
and in int8 pages, single-step and in fused epochs, against the
reference's engines (its jnp path); at factor 8.0 (nothing dropped, so a
token's output does not depend on its batch) chunk 8, ``spec_k`` 2 and
the prefix cache against the port's whole-prompt, plain and cold runs; a
reduced config with G 6 (6 query heads over 1 kv head, as the full
width's 48 over 8) lock-step and paged; ``--arch grok-1-314b`` through
the launcher.

Routers at unit scale with zero bias so routing skips.  Tolerances
(fp32): logits ≤ 1e-4·max|ref|; gate logs, expert choices, tokens and
``ServeStats`` counts equal."""
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
from repro_torch.models import layers, moe
from repro_torch.models.model import LanguageModel
from repro_torch.quant import int4_head, int4_linears, quantize_params
from repro_torch.serve.engine import ContinuousBatchingEngine
from test_torch_gather import Recorder
from test_torch_obs import JIT_ATTRS, _CopyingNumpy
from test_torch_quant import GROUP, MIN_SIZE, quantize_all_layers
from test_torch_stablelm import _same_runs

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root: its engine gate-log watch)

torch.set_num_threads(2)

ARCH = "grok-1-314b"
SEED = 0
TOL = 1e-4
MIN_MARGIN = 1e-4   # no expert choice this close to its tie (port side)
B, T0, STEPS, NEW = 2, 32, 3, 5
LENS = (9, 21, 32, 40)
DROP_FREE = 8.0     # the reference's own tests' factor (test_models.py)
G6 = dict(num_heads=6, num_kv_heads=1, head_dim=32)


def cfgs(arch, mode="masked", use_kernels=True, factor=None, **kw):
    """(reference config, port config): the smoke config in fp32."""
    def one(cfg, **more):
        cfg = cfg.smoke()
        return dataclasses.replace(
            cfg, dtype="float32",
            moe_capacity_factor=factor or cfg.moe_capacity_factor,
            skip=dataclasses.replace(cfg.skip, mode=mode), **kw, **more)
    return (one(jget_config(arch), use_kernels=use_kernels),
            one(get_config(arch)))


def close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def fix_routers(tree, rng):
    """Routers at unit scale with zero bias (the experts' ``gate`` leaf is
    the reference's draw)."""
    for k, v in tree.items():
        if k == "router":
            v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
            v["b"] = np.zeros_like(v["b"])
        elif isinstance(v, dict):
            fix_routers(v, rng)


def make_world(jcfg, cfg, seed=SEED):
    """(reference numpy tree, jnp tree, port model)."""
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(seed),
                                               jcfg))
    fix_routers(ref, np.random.default_rng(seed))
    model = LanguageModel(cfg, bridge.from_reference(ref, cfg), device="cpu")
    return ref, jax.tree_util.tree_map(jnp.asarray, ref), model


_SINK = [None]


def _record_reference(e):
    _SINK[0].append(np.asarray(e))


class ExpertRecorder:
    """Each MoE call's expert choices in both packages: the port's through
    ``moe.top_k_experts`` (with the smallest gap between adjacent ones of
    the K + 1 largest probabilities), the reference's through an ordered
    ``jax.debug.callback`` on ``jax.lax.top_k`` over E experts.  A trace
    made before the recorder exists records nothing, so every reference
    function it watches must be jitted afresh."""

    def __init__(self, monkeypatch, n_experts):
        self.port, self.ref, self.gaps = [], [], []
        p_orig, j_orig = moe.top_k_experts, jax.lax.top_k

        def port(probs, k):
            s = torch.sort(probs, dim=-1, descending=True).values
            self.gaps.append(float((s[:, :k] - s[:, 1:k + 1]).min()))
            vals, idx = p_orig(probs, k)
            self.port.append(idx.numpy().copy())
            return vals, idx

        def ref(operand, k):
            vals, idx = j_orig(operand, k)
            if operand.shape[-1] == n_experts:
                jax.debug.callback(_record_reference, idx, ordered=True)
            return vals, idx

        _SINK[0] = self.ref
        monkeypatch.setattr(moe, "top_k_experts", port)
        monkeypatch.setattr(jax.lax, "top_k", ref)

    def check(self, calls):
        jax.effects_barrier()
        assert len(self.port) == len(self.ref) == calls
        for a, b in zip(self.port, self.ref):
            np.testing.assert_array_equal(a, b)
        assert min(self.gaps) >= MIN_MARGIN, min(self.gaps)


def jax_forced(jparams, jcfg, toks, forced):
    prefill = jax.jit(partial(jmodel.prefill, cfg=jcfg,
                              pad_to=toks.shape[1] + forced.shape[1]))
    decode = jax.jit(partial(jmodel.decode_step, cfg=jcfg))
    lg, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, gates = [np.asarray(lg)], [np.asarray(st["attn_gate"])]
    moe_st = [(float(st["moe_lb_loss"]), float(st["n_moe"]))]
    for s in range(forced.shape[1]):
        lg, cache, st = decode(
            jparams, cache, {"tokens": jnp.asarray(forced[:, s:s + 1])},
            jnp.int32(toks.shape[1] + s))
        logits.append(np.asarray(lg))
        gates.append(np.asarray(st["attn_gate"]))
    return logits, gates, moe_st


def port_forced(model, toks, forced):
    T = toks.shape[1]
    lg, cache, st = model.prefill(torch.from_numpy(toks),
                                  pad_to=T + forced.shape[1])
    logits, gates = [lg.numpy()], [st["attn_gate"].numpy()]
    moe_st = [(float(st["moe_lb_loss"]), float(st["n_moe"]))]
    for s in range(forced.shape[1]):
        lg, cache, st = model.decode_step(
            cache, torch.from_numpy(forced[:, s:s + 1]), T + s)
        logits.append(lg.numpy())
        gates.append(st["attn_gate"].numpy())
    return logits, gates, moe_st


def check_forced(port, ref):
    (pl, pg, pm), (jl, jg, jm) = port, ref
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)
    assert 0.0 < np.concatenate([g.ravel() for g in pg]).mean() < 1.0
    for a, b in zip(pl, jl):
        close(a, b)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    for (a, n), (b, m) in zip(pm, jm):
        assert n == m > 0 and abs(a - b) <= 1e-5 * abs(b)


def lockstep(world, arch, mode, monkeypatch, seed=3):
    """Prefill + STEPS teacher-forced decode steps in ``mode`` against the
    reference's fused path: gates, expert choices, logits, MoE stats."""
    ref, _, model = world
    jcfg, cfg = cfgs(arch, mode)
    model = LanguageModel(cfg, model.params(), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T0))
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    experts = ExpertRecorder(monkeypatch, cfg.num_experts)
    rec = Recorder(monkeypatch)
    jout = jax_forced(jax.tree_util.tree_map(jnp.asarray, ref), jcfg, toks,
                      forced)
    jax.effects_barrier()
    pout = port_forced(model, toks, forced)
    if mode == "gather":
        rec.check()
    experts.check(cfg.num_layers * (STEPS + 1))
    check_forced(pout, jout)


def int4_lockstep(world, arch, monkeypatch):
    """The reference's rule applied to every layer (2-D ``w`` leaves):
    attention, Arctic's dense residual and the head in int4, the experts
    and ``gate`` dense; the port's ``quantize_params`` gives the same tree
    bit for bit, and its lock-step run equals the reference's (Pallas in
    interpret mode)."""
    ref, _, model = world
    jcfg, cfg = cfgs(arch)
    q = quantize_all_layers(ref, GROUP, True, MIN_SIZE)
    got = quantize_params(model.params(), GROUP, True, MIN_SIZE)
    want = bridge.from_reference(q, cfg)
    assert int4_linears(got) and int4_head(got)

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    walk(got, want)
    for blk in got["blocks"]:
        inner = blk["ffn"]["inner"]
        assert all(inner[k].dtype == torch.float32 and inner[k].ndim == 3
                   for k in ("w_up", "w_down", "w_gate"))
        assert "w_int" in blk["mixer"]["inner"]["wqkv"]
        if "dense" in inner:
            assert "w_int" in inner["dense"]["gu"]
    m4 = LanguageModel(cfg, got, device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, T0))
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    experts = ExpertRecorder(monkeypatch, cfg.num_experts)
    jout = jax_forced(jax.tree_util.tree_map(jnp.asarray, q), jcfg, toks,
                      forced)
    pout = port_forced(m4, toks, forced)
    experts.check(cfg.num_layers * (STEPS + 1))
    check_forced(pout, jout)


def paged_int8(world, jcfg, cfg, monkeypatch):
    """Teacher-forced paged decode steps over int8 pages against the
    reference's jnp path, both from the reference's packed store: gates,
    expert choices and entry metadata exactly, logits ≤ 1e-4·max."""
    _, jparams, model = world
    model = LanguageModel(cfg, model.params(), device="cpu")
    params = model.params()
    rng = np.random.default_rng(4)
    lens = [12, 12]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    forced = rng.integers(0, cfg.vocab_size, (STEPS, 2))
    nA, P, ps = cfg.num_layers, 32, 8
    alloc = ppaged.PageAllocator(P, ps, 2, slot_entry_capacity=32 * nA)
    jcfg = dataclasses.replace(jcfg, use_kernels=False)
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
    experts = ExpertRecorder(monkeypatch, cfg.num_experts)
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
            torch.from_numpy(fill), cfg)
        gates = pst["attn_gate"].numpy()
        np.testing.assert_array_equal(gates, np.asarray(jst["attn_gate"]))
        close(pl, jl)
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(store[k].numpy(),
                                          np.asarray(jstore[k]))
        assert store["k_pages"].dtype == torch.int8
        for i in range(2):
            alloc.append(i, int(1 + gates[1:, i].sum()), nA)
        t = t + 1
    experts.check(cfg.num_layers * STEPS)


@pytest.fixture(scope="module")
def reference_engine():
    built = {}

    def make(jcfg, params, **kw):
        eng = jengine.ContinuousBatchingEngine(
            jcfg, params, config=jconfig.EngineConfig.from_kwargs(**kw))
        key = (jcfg.name,) + tuple(sorted(
            (k, v) for k, v in kw.items() if k != "decode_steps"))
        first = built.setdefault(key, eng)
        for name in JIT_ATTRS:
            if hasattr(first, name):
                setattr(eng, name, getattr(first, name))
        return eng

    return make


def serve(eng, prompts, log=None):
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


def prompts_of(cfg, seed=5, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def engines(world, arch, reference_engine, kv_mode, steps, monkeypatch):
    """The continuous engine (2 slots; int8 pages) against the reference's
    on its jnp path: tokens, each request's KV accounting, ServeStats."""
    _, jparams, model = world
    jcfg, cfg = cfgs(arch, use_kernels=False)
    prompts = prompts_of(cfg)
    geom = dict(max_slots=2, max_len=40 + NEW, decode_steps=steps,
                kv_mode=kv_mode, **({"page_size": 8, "kv_dtype": "int8"}
                                    if kv_mode == "paged" else {}))
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())
    jres, js = serve(reference_engine(jcfg, jparams, **geom), prompts)
    pres, ps = serve(ContinuousBatchingEngine(model, **geom), prompts)
    for a, b in zip(pres, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.finish_reason, a.kv_stored, a.kv_dense) == \
            (b.finish_reason, b.kv_stored, b.kv_dense)
    for name in STATS:
        assert getattr(ps, name) == getattr(js, name), name
    assert 0.0 < ps.attn_keep_frac < 1.0


def own_runs(world, arch, kv_mode):
    """At factor 8.0 (nothing dropped): chunk 8 and ``spec_k`` 2 against the
    whole-prompt plain run of the same engine geometry; paged, the prefix
    cache warm against cold."""
    _, _, model = world
    _, cfg = cfgs(arch, factor=DROP_FREE)
    model = LanguageModel(cfg, model.params(), device="cpu")
    prompts = prompts_of(cfg, 7)
    geom = dict(max_slots=2, max_len=40 + NEW, kv_mode=kv_mode,
                **({"page_size": 8} if kv_mode == "paged" else {}))

    def run(**kw):
        log = {}
        res, st = serve(ContinuousBatchingEngine(model, **geom, **kw),
                        prompts, log)
        return res, st, log

    plain = run()
    chunked = run(prefill_chunk=8)
    assert chunked[1].prefill_chunks > len(prompts)
    _same_runs(plain, chunked)
    spec = run(spec_k=2)
    assert spec[1].spec_windows > 0
    _same_runs(plain, spec)
    if kv_mode == "paged":
        prefix_warm_equals_cold(model)


def prefix_warm_equals_cold(model):
    """Four requests sharing a 24-token prefix behind a publisher, the
    prefix cache on (every admission warm) against off."""
    cfg = model.cfg
    rng = np.random.default_rng(8)
    head = rng.integers(0, cfg.vocab_size, (24,)).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)]) for n in (3, 9, 12, 5)]
    geom = dict(max_slots=2, max_len=48, kv_mode="paged", page_size=8,
                prefix_block=8)
    runs = []
    for cache in (True, False):
        eng = ContinuousBatchingEngine(model, prefix_cache=cache, **geom)
        serve(eng, [np.concatenate([head, prompts[0][24:]])])
        log = {}
        res, st = serve(eng, prompts, log)
        runs.append((res, st, log))
    warm, cold = runs[0][1], runs[1][1]
    assert warm.prefix_hits == len(prompts) and warm.prefix_tokens_saved > 0
    _same_runs(runs[0], runs[1], totals=())
    assert cold.kv_entries_dense - warm.kv_entries_dense == \
        cfg.num_layers * warm.prefix_tokens_saved


# ---------------------------------------------------------------------------
# grok-1-314b
# ---------------------------------------------------------------------------

JCFG, CFG = cfgs(ARCH)


@pytest.fixture(scope="module")
def world():
    return make_world(JCFG, CFG)


def test_config_is_moe_geglu():
    full = get_config(ARCH)
    assert (full.num_experts, full.top_k, full.mlp_act, full.dense_residual,
            full.num_heads // full.num_kv_heads) == (8, 2, "geglu", False, 6)
    assert all(full.is_moe_layer(i) for i in range(full.num_layers))
    for blk in LanguageModel(CFG, device="cpu", seed=0).params()["blocks"]:
        assert not layers.mlp_fusable(blk["ffn"]["inner"])
        assert blk["ffn"]["inner"]["w_up"].shape == (4, 128, 256)


@pytest.mark.parametrize("mode", ["masked", "gather"])
def test_lockstep_matches_reference(world, mode, monkeypatch):
    lockstep(world, ARCH, mode, monkeypatch)


def test_int4_weights_match_reference(world, monkeypatch):
    int4_lockstep(world, ARCH, monkeypatch)


def test_paged_decode_int8_matches_reference(world, monkeypatch):
    paged_int8(world, JCFG, CFG, monkeypatch)


@pytest.mark.parametrize("kv_mode,steps", [
    ("dense", 1), ("dense", 4), ("paged", 1), ("paged", 4)])
def test_engines_match_reference(world, reference_engine, kv_mode, steps,
                                 monkeypatch):
    engines(world, ARCH, reference_engine, kv_mode, steps, monkeypatch)


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_chunked_speculative_prefix_equal_plain(world, kv_mode):
    own_runs(world, ARCH, kv_mode)


@pytest.fixture(scope="module")
def g6_world():
    jcfg, cfg = cfgs(ARCH, **G6)
    return make_world(jcfg, cfg, seed=1), jcfg, cfg


def test_g6_lockstep_and_paged_match_reference(g6_world, monkeypatch):
    """6 query heads over 1 kv head: flash packs 6·T rows a kv head at
    prefill and 6 at a decode step; paged attention groups 6 heads."""
    world, jcfg, cfg = g6_world
    assert cfg.num_heads // cfg.num_kv_heads == 6
    ref, jparams, model = world
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, T0))
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    experts = ExpertRecorder(monkeypatch, cfg.num_experts)
    jout = jax_forced(jparams, jcfg, toks, forced)
    pout = port_forced(model, toks, forced)
    experts.check(cfg.num_layers * (STEPS + 1))
    check_forced(pout, jout)
    monkeypatch.undo()
    paged_int8(world, jcfg, cfg, monkeypatch)


@pytest.mark.parametrize("extra", [
    [], ["--int4"], ["--continuous", "--paged-kv", "--kv-dtype", "int8"],
    ["--continuous", "--decode-steps", "4"], ["--num-layers", "1"]])
def test_launcher_grok_on_cpu(extra, capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke: routing: " in out
    assert ("paged KV: peak" in out) == ("--paged-kv" in extra)
