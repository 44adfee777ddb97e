"""Gather-mode routing in the port on the CPU against the JAX package.

Gather mode runs each routed submodule of a prefill on the C =
``capacity(T, keep_prob)`` tokens of highest router score only and writes
them back in place of their rows.  Held here: ``capacity`` over a grid,
``select_topc`` with ties (broken as ``jax.lax.top_k`` breaks them), the
gathers and scatters, ``merge_view_gathered``, the gather branches of
``routed_attention`` and ``routed_mlp`` against the reference's fused path
(``use_kernels=True``, Pallas in interpret mode), then ``prefill`` and
the lock-step ``ServeEngine.generate`` against the same, the continuous
dense engine at ``decode_steps`` 1 and 4 against the reference's engine
on its jnp path (one compile per geometry, shared by both router
biases), the port twin of ``tests/test_models.py``'s
gather ≡ masked at capacity, a Mamba stack in gather mode ≡ masked mode,
the refusals (paged, chunked, bucketed, speculative) and the launcher's
``--gather``.

Every prompt length compacts (``capacity(T) < T``, asserted: 32 → 24,
48 → 40, and the engines' 9, 21, 32 and 40).  Each model-level case runs
under the warm-start router bias [0, 1] (its gate-1 rows outside the top
C are dropped) and under ``neutral_router_bias`` (gate-0 rows are
selected); both regimes are asserted to occur.  Routers are drawn at unit
scale (the init's 0.02 gives score margins near 1e-5), and no gate
decision nor C-th/(C+1)-th score pair lies within MIN_MARGIN of a tie.

Tolerances (fp32): activations and logits ≤ 1e-4·max|ref|; selected
indices, gate logs, tokens and ``ServeStats`` counts equal."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import kv_reuse as jkv
from repro.core import routing as jrouting
from repro.core import skip_block as jskip
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import kv_reuse, routing, skip_block
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.serve.errors import ConfigError
from test_torch_obs import JIT_ATTRS, _CopyingNumpy

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
MIN_MARGIN = 1e-4
B = 2
NEW = 6
ENGINE_LENS = (9, 21, 32, 40)
BIASES = ("warm", "neutral")


def _gather(cfg, **kw):
    return dataclasses.replace(
        cfg, dtype="float32",
        skip=dataclasses.replace(cfg.skip, mode="gather"), **kw)


JCFG = _gather(jget_config("llama2-7b").smoke(), use_kernels=True)
# the continuous engines' reference: its jnp path (the unfused gather
# branch: the same rows selected and written, norms recomputed per block)
JCFG_JNP = dataclasses.replace(JCFG, use_kernels=False)
CFG = _gather(get_config("llama2-7b").smoke())


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def reference_tree(jcfg, bias: str):
    """The reference's init as numpy, every router redrawn at unit scale
    with the warm-start bias [0, 1] or the neutral bias 0."""
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED), jcfg))
    b = np.array([0.0, 1.0] if bias == "warm" else [0.0, 0.0], np.float32)

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.broadcast_to(b, v["b"].shape).copy()
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    return ref


# where the reference's selections go: a step compiled under one test's
# Recorder calls back into the current test's list
_SINK = [None]


def _record_reference(idx):
    _SINK[0].append(np.asarray(idx))


class Recorder:
    """Records each package's selected indices and the smallest nonzero
    gap between the C-th and (C+1)-th score of every selection (a gap of
    exactly 0 is a repeated token's row at layer 0: equal rows score
    equal in both packages, and the lower index wins in both)."""

    def __init__(self, monkeypatch):
        self.port, self.ref, self.gaps = [], [], []
        p_orig, j_orig = routing.select_topc, jrouting.select_topc

        def port(score, cap):
            s = torch.sort(score, dim=-1, descending=True).values
            if cap < score.shape[-1]:
                gap = s[:, cap - 1] - s[:, cap]
                self.gaps += [float(g) for g in gap if g != 0]
            idx = p_orig(score, cap)
            self.port.append(idx.numpy())
            return idx

        def ref(score, cap):
            idx = j_orig(score, cap)
            jax.debug.callback(_record_reference, idx, ordered=True)
            return idx

        _SINK[0] = self.ref

        monkeypatch.setattr(routing, "select_topc", port)
        monkeypatch.setattr(jrouting, "select_topc", ref)

    def check(self):
        assert len(self.port) == len(self.ref) > 0
        for a, b in zip(self.port, self.ref):
            np.testing.assert_array_equal(a, b)
        assert min(self.gaps) >= MIN_MARGIN, min(self.gaps)


# ---------------------------------------------------------------------------
# Routing helpers and the gathered KV view
# ---------------------------------------------------------------------------

def test_capacity_grid():
    for keep in (0.05, 0.25, 0.5, 0.6, 0.75, 0.9, 1.0):
        for T in list(range(1, 70)) + [128, 343, 384, 453, 512, 2048]:
            for mult in (1, 8, 16):
                assert routing.capacity(T, keep, mult) == \
                    jrouting.capacity(T, keep, mult), (T, keep, mult)
    assert routing.capacity(512, 0.75) == 384
    assert routing.capacity(453, 0.75) == 344
    # the lengths this file runs compact; 24 at smoke keep does not
    for T in (32, 48) + ENGINE_LENS:
        assert routing.capacity(T, CFG.skip.keep_prob) < T
    assert routing.capacity(24, CFG.skip.keep_prob) == 24


@pytest.mark.parametrize("levels", [3, 1000])
def test_select_topc_matches_top_k_ties(levels):
    """``levels`` 3 makes nearly every score a tie: the lower index must
    win, as ``jax.lax.top_k`` decides."""
    rng = np.random.default_rng(levels)
    for (b, T) in ((2, 32), (3, 453), (1, 8)):
        score = rng.integers(0, levels, (b, T)).astype(np.float32)
        for cap in sorted({1, T // 3, routing.capacity(T, 0.75), T}):
            idx = routing.select_topc(torch.from_numpy(score), cap)
            ref = np.asarray(jrouting.select_topc(jnp.asarray(score), cap))
            assert idx.dtype == torch.int64
            np.testing.assert_array_equal(idx.numpy(), ref)


def test_gather_and_scatter_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, 4)).astype(np.float32)
    idx = np.sort(np.stack([rng.permutation(12)[:5] for _ in range(2)]), -1)
    u = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    xt, it, ut = (torch.from_numpy(a) for a in (x, idx, u))
    np.testing.assert_array_equal(
        routing.gather_tokens(xt, it).numpy(),
        np.asarray(jrouting.gather_tokens(jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        routing.scatter_tokens(ut, it, 12).numpy(),
        np.asarray(jrouting.scatter_tokens(jnp.asarray(u), jnp.asarray(idx),
                                           12)))
    before = xt.clone()
    np.testing.assert_array_equal(
        routing.scatter_set_tokens(xt, it, ut).numpy(),
        np.asarray(jrouting.scatter_set_tokens(
            jnp.asarray(x), jnp.asarray(idx), jnp.asarray(u))))
    assert torch.equal(xt, before)            # a copy; x is untouched
    # [B, T] leaves (the carried Σx²/D) scatter alike
    s = x[..., 0, 0]
    np.testing.assert_array_equal(
        routing.scatter_set_tokens(torch.from_numpy(s), it, ut[..., 0, 0])
        .numpy(), np.asarray(jrouting.scatter_set_tokens(
            jnp.asarray(s), jnp.asarray(idx), jnp.asarray(u[..., 0, 0]))))


def test_merge_view_gathered_matches_reference():
    rng = np.random.default_rng(2)
    T, C = 10, 6
    view = [rng.standard_normal((2, T, 2, 4)).astype(np.float32)
            for _ in range(2)]
    new = [rng.standard_normal((2, C, 2, 4)).astype(np.float32)
           for _ in range(2)]
    idx = np.sort(np.stack([rng.permutation(T)[:C] for _ in range(2)]), -1)
    tv = tuple(torch.from_numpy(a) for a in view)
    out = kv_reuse.merge_view_gathered(tv, torch.from_numpy(new[0]),
                                       torch.from_numpy(new[1]),
                                       torch.from_numpy(idx), T)
    ref = jkv.merge_view_gathered(tuple(map(jnp.asarray, view)),
                                  jnp.asarray(new[0]), jnp.asarray(new[1]),
                                  jnp.asarray(idx), T)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tv[0].numpy(), view[0])
    # base case: the dense KV passes through; a compacted one is refused
    full = [torch.from_numpy(a) for a in view]
    assert kv_reuse.merge_view_gathered(None, *full, torch.from_numpy(idx),
                                        T)[0] is full[0]
    with pytest.raises(AssertionError):
        kv_reuse.merge_view_gathered(None, torch.from_numpy(new[0]),
                                     torch.from_numpy(new[1]),
                                     torch.from_numpy(idx), T)


# ---------------------------------------------------------------------------
# The gather branches of the routed blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    """{bias: (reference tree, port params)}."""
    out = {}
    for bias in BIASES:
        ref = reference_tree(JCFG, bias)
        out[bias] = (ref, bridge.from_reference(ref, CFG))
    return out


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _activations(rng, T):
    """x [B, T, D] at the residual stream's early scale (0.02 a unit, as
    the embedding's): unit-scale routers then give scores of spread ≈ 0.3,
    so the warm-start bias keeps nearly every row and the neutral one
    about half."""
    return (0.02 * rng.standard_normal((B, T, CFG.d_model))).astype(
        np.float32)


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("case", ["base", "view", "carried", "no_reuse"])
def test_routed_attention_gather(blocks, bias, case, monkeypatch):
    """Layer 1's attention block: ``base`` has no KV view yet (the dense
    base case: the port projects all T rows once), ``view`` merges into
    a view, ``carried`` also takes the Σx²/D carry, ``no_reuse`` turns
    cross-layer reuse off (dense KV at every layer)."""
    ref, port = blocks[bias]
    jp = ref["stack"]["stages"]["pos0"]["mixer"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    pp = port["blocks"][1]["mixer"]
    jcfg, cfg = JCFG, CFG
    if case == "no_reuse":
        jcfg = dataclasses.replace(jcfg, skip=dataclasses.replace(
            jcfg.skip, kv_reuse=False))
        cfg = dataclasses.replace(cfg, skip=dataclasses.replace(
            cfg.skip, kv_reuse=False))
    T = 32
    rng = np.random.default_rng(3)
    x = _activations(rng, T)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    Hkv, dh = CFG.num_kv_heads, CFG.resolved_head_dim
    view = None
    if case != "base":
        view = tuple(rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
                     for _ in range(2))
    sq = ((x ** 2).mean(-1) * 1.01).astype(np.float32) \
        if case == "carried" else None
    rec = Recorder(monkeypatch)
    jx, jview, js = jskip.routed_attention(
        _jtree(jp), jnp.asarray(x),
        None if view is None else tuple(map(jnp.asarray, view)),
        jnp.asarray(pos), jcfg, rng=None, train=False,
        carried_sq=None if sq is None else jnp.asarray(sq))
    px, pview, ps = skip_block.routed_attention(
        pp, torch.from_numpy(x),
        None if view is None else tuple(map(torch.from_numpy, view)),
        torch.from_numpy(pos), cfg,
        carried_sq=None if sq is None else torch.from_numpy(sq))
    rec.check()
    gate = ps["attn_gate"].numpy()
    np.testing.assert_array_equal(gate, np.asarray(js["attn_gate"]))
    _close(px, jx)
    _close(pview[0], jview[0])
    _close(pview[1], jview[1])
    _close(ps["res_sq"], js["res_sq"])
    # the copied semantics: unselected rows keep x, their view rows and
    # their carry; a selected gate-0 row gives y·0 + x
    idx = rec.port[0]
    sel = np.zeros((B, T), bool)
    np.put_along_axis(sel, idx, True, axis=1)
    np.testing.assert_array_equal(px.numpy()[~sel], x[~sel])
    np.testing.assert_array_equal(px.numpy()[sel & (gate == 0)],
                                  x[sel & (gate == 0)])
    want_sq = sq if sq is not None else (x ** 2).mean(-1)
    _close(ps["res_sq"].numpy()[~sel], want_sq[~sel], tol=1e-6)
    if case in ("view", "carried"):
        np.testing.assert_array_equal(pview[0].numpy()[~sel], view[0][~sel])
    if bias == "warm":
        assert ((gate == 1) & ~sel).any()     # a kept row not run
    else:
        assert ((gate == 0) & sel).any()      # a skipped row run


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("carried", [False, True])
def test_routed_mlp_gather(blocks, bias, carried, monkeypatch):
    ref, port = blocks[bias]
    jp = ref["stack"]["stage0"]["pos0"]["ffn"]
    pp = port["blocks"][0]["ffn"]
    T = 48
    rng = np.random.default_rng(4)
    x = _activations(rng, T)
    sq = ((x ** 2).mean(-1) * 0.99).astype(np.float32) if carried else None
    rec = Recorder(monkeypatch)
    jx, js = jskip.routed_mlp(
        _jtree(jp), jnp.asarray(x), JCFG,
        inner_fn=jtransformer._ffn_inner(JCFG, False), rng=None, train=False,
        carried_sq=None if sq is None else jnp.asarray(sq))
    px, ps = skip_block.routed_mlp(
        pp, torch.from_numpy(x), CFG,
        carried_sq=None if sq is None else torch.from_numpy(sq))
    rec.check()
    _close(px, jx)
    _close(ps["res_sq"], js["res_sq"])
    assert abs(float(ps["keep_frac"]) - float(js["keep_frac"])) <= 1e-6
    sel = np.zeros((B, T), bool)
    np.put_along_axis(sel, rec.port[0], True, axis=1)
    np.testing.assert_array_equal(px.numpy()[~sel], x[~sel])


# ---------------------------------------------------------------------------
# The whole model and the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """{bias: (jnp tree, port model)} for the llama2-7b smoke."""
    out = {}
    for bias in BIASES:
        ref = reference_tree(JCFG, bias)
        out[bias] = (_jtree(ref),
                     LanguageModel(CFG, bridge.from_reference(ref, CFG),
                                   device="cpu"))
    return out


def _regime(gates, T, bias):
    """The bias regime really occurs: warm drops a kept row (some layer
    keeps more than C), neutral runs a skipped one (fewer than C)."""
    cap = routing.capacity(T, CFG.skip.keep_prob)
    kept = gates.sum(-1)                                  # [L, B]
    assert (kept > cap).any() if bias == "warm" else (kept < cap).any()


# compiled once, shared by both biases (its selections reach the current
# test's Recorder through _SINK)
_JPREFILL = jax.jit(partial(jmodel.prefill, cfg=JCFG))


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("T", [32, 48])
def test_prefill_matches_reference(worlds, bias, T, monkeypatch):
    jparams, model = worlds[bias]
    toks = np.random.default_rng(T).integers(0, CFG.vocab_size, (B, T))
    rec = Recorder(monkeypatch)
    jl, jcache, js = _JPREFILL(jparams, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    pl, pcache, ps = model.prefill(torch.from_numpy(toks))
    rec.check()
    assert len(rec.port) == 2 * CFG.num_layers
    gates = ps["attn_gate"].numpy()
    np.testing.assert_array_equal(gates, np.asarray(js["attn_gate"]))
    _close(pl, jl)
    np.testing.assert_array_equal(pl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    _close(pcache[1]["k"], jcache["stages"]["pos0"]["k"][0])
    _regime(gates, T, bias)
    for name in ("keep_frac_sum", "n_routed", "router_loss"):
        assert abs(float(ps[name]) - float(js[name])) <= 1e-5, name


@pytest.fixture(scope="module")
def lockstep_reference(worlds):
    """One reference lock-step engine: its compiled steps serve both
    biases' weights (``params`` set per test)."""
    return JServeEngine(JCFG, worlds["warm"][0], max_len=32 + NEW)


@pytest.mark.parametrize("bias", BIASES)
def test_lockstep_engine_matches_reference(worlds, lockstep_reference, bias,
                                           monkeypatch):
    jparams, model = worlds[bias]
    prompts = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (B, 32)).astype(np.int32)
    rec = Recorder(monkeypatch)
    lockstep_reference.params = jparams
    jout = lockstep_reference.generate(prompts, NEW)
    jax.effects_barrier()
    pout = ServeEngine(model, max_len=32 + NEW).generate(prompts, NEW)
    rec.check()
    np.testing.assert_array_equal(pout["tokens"], jout["tokens"])
    js, ps = jout["stats"], pout["stats"]
    for name in ("kv_saved_fraction", "kv_saved_analytic", "prefill_tokens",
                 "decode_tokens"):
        assert getattr(ps, name) == getattr(js, name), name
    assert abs(ps.attn_keep_frac - js.attn_keep_frac) <= 1e-6


ENGINE_STATS = ("prefill_tokens", "decode_tokens", "requests_completed",
                "decode_dispatches", "epoch_shrinks", "attn_keep_frac",
                "kv_saved_fraction", "kv_saved_analytic", "kv_mode",
                "preemptions", "prefill_chunks", "interleaved_steps")


@pytest.fixture(scope="module")
def engine_prompts():
    rng = np.random.default_rng(6)
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in ENGINE_LENS]


def _serve(eng, prompts):
    uids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    out = eng.run()
    return [out["results"][u] for u in uids], out["stats"]


@pytest.fixture(scope="module")
def reference_engine():
    """``make(params, **kw)``: a fresh reference engine (fresh host state)
    holding the compiled steps of the first one built at its geometry;
    both biases' weights go through the same steps."""
    built = {}

    def make(params, **kw):
        eng = jengine.ContinuousBatchingEngine(
            JCFG_JNP, params, config=jconfig.EngineConfig.from_kwargs(**kw))
        first = built.setdefault(tuple(sorted(kw.items())), eng)
        for name in JIT_ATTRS:
            if hasattr(first, name):
                setattr(eng, name, getattr(first, name))
        return eng

    return make


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("steps", [1, 4])
def test_continuous_dense_matches_reference(worlds, engine_prompts,
                                            reference_engine, bias, steps,
                                            monkeypatch):
    jparams, model = worlds[bias]
    geom = dict(max_slots=2, max_len=40 + NEW, decode_steps=steps)
    rec = Recorder(monkeypatch)
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())
    jres, js = _serve(reference_engine(jparams, **geom), engine_prompts)
    jax.effects_barrier()
    pres, ps = _serve(ContinuousBatchingEngine(model, **geom), engine_prompts)
    rec.check()
    assert len(rec.port) == 2 * CFG.num_layers * len(ENGINE_LENS)
    for a, b in zip(pres, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.finish_reason, a.kv_stored, a.kv_dense, a.prompt_len) == \
            (b.finish_reason, b.kv_stored, b.kv_dense, b.prompt_len)
    for name in ENGINE_STATS:
        assert getattr(ps, name) == getattr(js, name), name
    assert ps.decode_iterations >= ps.decode_dispatches


# ---------------------------------------------------------------------------
# Reference twins: gather ≡ masked, Mamba, the refusals, the launcher
# ---------------------------------------------------------------------------

def _mode(cfg, mode, keep=None):
    skip = dataclasses.replace(cfg.skip, mode=mode)
    if keep is not None:
        skip = dataclasses.replace(skip, keep_prob=keep)
    return dataclasses.replace(cfg, skip=skip)


def test_gather_equals_masked_at_capacity():
    """The port twin of ``tests/test_models.py``: at keep_prob 1.0 (C = T)
    and the init's warm-start router bias (every gate 1, asserted) gather
    runs every row in order and must give masked mode's logits (qwen3-8b
    smoke, the reference's own case).  With a gate-0 row it would not:
    gather writes a selected row's KV whatever its gate."""
    cfg = dataclasses.replace(get_config("qwen3-8b").smoke(),
                              dtype="float32")
    params = LanguageModel(_mode(cfg, "masked", 1.0), device="cpu",
                           seed=0).params()
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 32)))
    lg_m, _, sm = pmodel.prefill(params, toks, _mode(cfg, "masked", 1.0))
    lg_g, _, sg = pmodel.prefill(params, toks, _mode(cfg, "gather", 1.0))
    assert float(sm["attn_gate"].min()) == 1.0
    assert torch.equal(sg["attn_gate"], sm["attn_gate"])
    _close(lg_g, lg_m)
    assert torch.equal(lg_g.argmax(-1), lg_m.argmax(-1))


def test_mamba_gather_is_masked():
    """The reference's ``routed_ssm`` ignores the mode: a Mamba stack in
    gather mode is masked mode, prefill, decode and the dense engine."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                              dtype="float32")
    masked = LanguageModel(cfg, device="cpu", seed=0)
    params = routing.neutral_router_bias(masked.params())
    masked = LanguageModel(cfg, params, device="cpu")
    gather = LanguageModel(_mode(cfg, "gather"), params, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 32)))
    outs = []
    for m in (masked, gather):
        lg, cache, st = m.prefill(toks[:, :-1])
        lg2, _, _ = m.decode_step(cache, toks[:, -1:], 31)
        outs.append((lg, lg2, st["ssm_gate"]))
        assert 0.0 < float(st["ssm_gate"].mean()) < 1.0
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    prompts = [p.numpy().astype(np.int32) for p in toks]
    toks_m = [r.tokens for r in _serve(ContinuousBatchingEngine(
        masked, max_slots=2, max_len=40), prompts)[0]]
    toks_g = [r.tokens for r in _serve(ContinuousBatchingEngine(
        gather, max_slots=2, max_len=40), prompts)[0]]
    for a, b in zip(toks_m, toks_g):
        np.testing.assert_array_equal(a, b)


REFUSALS = {"paged": dict(kv_mode="paged"),
            "chunked": dict(prefill_chunk=8),
            "bucketed": dict(prefill_buckets=(16, 48)),
            "speculative": dict(spec_k=2)}


@pytest.mark.parametrize("lever", sorted(REFUSALS))
def test_refusals_match_reference(worlds, lever):
    """Each lever that needs masked mode raises in both packages, the
    port's error an instance of the reference's type (chunked: the port's
    ``ConfigError``, a ``ValueError``)."""
    jparams, model = worlds["neutral"]
    kw = dict(max_slots=2, max_len=48, **REFUSALS[lever])
    with pytest.raises(ValueError) as jerr:
        jengine.ContinuousBatchingEngine(
            JCFG, jparams, config=jconfig.EngineConfig.from_kwargs(**kw))
    with pytest.raises(ValueError) as perr:
        ContinuousBatchingEngine(model, **kw)
    assert isinstance(perr.value, type(jerr.value))
    if lever == "chunked":
        assert isinstance(perr.value, ConfigError)
    assert "masked" in str(perr.value) or "gather" in str(perr.value)


def test_model_chunk_paths_refuse_gather(worlds):
    _, model = worlds["neutral"]
    cache = pmodel.init_chunk_cache(CFG, 1, 16, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="gather"):
        model.prefill_chunk(cache, toks, 0)
    with pytest.raises(ValueError, match="gather"):
        model.verify_chunk(cache, toks, 0)


@pytest.mark.parametrize("extra", [[], ["--continuous"],
                                   ["--continuous", "--decode-steps", "3"]])
def test_launcher_gather_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--gather", "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert "routing: gather" in out
    assert ("requests: 4" in out) == bool(extra)


def test_launcher_gather_refuses_paged():
    with pytest.raises(ValueError, match="masked-mode"):
        launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device",
                           "cpu", "--gather", "--continuous", "--paged-kv",
                           "--batch", "2", "--prompt-len", "12",
                           "--new-tokens", "2"])
