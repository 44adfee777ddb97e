"""gemma3-12b in the port (LOCAL sliding-window ring caches, GeGLU, head
dim 256 at full width, qk-norm, tied embeddings) on the CPU against the
JAX package.

The smoke config has 6 layers (5 LOCAL, window 16, then one global), dh
64 and 4 heads over 4 kv heads (G = 1); ``num_kv_heads=2`` gives G = 2.
Held here: the config copy; the bridge's six-position stage both ways;
``ring_positions`` and ``_ring_from_linear`` for T < W, T = W and T > W;
the ring decode attention (the flash kernel's plain version over the ring
in slot order with kv_valid_len = min(t + 1, W), no key positions)
against the reference's ``chunked_attention`` with the ring's explicit
key positions; prefill and teacher-forced decode steps (a prompt shorter
than W on a linear cache under the window, one longer than W on the ring,
decode across the wrap); the continuous engine (the dense pool,
single-step and in fused epochs; prompts of 12 and 20 tokens, max_len 40,
as ``tests/test_serve_continuous.py`` runs gemma3) against the
reference's engine (its jnp path, ``use_kernels=False``); every refusal
(paged, chunked, bucketed, speculative, prefix cache: the reference's
error type and message); ``--arch gemma3-12b`` through the launcher.

The per-head norm gammas are drawn away from 1, the routers at unit scale
with zero bias so routing skips.  Tolerances (fp32): logits and attention
outputs ≤ 1e-4·max|ref|; gate logs, tokens and ``ServeStats`` counts
equal."""
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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine, init_pool
from repro_torch.serve.errors import ConfigError
from test_torch_obs import JIT_ATTRS, _CopyingNumpy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
W = 16
STEPS, NEW = 6, 5
LENS = (12, 20)


def _cfgs(kv=4, layers=None):
    def one(cfg):
        kw = {} if layers is None else {"num_layers": layers}
        return dataclasses.replace(cfg, dtype="float32", num_kv_heads=kv,
                                   use_kernels=False, **kw)
    return (one(jget_config("gemma3-12b").smoke()),
            one(get_config("gemma3-12b").smoke()))


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _world(kv):
    """(jnp tree, port model) at G = 4 / kv: routers at unit scale with zero
    bias, qk-norm gammas in [0.5, 1.5)."""
    jcfg, cfg = _cfgs(kv)
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED),
                                               jcfg))

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
    model = LanguageModel(cfg, bridge.from_reference(ref, cfg), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, ref), model


@pytest.fixture(scope="module")
def worlds():
    built = {}

    def get(kv):
        if kv not in built:
            built[kv] = _world(kv)
        return built[kv]
    return get


def test_config_copy_matches_reference():
    for full in (False, True):
        a, b = jget_config("gemma3-12b"), get_config("gemma3-12b")
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    full = get_config("gemma3-12b")
    assert (full.num_layers, full.d_model, full.resolved_head_dim,
            full.window_size, full.stage_len) == (48, 3840, 256, 1024, 6)
    smoke = full.smoke()
    assert (smoke.num_layers, smoke.window_size, smoke.resolved_head_dim,
            smoke.num_heads, smoke.num_kv_heads) == (6, 16, 64, 4, 4)
    transformer.check_supported(full)


def test_bridge_carries_six_position_stages(worlds):
    """Two stages of six layers (``stage0`` and one ``stages`` slice, each
    pos0..pos5, the second stage's leaves the first's + 1, stacked as the
    reference's scan keeps them): every leaf bit for bit both ways, each
    layer from its stage and position."""
    _, cfg = _cfgs(2, layers=12)
    one = jax.tree_util.tree_map(np.asarray, worlds(2)[0])
    ref = {"embed": one["embed"], "final_norm": one["final_norm"],
           "stack": {"stage0": one["stack"]["stage0"],
                     "stages": jax.tree_util.tree_map(
                         lambda a: (a + 1)[None], one["stack"]["stage0"])}}
    port = bridge.from_reference(ref, cfg)
    assert len(port["blocks"]) == 12 and "lm_head" not in port
    for i, b in enumerate(port["blocks"]):
        s, k = divmod(i, 6)
        src = (ref["stack"]["stage0"][f"pos{k}"] if s == 0 else
               jax.tree_util.tree_map(lambda a: a[s - 1],
                                      ref["stack"]["stages"][f"pos{k}"]))
        np.testing.assert_array_equal(
            b["ffn"]["inner"]["gu"]["w"].numpy(),
            src["ffn"]["inner"]["gu"]["w"])
    back = bridge.to_reference(port, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(ref)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path])


@pytest.mark.parametrize("T", [10, W, 23, 3 * W + 5])
def test_ring_helpers_match_reference(T):
    rng = np.random.default_rng(T)
    kv = rng.standard_normal((2, T, 2, 4)).astype(np.float32)
    got = transformer._ring_from_linear(torch.from_numpy(kv), W)
    want = jtransformer._ring_from_linear(jnp.asarray(kv), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for t in (0, T - 1, T, T + W + 3):
        np.testing.assert_array_equal(
            transformer.ring_positions(torch.tensor(t), W).numpy(),
            np.asarray(jtransformer.ring_positions(jnp.int32(t), W)))
    t = torch.tensor([0, T - 1, T + 7])
    np.testing.assert_array_equal(
        transformer.ring_positions(t, W).numpy(),
        np.asarray(jax.vmap(jtransformer.ring_positions, in_axes=(0, None))(
            jnp.asarray(t.numpy()), W)))


@pytest.mark.parametrize("G", [1, 2])
def test_ring_decode_attention_matches_chunked_attention(G):
    """The argument of ``skip_block.routed_attention_decode``'s ring:
    a ring written at slot t mod W for positions ≤ t (slots past the
    written ones hold garbage), attended in slot order with kv_valid_len =
    min(t + 1, W), equals the reference's ``chunked_attention`` with each
    slot's position from ``ring_positions`` (an empty slot mapped past
    t)."""
    rng = np.random.default_rng(G)
    Hkv, dh = 2, 64
    t = np.array([0, 5, W - 1, W, W + 3, 5 * W + 11], np.int32)
    B = len(t)
    q = rng.standard_normal((B, 1, Hkv * G, dh)).astype(np.float32)
    k = rng.standard_normal((B, W, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, W, Hkv, dh)).astype(np.float32)
    got = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(t[:, None]),
        kv_valid_len=torch.clamp(torch.from_numpy(t) + 1, max=W))
    jt = jnp.asarray(t)
    kv_pos = jax.vmap(jtransformer.ring_positions, in_axes=(0, None))(jt, W)
    eff = jnp.where(kv_pos >= 0, kv_pos, (jt + 1)[:, None])
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jt[:, None], causal=True, window=0, chunk=W,
        softmax_scale=None, kv_positions=eff)
    _close(got, want)
    # the ring's slots are out of time order past the wrap: a mask by slot
    # index against the window would drop live keys
    wrong = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(t[:, None]), window=W,
        kv_valid_len=torch.clamp(torch.from_numpy(t) + 1, max=W))
    assert np.abs(wrong.numpy()[-1] - np.asarray(want)[-1]).max() > 1e-3


def _jax_forced(jparams, jcfg, toks, forced, pad_to):
    prefill = jax.jit(partial(jmodel.prefill, cfg=jcfg, pad_to=pad_to))
    decode = jax.jit(partial(jmodel.decode_step, cfg=jcfg))
    lg, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, gates = [np.asarray(lg)], [np.asarray(st["attn_gate"])]
    for s in range(forced.shape[1]):
        lg, cache, st = decode(
            jparams, cache, {"tokens": jnp.asarray(forced[:, s:s + 1])},
            jnp.int32(toks.shape[1] + s))
        logits.append(np.asarray(lg))
        gates.append(np.asarray(st["attn_gate"]))
    return logits, gates, cache


def _port_forced(model, toks, forced, pad_to):
    lg, cache, st = model.prefill(torch.from_numpy(toks), pad_to=pad_to)
    logits, gates = [lg.numpy()], [st["attn_gate"].numpy()]
    for s in range(forced.shape[1]):
        lg, cache, st = model.decode_step(
            cache, torch.from_numpy(forced[:, s:s + 1]), toks.shape[1] + s)
        logits.append(lg.numpy())
        gates.append(st["attn_gate"].numpy())
    return logits, gates, cache


@pytest.mark.parametrize("kv,T0", [(4, 20), (2, 20), (2, 12)])
def test_prefill_decode_match_reference(worlds, kv, T0):
    """T0 20 > W: the LOCAL layers' caches are rings (W long) and decode
    writes slots 4.. (the wrap); T0 12 < W: linear caches grown to T0 +
    STEPS, decode under the window past t = W."""
    jparams, model = worlds(kv)
    jcfg, _ = _cfgs(kv)
    rng = np.random.default_rng(3 + T0)
    toks = rng.integers(0, model.cfg.vocab_size, (2, T0))
    forced = rng.integers(0, model.cfg.vocab_size, (2, STEPS))
    pad_to = T0 + STEPS
    jl, jg, jc = _jax_forced(jparams, jcfg, toks, forced, pad_to)
    pl, pg, pc = _port_forced(model, toks, forced, pad_to)
    # cache extents: rings W long past W, else linear
    want = W if T0 > W else pad_to
    for i, ce in enumerate(pc):
        local = model.cfg.block_kind(i) == "local"
        assert ce["k"].shape[1] == (want if local else pad_to)
    for k in range(6):
        _close(pc[k]["k"], jc["stage0"][f"pos{k}"]["k"])
        _close(pc[k]["v"], jc["stage0"][f"pos{k}"]["v"])
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)
    assert 0.0 < np.concatenate([g.ravel() for g in pg]).mean() < 1.0
    for a, b in zip(pl, jl):
        _close(a, b)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_pool_extents():
    _, cfg = _cfgs(2)
    for max_len, local in ((40, W), (12, 12)):
        pool = init_pool(cfg, 2, max_len, "cpu")
        for i, pe in enumerate(pool):
            ext = local if cfg.block_kind(i) == "local" else max_len
            assert pe["k"].shape == (2, ext, 2, 64) == pe["v"].shape


@pytest.fixture(scope="module")
def reference_engine():
    built = {}

    def make(jcfg, params, **kw):
        eng = jengine.ContinuousBatchingEngine(
            jcfg, params, config=jconfig.EngineConfig.from_kwargs(**kw))
        key = (jcfg.num_kv_heads,) + tuple(sorted(kw.items()))
        first = built.setdefault(key, eng)
        for name in JIT_ATTRS:
            if hasattr(first, name):
                setattr(eng, name, getattr(first, name))
        return eng

    return make


def _serve(eng, prompts):
    uids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    out = eng.run()
    return [out["results"][u] for u in uids], out["stats"]


STATS = ("prefill_tokens", "decode_tokens", "requests_completed",
         "decode_dispatches", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode")


@pytest.mark.parametrize("kv,steps", [(4, 1), (2, 1), (2, 4)])
def test_engines_match_reference(worlds, reference_engine, kv, steps,
                                 monkeypatch):
    """Prompts of 12 and 20 tokens (straddling W) plus 18, max_len 40 (the
    pool's LOCAL layers are W-long rings): a short prompt's linear prefix
    inserted as the ring, decode across the wrap at t = 16."""
    jparams, model = worlds(kv)
    jcfg, _ = _cfgs(kv)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, (n,)).astype(np.int32)
               for n in LENS + (18,)]
    geom = dict(max_slots=2, max_len=40, decode_steps=steps)
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())
    jres, js = _serve(reference_engine(jcfg, jparams, **geom), prompts)
    jax.effects_barrier()
    pres, ps = _serve(ContinuousBatchingEngine(model, **geom), prompts)
    for a, b in zip(pres, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.finish_reason, a.kv_stored, a.kv_dense) == \
            (b.finish_reason, b.kv_stored, b.kv_dense)
    for name in STATS:
        assert getattr(ps, name) == getattr(js, name), name
    assert 0.0 < ps.attn_keep_frac < 1.0


REFUSALS = (("paged", dict(kv_mode="paged")),
            ("chunked", dict(prefill_chunk=8)),
            ("bucketed", dict(prefill_buckets=(16, 40))),
            ("speculative", dict(spec_k=2)),
            ("prefix_cache", dict(prefix_cache=True)),
            ("paged_prefix_cache", dict(kv_mode="paged", prefix_cache=True)))


@pytest.mark.parametrize("name,kw", REFUSALS, ids=[n for n, _ in REFUSALS])
def test_refusals_match_reference(worlds, name, kw):
    """Each mode the reference refuses for gemma3 raises in the port with
    the reference's message: a ValueError (the port's chunk refusal a
    ConfigError, itself a ValueError), ``ConfigError`` where the
    reference raises its own."""
    jparams, model = worlds(4)
    jcfg, _ = _cfgs(4)
    with pytest.raises(ValueError) as theirs:
        jengine.ContinuousBatchingEngine(jcfg, jparams, max_slots=2,
                                         max_len=40, **kw)
    with pytest.raises(ValueError) as mine:
        ContinuousBatchingEngine(model, max_slots=2, max_len=40, **kw)
    assert str(mine.value) == str(theirs.value)
    if type(theirs.value).__name__ == "ConfigError" or name == "chunked":
        assert isinstance(mine.value, ConfigError)


@pytest.mark.parametrize("extra", [[], ["--continuous"],
                                   ["--continuous", "--decode-steps", "4"]])
def test_launcher_gemma3_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "gemma3-12b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert "gemma3-12b-smoke: routing: " in out


@pytest.mark.parametrize("flag", [["--paged-kv"], ["--prefill-chunk", "8"],
                                  ["--spec-k", "2"]])
def test_launcher_refuses_gemma3_modes(flag):
    with pytest.raises(ValueError):
        launch_serve.main(["--arch", "gemma3-12b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "21",
                           "--new-tokens", "3", "--continuous", *flag])


def test_gate_replay_excuses_only_near_ties(monkeypatch):
    """``chip_smoke.GateReplay``, the card's fp32 witness of CPU ≡ CUDA
    routing: replaying a run on its own model flips nothing and gives the
    same logits; a run whose router bias moves decisions far from their
    tie fails the replay; with every margin counted as a near tie the same
    run passes, counts its flips and takes the recorded decisions, so its
    logits are the recorded run's."""
    from repro_torch.core.routing import neutral_router_bias
    cfg = dataclasses.replace(get_config("gemma3-12b").smoke(),
                              dtype="float32")
    params = neutral_router_bias(LanguageModel(cfg, device="cpu",
                                               seed=SEED).params())
    model = LanguageModel(cfg, params, device="cpu")
    blocks = [dict(b) for b in params["blocks"]]
    mixer = dict(blocks[0]["mixer"])
    mixer["router"] = dict(mixer["router"],
                           b=torch.tensor([0.0, 5.0]))   # keep every row
    blocks[0] = dict(blocks[0], mixer=mixer)
    moved = LanguageModel(cfg, dict(params, blocks=blocks), device="cpu")
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))
    replay = chip_smoke.GateReplay()
    with torch.no_grad():
        with replay.record():
            want, gates = chip_smoke._forced_run(model, toks, forced)
        assert not all(bool(g[0].all()) for g in gates)   # layer 0 skips
        with replay.replay():
            same, _ = chip_smoke._forced_run(model, toks, forced)
        assert replay.flips == [] and replay.calls == len(replay.log)
        assert all(torch.equal(a, b) for a, b in zip(want, same))
        with pytest.raises(RuntimeError, match="differs at a recorded"):
            with replay.replay():
                chip_smoke._forced_run(moved, toks, forced)
        monkeypatch.setattr(chip_smoke, "GATHER_MARGIN", float("inf"))
        with replay.replay():
            taken, _ = chip_smoke._forced_run(moved, toks, forced)
    assert replay.flips and replay.summary()["flips_excused"]
    assert all(torch.equal(a, b) for a, b in zip(want, taken))
