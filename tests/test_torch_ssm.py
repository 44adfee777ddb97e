"""The Mamba-2 slice on the CPU against the JAX package: the SSD chunk
scan's plain version (``ref.ssd_scan_ref``, what ``ssd_scan.cu`` is held
against on the card) against the jnp ``models/ssm.py::ssd_scan`` (y and
the final state) and the Pallas ``ssd_scan_pallas`` in interpret mode (y);
``ssm_apply`` / ``ssm_step`` / ``routed_ssm*``; the bridge's Mamba leaves;
and mamba2-2.7b smoke through prefill + decode steps, the lock-step engine
and the continuous dense engine, with the same bridged weights.

Checks come in the order gates, logits (≤ 1e-4·max|logits|, fp32), tokens
(equal).  Routers are redrawn at unit scale with zero bias, so routing
really skips and no gate decision lies within ``MIN_MARGIN`` of the strict
``>`` tie (checked, so a near tie cannot make a test flaky)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import skip_block as jskip
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import routing, skip_block
from repro_torch.kernels import ref, ssd_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models import ssm
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.serve.errors import ConfigError

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
MIN_MARGIN = 1e-3
JCFG = dataclasses.replace(jget_config("mamba2-2.7b").smoke(),
                           dtype="float32", use_kernels=True)
CFG = dataclasses.replace(get_config("mamba2-2.7b").smoke(), dtype="float32")
LENS = (9, 16, 5, 21)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# The SSD scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,P,N,G,Q", [
    (1, 16, 2, 4, 8, 2, 8),       # the shapes of tests/test_ssd_kernel.py,
    (2, 24, 3, 8, 4, 3, 8),       # one group per head (its B/C per head)
    (1, 32, 1, 16, 16, 1, 16),
    (1, 10, 2, 4, 4, 2, 16),      # T < chunk and not divisible
    (2, 21, 4, 8, 4, 2, 8),       # G > 1 with two heads per group, ragged T
    (1, 300, 2, 64, 128, 1, 128),  # the main path's chunk (Q 128, N 128,
])                                 # P 64) over a ragged T
def test_ssd_scan_ref_matches_reference(B, T, H, P, N, G, Q):
    rng = np.random.default_rng(SEED)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, T, H)).astype(np.float32)
    dt[:, 1::4] = 0.0                            # skipped tokens
    A_log = np.log(rng.uniform(0.5, 4.0, (H,))).astype(np.float32)
    Bm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    per_head = [jnp.asarray(np.repeat(m, H // G, axis=2)) for m in (Bm, Cm)]
    y_j, s_j = jssm.ssd_scan(jnp.asarray(xh), jnp.asarray(dt),
                             jnp.asarray(A_log), *per_head, Q)
    y_k = jops.ssd_scan(jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(A_log),
                        *per_head, Q)
    y, s = ref.ssd_scan_ref(_t(xh), _t(dt), _t(A_log), _t(Bm), _t(Cm), Q)
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_skipped_tokens_leave_state():
    """dt = 0 tokens decay nothing and add nothing: the final state equals
    the state of the sequence with those tokens dropped."""
    rng = np.random.default_rng(1)
    B, T, H, P, N = 1, 13, 2, 4, 8
    xh, Bm, Cm = (_t(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, T, H, P), (B, T, 1, N), (B, T, 1, N)))
    dt = _t(rng.uniform(0.05, 0.2, (B, T, H)).astype(np.float32))
    A_log = torch.zeros(H)
    keep = torch.ones(T, dtype=torch.bool)
    keep[[2, 5, 6, 12]] = False
    _, s_masked = ref.ssd_scan_ref(xh, dt * keep[None, :, None], A_log, Bm,
                                   Cm, 4)
    _, s_dropped = ref.ssd_scan_ref(xh[:, keep], dt[:, keep], A_log,
                                    Bm[:, keep], Cm[:, keep], 4)
    torch.testing.assert_close(s_masked, s_dropped, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The Mamba block and its routed wrapper
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """Reference params (routers at unit scale, zero bias), the port's
    bridged copy, and the reference pytree on the device."""
    rng = np.random.default_rng(SEED)
    ref_p = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(ref_p)
    return ref_p, bridge.from_reference(ref_p, CFG), \
        jax.tree_util.tree_map(jnp.asarray, ref_p)


def _layer0(ref_p):
    return ref_p["stack"]["stage0"]["pos0"]["mixer"]


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_apply_and_step_match_reference(world, masked):
    ref_p, params, _ = world
    jp = jax.tree_util.tree_map(jnp.asarray, _layer0(ref_p)["inner"])
    pp = params["blocks"][0]["mixer"]["inner"]
    rng = np.random.default_rng(2)
    B, T = 2, 19
    x = rng.standard_normal((B, T + 1, CFG.d_model)).astype(np.float32)
    mask = ((rng.random((B, T + 1)) > 0.4).astype(np.float32) if masked
            else None)
    jm = None if mask is None else jnp.asarray(mask[:, :T])
    pm = None if mask is None else _t(mask[:, :T])
    y_j, ((cx_j, cb_j), s_j) = jax.jit(partial(jssm.ssm_apply, cfg=JCFG))(
        jp, jnp.asarray(x[:, :T]), gate_mask=jm)
    y, ((cx, cb), s) = ssm.ssm_apply(pp, _t(x[:, :T]), CFG, gate_mask=pm)
    assert np.abs(y.numpy() - np.asarray(y_j)).max() <= \
        TOL * np.abs(np.asarray(y_j)).max()
    # the histories are the raw projections: equal up to matmul rounding
    np.testing.assert_allclose(cx.numpy(), np.asarray(cx_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cb.numpy(), np.asarray(cb_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-5)
    # the decode step continues the prefill: the reference's step from the
    # reference's states, the port's from the port's
    gm = None if mask is None else mask[:, T]
    ys_j, ((ncx_j, _), ns_j) = jax.jit(partial(jssm.ssm_step, cfg=JCFG))(
        jp, jnp.asarray(x[:, T:]), conv_state=(cx_j, cb_j), ssm_state=s_j,
        gate_mask=None if gm is None else jnp.asarray(gm))
    ys, ((ncx, _), ns) = ssm.ssm_step(
        pp, _t(x[:, T:]), CFG, (cx, cb), s,
        gate_mask=None if gm is None else _t(gm))
    assert np.abs(ys.numpy() - np.asarray(ys_j)).max() <= \
        TOL * np.abs(np.asarray(ys_j)).max()
    np.testing.assert_allclose(ncx.numpy(), np.asarray(ncx_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ns.numpy(), np.asarray(ns_j), rtol=2e-4,
                               atol=2e-5)
    # ... and equals the full-sequence forward's last position
    y_full, _ = ssm.ssm_apply(pp, _t(x), CFG,
                              gate_mask=None if mask is None else _t(mask))
    torch.testing.assert_close(ys[:, 0], y_full[:, -1], rtol=1e-4,
                               atol=1e-5)


def test_routed_ssm_matches_reference(world):
    """Prefill and decode through the routed wrapper: the gate (from the
    router-stats kernel's plain version) equals the reference's; outputs,
    states and keep statistics match."""
    ref_p, params, _ = world
    jp = jax.tree_util.tree_map(jnp.asarray, _layer0(ref_p))
    pp = params["blocks"][0]["mixer"]
    rng = np.random.default_rng(3)
    B, T = 2, 17
    x = rng.standard_normal((B, T + 1, CFG.d_model)).astype(np.float32)
    xj = jnp.asarray(x[:, :T])

    logits, _ = jskip._router_and_stats(jp, xj, JCFG, True, None)
    g_j, _ = jskip._gate(logits, None, JCFG, False, (B, T), True)
    y_j, (conv_j, s_j), st_j = jax.jit(partial(
        jskip.routed_ssm, cfg=JCFG, rng=None, train=False))(jp, xj)
    y, (conv, s), st = skip_block.routed_ssm(pp, _t(x[:, :T]), CFG)
    np.testing.assert_array_equal(st["ssm_gate"].numpy(), np.asarray(g_j))
    assert 0.0 < float(st["ssm_gate"].mean()) < 1.0
    assert np.abs(y.numpy() - np.asarray(y_j)).max() <= \
        TOL * np.abs(np.asarray(y_j)).max()
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-5)
    assert abs(float(st["keep_frac"]) - float(st_j["keep_frac"])) <= 1e-6

    xj1 = jnp.asarray(x[:, T:])
    logits, _ = jskip._router_and_stats(jp, xj1, JCFG, True, None)
    g1_j, _ = jskip._gate(logits[:, 0], None, JCFG, False, (B,), True)
    y1_j, _, st1_j = jax.jit(partial(jskip.routed_ssm_decode, cfg=JCFG))(
        jp, xj1, conv_state=conv_j, ssm_state=s_j)
    y1, _, st1 = skip_block.routed_ssm_decode(pp, _t(x[:, T:]), CFG,
                                              conv_state=conv, ssm_state=s)
    np.testing.assert_array_equal(st1["ssm_gate"].numpy(), np.asarray(g1_j))
    assert np.abs(y1.numpy() - np.asarray(y1_j)).max() <= \
        TOL * np.abs(np.asarray(y1_j)).max()
    assert abs(float(st1["keep_frac"]) - float(st1_j["keep_frac"])) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_mamba_round_trip(dtype):
    """Every Mamba leaf (the mixer's projections, convs, A_log, dt_bias, D,
    gated norm, out_proj, the router and the block norm) and the tied
    embedding carry bit for bit, both ways."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    ref_p = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(4), jcfg))
    params = bridge.from_reference(ref_p, cfg)
    assert "lm_head" not in params
    inner = params["blocks"][1]["mixer"]["inner"]
    assert set(inner) == {"in_proj_z", "in_proj_x", "in_proj_bc",
                          "in_proj_dt", "conv_x_w", "conv_x_b", "conv_bc_w",
                          "conv_bc_b", "A_log", "dt_bias", "D", "norm",
                          "out_proj"}
    assert set(params["blocks"][1]["mixer"]) == {"router", "norm", "inner"}
    back = bridge.to_reference(params, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(ref_p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    # the port's own init draws the same tree structure and shapes
    own = pmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), own)
    ref_shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), bridge.from_reference(ref_p, cfg))
    assert shapes == ref_shapes


# ---------------------------------------------------------------------------
# The model and the engines
# ---------------------------------------------------------------------------

def _recording(monkeypatch):
    """Record the smallest router margin of every port gate decision."""
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append(float((logits[..., 1] - logits[..., 0]).abs().min()))
        return orig(logits)

    monkeypatch.setattr(routing, "gate_from_logits", recording)
    return margins


def _jax_gates(monkeypatch):
    """Record the reference's per-layer SSM gates from inside its jitted
    stack (in layer order, one list entry per layer and forward)."""
    gates = []
    orig = jskip._gate

    def recorded(logits, rng, cfg, train, shape, routed):
        g, p = orig(logits, rng, cfg, train, shape, routed)
        jax.debug.callback(lambda a: gates.append(np.asarray(a)), g,
                           ordered=True)
        return g, p

    monkeypatch.setattr(jskip, "_gate", recorded)
    return gates


def test_model_matches_reference(world, monkeypatch):
    """Prefill + teacher-forced decode steps of mamba2-2.7b smoke (2 layers,
    chunk 8, so the 21-token prompt spans three chunks, the last ragged)."""
    _, params, jparams = world
    rng = np.random.default_rng(5)
    B, T0, STEPS = 2, 21, 4
    toks = rng.integers(0, CFG.vocab_size, (B, T0))
    forced = rng.integers(0, CFG.vocab_size, (B, STEPS))
    margins = _recording(monkeypatch)
    jg = _jax_gates(monkeypatch)

    prefill = jax.jit(partial(jmodel.prefill, cfg=JCFG))
    decode = jax.jit(partial(jmodel.decode_step, cfg=JCFG))
    lg, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    jl, jk = [np.asarray(lg)], [float(st["keep_frac_sum"])]
    for s in range(STEPS):
        lg, cache, st = decode(jparams, cache,
                               {"tokens": jnp.asarray(forced[:, s:s + 1])},
                               jnp.int32(T0 + s))
        jl.append(np.asarray(lg))
        jk.append(float(st["keep_frac_sum"]))
    jax.effects_barrier()

    lg, pcache, st = pmodel.prefill(params, _t(toks), CFG)
    assert set(pcache[0]) == {"conv_x", "conv_bc", "ssm"}
    pl, pg, pk = [lg.numpy()], [st["ssm_gate"]], [float(st["keep_frac_sum"])]
    for s in range(STEPS):
        lg, pcache, st = pmodel.decode_step(params, pcache,
                                            _t(forced[:, s:s + 1]), T0 + s,
                                            CFG)
        pl.append(lg.numpy())
        pg.append(st["ssm_gate"])
        pk.append(float(st["keep_frac_sum"]))

    port_gates = [g.numpy() for step in pg for g in step]   # per layer
    assert len(jg) == len(port_gates) == CFG.num_layers * (1 + STEPS)
    for a, b in zip(port_gates, jg):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(pk, jk, rtol=0, atol=1e-6)
    assert min(margins) >= MIN_MARGIN, min(margins)
    flat = np.concatenate([g.ravel() for g in port_gates])
    assert 0.0 < flat.mean() < 1.0


@pytest.mark.parametrize("routed", [True, False])
def test_engines_match_reference(world, monkeypatch, routed):
    """Lock-step ``ServeEngine.generate`` and the continuous engine over the
    dense pool (2 slots for 4 requests of mixed lengths, exact-length
    prefill, slots reused) against the reference engines, with routing on
    and off (off, every decode token reads the carried state)."""
    _, params, jparams = world
    rng = np.random.default_rng(23)    # its margins clear MIN_MARGIN
    jcfg = dataclasses.replace(JCFG, skip=dataclasses.replace(
        JCFG.skip, enabled=routed))
    cfg = dataclasses.replace(CFG, skip=dataclasses.replace(
        CFG.skip, enabled=routed))
    model = LanguageModel(cfg, params, device="cpu")
    margins = _recording(monkeypatch)

    prompts = rng.integers(0, CFG.vocab_size, (2, 13)).astype(np.int32)
    jout = JServeEngine(jcfg, jparams, max_len=21).generate(prompts, 8)
    pout = ServeEngine(model, max_len=21).generate(prompts, 8)
    np.testing.assert_array_equal(pout["tokens"], jout["tokens"])
    js, ps = jout["stats"], pout["stats"]
    assert abs(ps.attn_keep_frac - js.attn_keep_frac) <= 1e-6
    for name in ("prefill_tokens", "decode_tokens", "kv_saved_fraction",
                 "kv_saved_analytic"):
        assert getattr(ps, name) == getattr(js, name), name

    reqs = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in LENS]

    def run(eng):
        uids = [eng.submit(p, max_new_tokens=6) for p in reqs]
        out = eng.run()
        return [out["results"][u].tokens for u in uids], out

    jt, jo = run(JEngine(jcfg, jparams, max_slots=2, max_len=48))
    pt, po = run(ContinuousBatchingEngine(model, max_slots=2, max_len=48))
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a, b)
    for name in ("prefill_tokens", "decode_tokens", "prefill_chunks",
                 "interleaved_steps", "requests_completed",
                 "decode_dispatches", "kv_saved_fraction",
                 "kv_saved_analytic"):
        assert getattr(po["stats"], name) == getattr(jo["stats"], name), name
    assert abs(po["stats"].attn_keep_frac
               - jo["stats"].attn_keep_frac) <= 1e-6
    for uid, r in po["results"].items():
        jr = jo["results"][uid]
        assert (r.finish_reason, r.prompt_len) == (jr.finish_reason,
                                                   jr.prompt_len)
    assert not routed or min(margins) >= MIN_MARGIN, min(margins)


def test_slot_reuse_overwrites_ssm_state(world):
    """A short request admitted into the slot a long one just left gives
    the tokens it gives in a fresh engine: admission overwrites the slot's
    conv histories and state whole (nothing masks an SSM state).  Routing
    is off, so every decode token reads the state (greedy decode of the
    random routed model settles on tokens that skip every layer)."""
    _, params, _ = world
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(CFG, skip=dataclasses.replace(CFG.skip,
                                                            enabled=False))
    model = LanguageModel(cfg, params, device="cpu")
    long_p = rng.integers(0, CFG.vocab_size, (30,)).astype(np.int32)
    short = rng.integers(0, CFG.vocab_size, (4,)).astype(np.int32)

    eng = ContinuousBatchingEngine(model, max_slots=1, max_len=48)
    u_long = eng.submit(long_p, max_new_tokens=8)
    u_short = eng.submit(short, max_new_tokens=8)
    out = eng.run()
    fresh = ContinuousBatchingEngine(model, max_slots=1, max_len=48)
    u = fresh.submit(short, max_new_tokens=8)
    alone = fresh.run()["results"][u].tokens
    np.testing.assert_array_equal(out["results"][u_short].tokens, alone)
    assert out["results"][u_long].decode_tokens == 8


def test_exact_length_prefill_and_refusals(world):
    """The reference's refusals, word for word: prefill buckets (pads would
    update the SSM state) and paged KV (no attention to page); the port's
    scheduler prefills at the exact prompt length; paged decode and int4
    Mamba weights raise."""
    _, params, jparams = world
    model = LanguageModel(CFG, params, device="cpu")
    for kw in (dict(prefill_buckets=(16, 32, 48)), dict(kv_mode="paged")):
        with pytest.raises(ValueError) as jerr:
            JEngine(JCFG, jparams, max_slots=2, max_len=48, **kw)
        with pytest.raises(ValueError) as perr:
            ContinuousBatchingEngine(model, max_slots=2, max_len=48, **kw)
        assert str(perr.value) == str(jerr.value)
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48)
    assert eng.scheduler.buckets is None
    padded, last = eng.scheduler.pad_prompt(np.arange(11))
    assert padded.shape == (11,) and last == 10
    with pytest.raises(ValueError, match="not a pageable stack"):
        model.paged_decode_step({}, torch.zeros((1, 1), dtype=torch.long),
                                0, torch.zeros((1, 1)), torch.ones(1))
    with pytest.raises(ConfigError, match="item 13b"):
        launch_serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device",
                           "cpu", "--int4"])


def test_no_fallback_and_no_cuda(monkeypatch):
    """A tensor off the CPU reaches the SSD kernel or raises (here: a meta
    tensor, refused before any launch); the entry points default to cuda
    and raise where it is missing."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(torch.empty(1, 8, 2, 4, **meta),
                          torch.empty(1, 8, 2, **meta),
                          torch.empty(2, **meta),
                          torch.empty(1, 8, 1, 8, **meta),
                          torch.empty(1, 8, 1, 8, **meta), 8)
    assert ssd_scan.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LanguageModel(CFG)


@pytest.mark.parametrize("continuous", [False, True])
def test_launch_serve_mamba_smoke(continuous, capsys):
    argv = ["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "12", "--new-tokens", "4"]
    launch_serve.main(argv + (["--continuous"] if continuous else []))
    out = capsys.readouterr().out
    assert "prefill:" in out and ("requests: 4" in out) == continuous
