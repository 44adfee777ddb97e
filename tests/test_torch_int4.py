"""The port's int4-BFP path on the CPU against the JAX package: the plain
versions of the int4 kernels (the fused linear's int4 branch and the int4
matmul) against the jnp oracles in ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, then the int4 smoke model and its engines
against the reference (``use_kernels=True``), on the all-layer tree (every
layer and the lm head quantized) and on the reference's own mixed
``quantize_params`` tree (stage0 and the lm head).

Tolerances: the BFP mantissas are computed from bit-identical inputs on
both sides where there is no norm prologue, so outputs differ only by the
order of the fp32 group sums: ≤ 1e-4·max|ref| (fp32), two bf16 ulps at the
maximum (bf16 outputs), Σy² ≤ 1e-5 relative.  With the prologue, the two
sides' 1/sqrt may differ by one ulp, which can move one mantissa by one
step; such a step shifts an output by 2^(e-7)·|code|·scale, and the
tolerance adds that shift per differing mantissa (the count is asserted
small).  Model: gate logs identical, fp32 logits ≤ 1e-4·max, tokens and
every shared engine statistic identical."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.fused_linear import fused_linear_pallas
from repro.kernels.int4_matmul import _bfp_quantize_rows, int4_matmul_pallas
from repro.models import model as jmodel
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import routing
from repro_torch.kernels import ops, ref
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from test_torch_quant import quantize_all_layers

torch.set_num_threads(2)

TOL = 1e-4
TOL_SQ = 1e-5
TOL_BF16 = 2.0 ** -7
GROUP, MIN_SIZE = 64, 1 << 12


def _close(out, want, tol=TOL, slack=0.0):
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= tol * np.abs(want).max() + slack


def _codes(rng, K, N, G, pow2=True):
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    c, s = jquant.quantize_rtn(jnp.asarray(w), G, pow2)
    return np.asarray(c), np.asarray(s)


def _pad(x, Kw):
    return np.pad(x, ((0, 0), (0, Kw - x.shape[1])))


# ---------------------------------------------------------------------------
# BFP conversion
# ---------------------------------------------------------------------------

def _ties(rng, M, K):
    """Values (2j+1)/256 with a 1.0 in every 64-group: x·2^7/2^e ends in
    .5 everywhere (exact in bf16); row 0's second group is all zero."""
    x = (2 * rng.integers(-128, 128, (M, K)) + 1) / 256.0
    x[:, ::64] = 1.0
    x[0, 64:128] = 0.0
    return x.astype(np.float32)


def test_bfp_quantize_rows_ties_and_zero_groups():
    rng = np.random.default_rng(0)
    x = _ties(rng, 5, 256).reshape(5, 4, 64)
    mant, pe = ref.bfp_quantize_rows(torch.from_numpy(x))
    jmant, jpe = _bfp_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(mant.numpy(), np.asarray(jmant))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jpe))
    assert pe[0, 1, 0] == 1.0 and torch.all(mant[0, 1] == 0)   # zero group
    # the ties really are ties, and they round half to even
    frac = x * 128.0 / pe.numpy() % 1.0
    assert (frac == 0.5).mean() > 0.9
    np.testing.assert_array_equal(mant.numpy(),
                                  np.clip(np.rint(x * 128.0 / pe.numpy()),
                                          -128, 127))


# ---------------------------------------------------------------------------
# Kernel 5: int4 matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 4, 17])
@pytest.mark.parametrize("K,G", [(96, 32), (200, 64), (256, 128)])
def test_int4_matmul_matches_oracle_and_pallas(M, K, G):
    rng = np.random.default_rng(M * 1000 + K + G)
    N = 70
    codes, scale = _codes(rng, K, N, G, pow2=G != 32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    out = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                          torch.from_numpy(scale))
    xp = jnp.asarray(_pad(x, codes.shape[0]))
    jc, js = jnp.asarray(codes), jnp.asarray(scale)
    for want in (jref.bfp_matmul_ref(xp, jc, js),
                 int4_matmul_pallas(xp, jc, js, interpret=True)):
        _close(out, want)
    # the BFP product stays near the exact dequantized one
    _close(out, jref.int4_matmul_ref(xp, jc, js), tol=0.05)


# ---------------------------------------------------------------------------
# Kernel 2b: the fused linear pipeline over int4 codes
# ---------------------------------------------------------------------------

# prologue, glu, gate_mul, residual, emit_sq (as the dense kernel's test)
_FEATURES = [
    (True, False, False, False, False),    # wqkv
    (True, True, False, False, False),     # gu
    (False, False, True, True, True),      # wo / down
    (False, False, False, True, True),     # residual + Σy², no gate
    (False, True, False, False, True),     # GLU + Σy², no prologue
    (True, True, True, True, True),        # everything
]


def _mantissa_slack(x, ms, gamma, codes, scale, eps, glu):
    """The output shift the two sides' differing BFP mantissas can make:
    the port's and the reference's normalised activations are converted
    and, per differing mantissa, 2^(e-7)·max|code·scale| of its group is
    allowed (through the GLU times the largest |gate| or |up| factor).
    Returns (allowed shift, number of differing mantissas)."""
    xn = ref.rms_prologue(torch.from_numpy(x), torch.from_numpy(ms),
                          torch.from_numpy(gamma), eps).numpy()
    jxn = np.asarray(jnp.asarray(x) * jax.lax.rsqrt(jnp.asarray(ms)[:, None]
                                                    + eps)
                     * jnp.asarray(gamma))
    Kw = codes.shape[0]
    C = scale.shape[0]
    a = _pad(xn, Kw).reshape(len(x), C, Kw // C)
    b = _pad(jxn, Kw).reshape(len(x), C, Kw // C)
    ma, pa = ref.bfp_quantize_rows(torch.from_numpy(a))
    mb, _ = _bfp_quantize_rows(jnp.asarray(b))
    diff = ma.numpy() != np.asarray(mb)
    n = int(diff.sum())
    if not n:
        return 0.0, 0
    step = pa.numpy()[..., 0] * 2.0 ** -7                   # [M, C]
    per_group = np.abs(codes.reshape(C, Kw // C, -1)).max(1) * scale
    shift = (diff.sum(-1) * step * per_group.max(-1)).sum(-1).max()
    if glu:     # |d(silu(g)·u)| <= (1.1·|u| + |silu(g)|)·shift
        y = jref._bfp_matmul_f32(jnp.asarray(jxn), jnp.asarray(codes),
                                 jnp.asarray(scale))
        shift *= 2.1 * float(np.abs(np.asarray(y)).max())
    return float(shift), n


@pytest.mark.parametrize("M,G", [(1, 32), (4, 64), (17, 128)])
@pytest.mark.parametrize("prologue,glu,gmul,res,emit_sq", _FEATURES)
def test_fused_linear_int4_matches_oracle_and_pallas(M, G, prologue, glu,
                                                     gmul, res, emit_sq):
    rng = np.random.default_rng(M * 100 + G)
    K, F = 200, 70                          # K is no group multiple here
    N = 2 * F if glu else F
    codes, scale = _codes(rng, K, N, G, pow2=M != 4)
    x = rng.standard_normal((M, K)).astype(np.float32)
    kw = {}
    if prologue:
        kw["mean_sq"] = (x ** 2).mean(-1).astype(np.float32)
        kw["gamma"] = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    if res:
        kw["residual"] = rng.standard_normal((M, F)).astype(np.float32)
    if gmul:
        kw["gate_mul"] = (rng.random(M) > 0.5).astype(np.float32)
    act = "silu" if glu else None
    params = {"w_int": torch.from_numpy(codes),
              "scale": torch.from_numpy(scale)}
    out, sq = ops.fused_linear(
        params, torch.from_numpy(x), glu=glu, act=act, emit_sq=emit_sq,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    slack, flips = 0.0, 0
    if prologue:
        slack, flips = _mantissa_slack(x, kw["mean_sq"], kw["gamma"], codes,
                                       scale, 1e-5, glu)
        assert flips <= max(2, x.size // 1000)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jc, js = jnp.asarray(codes), jnp.asarray(scale)
    for jo, jsq in (
            jref.fused_linear_ref(jnp.asarray(x), w_codes=jc, scale=js,
                                  glu=glu, act=act, emit_sq=emit_sq, **jkw),
            fused_linear_pallas(jnp.asarray(x), w_codes=jc, scale=js,
                                glu=glu, act=act, emit_sq=emit_sq,
                                interpret=True, **jkw)):
        _close(out, jo, slack=slack)
        if emit_sq:     # Σ(y+δ)² - Σy² <= F·(2·max|y|·δ + δ²)
            bound = F * (2 * np.abs(np.asarray(jo)).max() * slack + slack ** 2)
            assert np.all(np.abs(sq.numpy() - np.asarray(jsq))
                          <= TOL_SQ * np.abs(np.asarray(jsq)) + bound)
        else:
            assert sq is None and jsq is None


def test_fused_linear_int4_bf16_ties():
    """bf16 activations full of .5 ties through the whole epilogue: the
    plain version (half to even) against the Pallas kernel in bf16."""
    rng = np.random.default_rng(5)
    M, K, F = 6, 256, 48
    codes, scale = _codes(rng, K, 2 * F, 64)
    x = jnp.asarray(_ties(rng, M, K)).astype(jnp.bfloat16)
    res = jnp.asarray(rng.standard_normal((M, F))).astype(jnp.bfloat16)
    gm = jnp.asarray((rng.random(M) > 0.3).astype(np.float32))
    jo, jsq = fused_linear_pallas(x, w_codes=jnp.asarray(codes),
                                  scale=jnp.asarray(scale), glu=True,
                                  act="silu", residual=res, gate_mul=gm,
                                  emit_sq=True, interpret=True)
    t = bridge.tensor_from_numpy
    out, sq = ops.fused_linear(
        {"w_int": torch.from_numpy(codes), "scale": torch.from_numpy(scale)},
        t(np.asarray(x)), glu=True, act="silu", residual=t(np.asarray(res)),
        gate_mul=t(np.asarray(gm)), emit_sq=True)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(jo.astype(jnp.float32)), tol=TOL_BF16)
    np.testing.assert_allclose(sq, jsq, rtol=TOL_SQ)


# ---------------------------------------------------------------------------
# The int4 smoke model and its engines against the reference
# ---------------------------------------------------------------------------

SEED = 0
T0, STEPS, NEW = 8, 3, 6
MIN_MARGIN = 1e-3
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "requests_completed", "decode_dispatches", "attn_keep_frac",
         "kv_saved_fraction", "kv_saved_analytic", "kv_mode", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer")


@pytest.fixture(scope="module")
def trees():
    """{"all", "mixed"}: (reference numpy tree, port params).  Routers are
    redrawn at unit scale with zero bias, so routing really skips."""
    rng = np.random.default_rng(SEED)
    dense = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(dense)
    mixed = jquant.quantize_params(dense, GROUP, True, MIN_SIZE)
    out = {}
    for name, tree in (
            ("all", quantize_all_layers(dense, GROUP, True, MIN_SIZE)),
            ("mixed", jax.tree_util.tree_map(np.asarray, mixed))):
        out[name] = (tree, bridge.from_reference(tree, CFG))
    return out


def _n_quantized(params):
    return sum("w_int" in sub["inner"][lin] for blk in params["blocks"]
               for sub in blk.values() for lin in sub["inner"])


@pytest.mark.parametrize("tree", ["all", "mixed"])
def test_int4_model_matches_reference(trees, tree, monkeypatch):
    ref_tree, params = trees[tree]
    L = CFG.num_layers
    assert _n_quantized(params) == (4 * L if tree == "all" else 4)
    assert "w_int" in params["lm_head"]
    jparams = jax.tree_util.tree_map(jnp.asarray, ref_tree)
    rng = np.random.default_rng(SEED + 1)
    toks = rng.integers(0, CFG.vocab_size, (2, T0))
    forced = rng.integers(0, CFG.vocab_size, (2, STEPS))
    prompts = rng.integers(0, CFG.vocab_size, (2, T0)).astype(np.int32)

    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append(float((logits[..., 1] - logits[..., 0]).abs().min()))
        return orig(logits)

    monkeypatch.setattr(routing, "gate_from_logits", recording)

    # prefill + teacher-forced decode steps: gates, then logits, then picks
    prefill = jax.jit(partial(jmodel.prefill, cfg=JCFG, pad_to=T0 + STEPS))
    decode = jax.jit(partial(jmodel.decode_step, cfg=JCFG))
    jl, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    jlogits, jgates = [np.asarray(jl)], [np.asarray(st["attn_gate"])]
    pl, pcache, pst = pmodel.prefill(params, torch.from_numpy(toks), CFG,
                                     pad_to=T0 + STEPS)
    plogits, pgates = [pl.numpy()], [pst["attn_gate"].numpy()]
    for s in range(STEPS):
        jl, cache, st = decode(
            jparams, cache, {"tokens": jnp.asarray(forced[:, s:s + 1])},
            jnp.int32(T0 + s))
        jlogits.append(np.asarray(jl))
        jgates.append(np.asarray(st["attn_gate"]))
        pl, pcache, pst = pmodel.decode_step(
            params, pcache, torch.from_numpy(forced[:, s:s + 1]), T0 + s, CFG)
        plogits.append(pl.numpy())
        pgates.append(pst["attn_gate"].numpy())
    for a, b in zip(pgates, jgates):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plogits, jlogits):
        _close(a, b)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    assert margins and min(margins) >= MIN_MARGIN, min(margins)
    gates = np.concatenate([g.ravel() for g in pgates])
    assert 0.0 < gates.mean() < 1.0

    # lock-step engine, greedy
    jout = JServeEngine(JCFG, jparams, max_len=T0 + NEW).generate(prompts,
                                                                 NEW)
    pout = ServeEngine(LanguageModel(CFG, params, device="cpu"),
                       max_len=T0 + NEW).generate(prompts, NEW)
    np.testing.assert_array_equal(pout["tokens"], jout["tokens"])
    js, ps = jout["stats"], pout["stats"]
    for name in ("kv_saved_fraction", "kv_saved_analytic", "prefill_tokens",
                 "decode_tokens"):
        assert getattr(ps, name) == getattr(js, name), name
    assert abs(ps.attn_keep_frac - js.attn_keep_frac) <= 1e-6


def _serve(eng, prompts, new):
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    return [out["results"][u].tokens for u in uids], out


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
@pytest.mark.parametrize("tree", ["all", "mixed"])
def test_int4_engine_matches_reference(trees, tree, kv_mode):
    """Continuous batching over 2 slots: dense admits three prompts of
    mixed lengths; paged serves two prompts in a pool too small for both
    residents, so it preempts."""
    ref_tree, params = trees[tree]
    rng = np.random.default_rng(SEED + 2)
    if kv_mode == "dense":
        kw, new = {}, 5
        prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
                   for n in (9, 16, 5)]
    else:
        kw, new = dict(page_size=8, num_pages=6), 16
        prompts = [rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
                   for _ in range(2)]
    geom = dict(max_slots=2, max_len=48, kv_mode=kv_mode, **kw)
    jtoks, jout = _serve(JEngine(JCFG, jax.tree_util.tree_map(
        jnp.asarray, ref_tree), **geom), prompts, new)
    model = LanguageModel(CFG, params, device="cpu")
    eng = ContinuousBatchingEngine(model, **geom)
    toks, out = _serve(eng, prompts, new)
    for a, b in zip(toks, jtoks):
        np.testing.assert_array_equal(a, b)
    for name in STATS:
        assert getattr(out["stats"], name) == getattr(jout["stats"], name), \
            name
    s = out["stats"]
    assert s.requests_completed == len(prompts)
    assert 0.0 < s.attn_keep_frac < 1.0
    if kv_mode == "paged":
        assert s.preemptions >= 1
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages


def test_launcher_int4_on_cpu(capsys, monkeypatch):
    """``--int4`` quantizes the launcher's model (at the smoke widths the
    default 1 << 16 floor admits the MLP's [gate|up] and the lm head) and
    serves it through the plain versions: the lm head runs the int4
    matmul's plain version once per forward."""
    from repro_torch.launch import serve as launch_serve
    calls = []
    plain = ref.bfp_matmul_ref
    monkeypatch.setattr(ref, "bfp_matmul_ref",
                        lambda *a: calls.append(1) or plain(*a))
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--int4", "--batch", "2", "--prompt-len", "12",
                       "--new-tokens", "3", "--continuous", "--paged-kv"])
    out = capsys.readouterr().out
    assert "requests: 4" in out and "(length)" in out
    assert len(calls) >= 4 + 2                  # 4 prefills, >= 2 steps


def test_profile_decode_on_cpu(capsys):
    """The decode-step profiler runs the bf16 and the int4 model; on the
    CPU there is no device trace, so busy and idle are null."""
    import json

    from repro_torch.launch import profile_decode
    profile_decode.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--steps", "2"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["weights"] for r in recs] == ["bfloat16", "int4"]
    for r in recs:
        assert r["wall_ms_per_step"] > 0 and r["idle_share"] is None


def test_profile_prefill_chunks_on_cpu(capsys):
    """The chunked-prefill profiler runs one request's prompt in chunks
    (10 tokens at chunk 4: 3 chunks over a staging cache of 44 rows, the
    last chunk right-padded); on the CPU there is no device trace, so busy
    and idle are null.  It refuses a chunk without ``--prefill`` or with
    more than one request."""
    import json

    from repro_torch.launch import profile_decode
    base = ["--arch", "llama2-7b", "--smoke", "--device", "cpu"]
    profile_decode.main(base + ["--prefill", "--prefill-chunk", "4",
                                "--batch", "1", "--prompt-len", "10"])
    (rec,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert (rec["chunks"], rec["staging_rows"]) == (3, 44)
    assert rec["wall_ms"] >= rec["enqueue_ms"] > 0
    assert rec["device_busy_ms"] is None and rec["idle_share"] is None
    for argv in (["--prefill-chunk", "4", "--batch", "1"],
                 ["--prefill", "--prefill-chunk", "4"]):
        with pytest.raises(SystemExit):
            profile_decode.main(base + argv)
