"""The slice end to end on the CPU: the port's prefill + teacher-forced
decode steps and its lock-step ``ServeEngine.generate`` against the JAX
package at ``use_kernels=True`` (Pallas in interpret mode), on the same
bridged weights, with SkipGPT routing on and off.

Order of the checks: the per-layer gate log first, then logits
(≤ 1e-4·max|logits|, fp32), then tokens and the measured KV saving, which
must be equal.  The routers' weights are drawn at unit scale (the init's
0.02 gives logit margins near 1e-5) and their biases zeroed, so the chosen
seed really skips tokens and has no gate decision within 1e-3 of the strict
``>`` tie."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import routing
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(2)

SEED = 0
B, T0, STEPS, NEW = 2, 8, 3, 8
TOL = 1e-4
MIN_MARGIN = 1e-3


def _configs(enabled: bool):
    jcfg = jget_config("llama2-7b").smoke()
    cfg = get_config("llama2-7b").smoke()
    jcfg = dataclasses.replace(
        jcfg, dtype="float32", use_kernels=True,
        skip=dataclasses.replace(jcfg.skip, enabled=enabled))
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        skip=dataclasses.replace(cfg.skip, enabled=enabled))
    return jcfg, cfg


def _params(jcfg, rng):
    """Reference init, routers redrawn at unit scale with zero bias."""
    ref = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(SEED), jcfg))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    return ref


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


def _port_forced(params, cfg, toks, forced):
    lg, cache, st = pmodel.prefill(params, torch.from_numpy(toks), cfg,
                                   pad_to=T0 + STEPS)
    logits, gates = [lg.numpy()], [st["attn_gate"].numpy()]
    for s in range(STEPS):
        lg, cache, st = pmodel.decode_step(
            params, cache, torch.from_numpy(forced[:, s:s + 1]), T0 + s, cfg)
        logits.append(lg.numpy())
        gates.append(st["attn_gate"].numpy())
    return logits, gates


@pytest.mark.parametrize("enabled", [True, False])
def test_slice_matches_reference(enabled, monkeypatch):
    jcfg, cfg = _configs(enabled)
    rng = np.random.default_rng(SEED)
    ref = _params(jcfg, rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, ref)
    params = bridge.from_reference(ref, cfg)
    toks = rng.integers(0, cfg.vocab_size, (B, T0))
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    prompts = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)

    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append(float((logits[..., 1] - logits[..., 0]).abs().min()))
        return orig(logits)

    monkeypatch.setattr(routing, "gate_from_logits", recording)

    # prefill + teacher-forced decode steps: gates, then logits, then picks
    jl, jg = _jax_forced(jparams, jcfg, toks, forced)
    pl, pg = _port_forced(params, cfg, toks, forced)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pl, jl):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))

    # lock-step engine, greedy
    jout = JServeEngine(jcfg, jparams, max_len=T0 + NEW).generate(prompts,
                                                                 NEW)
    pout = ServeEngine(LanguageModel(cfg, params, device="cpu"),
                       max_len=T0 + NEW).generate(prompts, NEW)
    np.testing.assert_array_equal(pout["tokens"], jout["tokens"])
    js, ps = jout["stats"], pout["stats"]
    assert ps.kv_saved_fraction == js.kv_saved_fraction
    assert ps.kv_saved_analytic == js.kv_saved_analytic
    assert abs(ps.attn_keep_frac - js.attn_keep_frac) <= 1e-6
    assert ps.prefill_tokens == js.prefill_tokens
    assert ps.decode_tokens == js.decode_tokens

    if enabled:
        # the seed is far from every strict-`>` tie, and routing really
        # skips: the gate log holds both decisions
        assert margins and min(margins) >= MIN_MARGIN, min(margins)
        gates = np.concatenate([g.ravel() for g in pg])
        assert 0.0 < gates.mean() < 1.0
        assert 0.0 < ps.attn_keep_frac < 1.0
    else:
        assert not margins
        assert all(g.min() == 1.0 for g in pg)
        assert ps.kv_saved_fraction == 0.0
