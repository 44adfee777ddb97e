"""The port's modules (layers, routing, kv_reuse, attention, bridge) on the
CPU against their JAX counterparts on the same numpy inputs.  The JAX side
runs its fused Pallas path (``use_kernels=True``) in interpret mode.

Tolerance: fp32 outputs ≤ 1e-4·max|ref| (sums in another order); gates,
masks, index plumbing and bridged leaves exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import kv_reuse as jkv
from repro.core import routing as jrouting
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import kv_reuse, routing
from repro_torch.models import attention, layers

torch.set_num_threads(2)

TOL = 1e-4
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _ref_params(cfg=JCFG, seed=0):
    p = jmodel.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def block():
    """(reference numpy block, port block) for layer 0."""
    ref = _ref_params()
    port = bridge.from_reference(ref, CFG)
    return ref["stack"]["stage0"]["pos0"], port["blocks"][0]


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Config copy
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    for full in (False, True):
        a = jget_config("llama2-7b")
        b = get_config("llama2-7b")
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_embed_unembed_norm():
    ref = _ref_params()
    port = bridge.from_reference(ref, CFG)
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 7))
    e = layers.embed(port["embed"], torch.from_numpy(toks))
    je = jlayers.embed(_jtree(ref["embed"]), jnp.asarray(toks))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    x = _x((2, 7, CFG.d_model))
    stats = (x ** 2).mean(-1)
    n = layers.norm_apply(port["final_norm"], torch.from_numpy(x), CFG,
                          stats=torch.from_numpy(stats))
    jn = jlayers.norm_apply(_jtree(ref["final_norm"]), jnp.asarray(x), JCFG,
                            stats=jnp.asarray(stats))
    _close(n, jn)
    _close(layers.norm_stats(torch.from_numpy(x)),
           jlayers.norm_stats(jnp.asarray(x), JCFG))
    u = layers.unembed(port["embed"], port["lm_head"], torch.from_numpy(x),
                       CFG)
    ju = jlayers.unembed(_jtree(ref["embed"]), _jtree(ref["lm_head"]),
                         jnp.asarray(x), JCFG)
    _close(u, ju)


@pytest.mark.parametrize("dh", [32, 64])
def test_rope(dh):
    cfg = dataclasses.replace(CFG, head_dim=dh)
    jcfg = dataclasses.replace(JCFG, head_dim=dh)
    _close(layers.rope_freqs(dh, 1.0, cfg.rope_theta),
           jlayers.rope_freqs(dh, 1.0, jcfg.rope_theta), tol=1e-6)
    x = _x((2, 9, 4, dh), seed=dh)
    pos = np.random.default_rng(dh).integers(0, 600, (2, 9)).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg),
           tol=1e-5)


@pytest.mark.parametrize("T", [1, 6])
def test_mlp_apply_fused(block, T):
    ref_b, port_b = block
    x = _x((2, T, CFG.d_model), seed=T)
    stats = (x ** 2).mean(-1)
    res = _x((2, T, CFG.d_model), seed=T + 1)
    gm = (np.random.default_rng(T).random((2, T)) > 0.5).astype(np.float32)
    out, sq = layers.mlp_apply_fused(
        port_b["ffn"]["inner"], torch.from_numpy(x), CFG,
        norm=port_b["ffn"]["norm"], stats=torch.from_numpy(stats),
        residual=torch.from_numpy(res), gate_mul=torch.from_numpy(gm),
        emit_sq=True)
    jo, jsq = jlayers.mlp_apply_fused(
        _jtree(ref_b["ffn"]["inner"]), jnp.asarray(x), JCFG,
        norm=_jtree(ref_b["ffn"]["norm"]), stats=jnp.asarray(stats),
        residual=jnp.asarray(res), gate_mul=jnp.asarray(gm), emit_sq=True)
    _close(out, jo)
    _close(sq, jsq, tol=1e-5)


# ---------------------------------------------------------------------------
# Routing and KV reuse
# ---------------------------------------------------------------------------

def test_routing(block):
    ref_b, port_b = block
    x = _x((2, 5, CFG.d_model), seed=3)
    lg = routing.router_logits(port_b["mixer"]["router"], torch.from_numpy(x))
    jl = jrouting.router_logits(_jtree(ref_b["mixer"]["router"]),
                                jnp.asarray(x))
    _close(lg, jl)
    # the strict `>` on identical logits, ties included
    logits = np.random.default_rng(4).standard_normal((3, 7, 2)).astype(
        np.float32)
    logits[0, :3, 1] = logits[0, :3, 0]
    g, pk = routing.gate_from_logits(torch.from_numpy(logits))
    jg, jpk = jrouting.gate_from_logits(jnp.asarray(logits), None, JCFG,
                                        False)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    _close(pk, jpk, tol=1e-6)
    assert g[0, :3].sum() == 0
    s = routing.router_stats(pk, g, CFG)
    js = jrouting.router_stats(jpk, jg, JCFG)
    for k in ("keep_frac", "router_loss"):
        _close(s[k], js[k], tol=1e-6)


def test_neutral_router_bias():
    ref = _ref_params()
    port = routing.neutral_router_bias(bridge.from_reference(ref, CFG))
    jref = jax.tree_util.tree_map(
        np.asarray, jrouting.neutral_router_bias(_jtree(ref)))
    back = bridge.to_reference(port, CFG)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jref))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def test_kv_reuse():
    rng = np.random.default_rng(5)
    k0, v0, k1, v1 = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
                      for _ in range(4))
    gate = (rng.random((2, 6)) > 0.5).astype(np.float32)
    t = torch.from_numpy
    mk, mv = kv_reuse.merge_view((t(k0), t(v0)), t(k1), t(v1), t(gate))
    jk, jv = jkv.merge_view((jnp.asarray(k0), jnp.asarray(v0)),
                            jnp.asarray(k1), jnp.asarray(v1),
                            jnp.asarray(gate))
    np.testing.assert_array_equal(mk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    assert kv_reuse.merge_view(None, t(k1), t(v1), t(gate))[0] is not None
    tk, tv = kv_reuse.merge_token_view((t(k0[:, :1]), t(v0[:, :1])),
                                       t(k1[:, :1]), t(v1[:, :1]),
                                       t(gate[:, 0]))
    jtk, jtv = jkv.merge_token_view(
        (jnp.asarray(k0[:, :1]), jnp.asarray(v0[:, :1])),
        jnp.asarray(k1[:, :1]), jnp.asarray(v1[:, :1]),
        jnp.asarray(gate[:, 0]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jtk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    gates = (rng.random((4, 3, 9)) > 0.4).astype(np.float32)
    assert float(kv_reuse.storage_saved_fraction(t(gates))) == float(
        jkv.storage_saved_fraction(jnp.asarray(gates)))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def test_project_qkv_and_output_proj(block):
    ref_b, port_b = block
    B, T = 2, 6
    x = _x((B, T, CFG.d_model), seed=6)
    stats = (x ** 2).mean(-1)
    pos = np.broadcast_to(np.arange(3, 3 + T, dtype=np.int32), (B, T)).copy()
    inner, jinner = port_b["mixer"]["inner"], _jtree(ref_b["mixer"]["inner"])
    norm, jnorm = port_b["mixer"]["norm"], _jtree(ref_b["mixer"]["norm"])
    q, k, v = attention.project_qkv(inner, torch.from_numpy(x),
                                    torch.from_numpy(pos), CFG, norm=norm,
                                    stats=torch.from_numpy(stats))
    jq, jk, jv = jattn.project_qkv(jinner, jnp.asarray(x), jnp.asarray(pos),
                                   JCFG, norm=jnorm, stats=jnp.asarray(stats))
    for a, b in ((q, jq), (k, jk), (v, jv)):
        _close(a, b)
    o = _x((B, T, CFG.num_heads, CFG.resolved_head_dim), seed=7)
    gm = (np.random.default_rng(8).random((B, T)) > 0.5).astype(np.float32)
    y, sq = attention.output_proj_fused(
        inner, torch.from_numpy(o), CFG, residual=torch.from_numpy(x),
        gate_mul=torch.from_numpy(gm), emit_sq=True)
    jy, jsq = jattn.output_proj_fused(
        jinner, jnp.asarray(o), JCFG, residual=jnp.asarray(x),
        gate_mul=jnp.asarray(gm), emit_sq=True)
    _close(y, jy)
    _close(sq, jsq, tol=1e-5)


@pytest.mark.parametrize("Tq", [1, 10])
def test_attention_core(Tq):
    B, H, dh, Tk = 2, CFG.num_heads, CFG.resolved_head_dim, 16
    q = _x((B, Tq, H, dh), seed=Tq)
    k = _x((B, Tk, H, dh), seed=Tq + 1)
    v = _x((B, Tk, H, dh), seed=Tq + 2)
    if Tq == 1:
        t = np.array([4, 15], np.int32)
        pos, kvl = t[:, None], t + 1
    else:
        pos = np.broadcast_to(np.arange(Tq, dtype=np.int32), (B, Tq)).copy()
        kvl = None
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jj = lambda a: None if a is None else jnp.asarray(a)       # noqa: E731
    o = attention.attention_core(tt(q), tt(k), tt(v), q_positions=tt(pos),
                                 cfg=CFG, kv_valid_len=tt(kvl))
    jo = jattn.attention_core(jj(q), jj(k), jj(v), q_positions=jj(pos),
                              cfg=JCFG, kv_valid_len=jj(kvl))
    _close(o, jo)


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype, num_layers=3)
    cfg = dataclasses.replace(CFG, dtype=dtype, num_layers=3)
    ref = _ref_params(jcfg, seed=2)
    port = bridge.from_reference(ref, cfg)
    assert len(port["blocks"]) == 3
    wqkv = port["blocks"][2]["mixer"]["inner"]["wqkv"]["w"]
    assert wqkv.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    back = bridge.to_reference(port, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_a) == len(flat_b) > 0
    for path, leaf in flat_a:
        want = flat_b[path]
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert leaf.shape == want.shape and leaf.dtype == want.dtype, path
        np.testing.assert_array_equal(leaf, want)
