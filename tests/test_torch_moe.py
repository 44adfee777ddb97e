"""The port's top-k MoE (``models/moe.py``) on the CPU against the JAX
package's ``models/moe.py``: y, ``moe_lb_loss`` and ``moe_drop_frac`` at
capacity factors 8.0 (nothing dropped), 1.25 (the configs') and 0.25 (most
experts over capacity), for grok-1-314b's GeGLU experts and
arctic-480b's SwiGLU experts with the dense residual; the expert choices
against ``jax.lax.top_k``, ties to the lower expert; an expert whose every
pair past C is dropped; Arctic's residual with int4 leaves against the
reference's Pallas int4 kernel in interpret mode; the bridge carrying
the reference's MoE tree (4-D scan-stacked expert leaves) both ways; the
config copies.

The same parameters (the reference's ``moe_init``, carried bit for bit)
and the same x (numpy, seeded) go through both.  Tolerances (fp32): y ≤
1e-4·max|ref|, ``moe_lb_loss`` within 1e-5 relative, ``moe_drop_frac``
within 1e-6 (a count over N·K in fp32, which XLA may scale by 1/(N·K)),
the expert choices exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.quant import quantize_params as jquantize_params
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import layers, moe
from repro_torch.quant import quantize_params

torch.set_num_threads(2)

TOL = 1e-4
DROP_TOL = 1e-6   # a dropped count over N·K in fp32: XLA may multiply by 1/n
ARCHS = ("grok-1-314b", "arctic-480b")
FACTORS = (8.0, 1.25, 0.25)
B, T = 2, 24


def _cfgs(arch, factor=1.25, **kw):
    def one(cfg):
        return dataclasses.replace(cfg.smoke(), dtype="float32",
                                   moe_capacity_factor=factor, **kw)
    return one(jget_config(arch)), one(get_config(arch))


def _params(jcfg, seed=0):
    """The reference's MoE leaves as numpy (jnp tree, port tree)."""
    ref = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), jcfg))
    return ref, bridge._map(ref, bridge.tensor_from_numpy)


def _x(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _run_both(jcfg, cfg, ref, port, x):
    jy, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, ref),
                              jnp.asarray(x), jcfg)
    py, paux = moe.moe_apply(port, torch.from_numpy(x), cfg)
    return (np.asarray(jy), {k: float(v) for k, v in jaux.items()},
            py.numpy(), {k: float(v) for k, v in paux.items()})


def _choices(cfg, gate, x):
    """(port top_e, reference top_e) of the same router product."""
    xf = x.reshape(-1, x.shape[-1])
    jp = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(gate), axis=-1)
    _, je = jax.lax.top_k(jp, cfg.top_k)
    pp = torch.softmax(torch.from_numpy(xf.copy()) @ torch.from_numpy(
        gate.copy()), -1)
    _, pe = moe.top_k_experts(pp, cfg.top_k)
    return pe.numpy(), np.asarray(je)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for full in (False, True):
        a, b = jget_config(arch), get_config(arch)
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    s = get_config(arch).smoke()
    assert (s.num_experts, s.top_k, s.resolved_head_dim,
            s.num_heads // s.num_kv_heads) == (4, 2, 64, 1)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, factor):
    jcfg, cfg = _cfgs(arch, factor)
    ref, port = _params(jcfg)
    assert ("dense" in port) == (arch == "arctic-480b")
    assert not layers.mlp_fusable(port) and set(port) == set(ref)
    x = _x(cfg)
    jy, jaux, py, paux = _run_both(jcfg, cfg, ref, port, x)
    _close(py, jy)
    assert abs(paux["moe_drop_frac"] - jaux["moe_drop_frac"]) <= DROP_TOL
    assert abs(paux["moe_lb_loss"] - jaux["moe_lb_loss"]) <= \
        1e-5 * abs(jaux["moe_lb_loss"])
    if factor == 8.0:
        assert paux["moe_drop_frac"] == 0.0
    if factor == 0.25:
        assert paux["moe_drop_frac"] > 0.5
    pe, je = _choices(cfg, ref["gate"], x)
    np.testing.assert_array_equal(pe, je)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 47, 48, 2048])
@pytest.mark.parametrize("factor", FACTORS)
def test_capacity_is_the_references(n, factor):
    """C = max(8, ⌈f·N·K/E⌉ rounded up to 8), as ``moe_apply`` computes
    it; N ≤ 8 never drops (C ≥ 8)."""
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  moe_capacity_factor=factor)
        c = int(np.ceil(factor * n * cfg.top_k / cfg.num_experts))
        assert moe.capacity(n, cfg) == max(8, -(-c // 8) * 8)
        assert moe.capacity(n, cfg) % 8 == 0
        if n <= 8:
            assert moe.capacity(n, cfg) >= n


def test_top_k_ties_go_to_the_lower_expert():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]])
    vals, idx = moe.top_k_experts(p, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 1], [0, 2]])


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_gate_columns(arch):
    """Two equal ``gate`` columns (experts 1 and 3), both of them the top
    two for every token: expert 1 takes slot 0 and expert 3 slot 1, and
    y equals the reference's."""
    jcfg, cfg = _cfgs(arch, 8.0)
    ref, _ = _params(jcfg)
    g = ref["gate"].copy()
    g[:, 1] = np.abs(g[:, 1]) * 4.0
    g[:, 3] = g[:, 1]
    g[:, 0] = -g[:, 1]
    g[:, 2] = -g[:, 1]
    ref["gate"] = g
    port = bridge._map(ref, bridge.tensor_from_numpy)
    x = np.abs(_x(cfg))
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    probs = torch.softmax(xf @ torch.from_numpy(g), -1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    pe, je = _choices(cfg, g, x)
    np.testing.assert_array_equal(pe, je)
    assert (pe[:, 0] == 1).all() and (pe[:, 1] == 3).all()
    jy, _, py, _ = _run_both(jcfg, cfg, ref, port, x)
    _close(py, jy)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_over_capacity_drops_every_later_pair(arch):
    """Every token's first choice is expert 0: its pairs of tokens C…N−1
    are dropped (they read 0), the drop fraction is the host's count from
    the choices, and y equals the reference's."""
    jcfg, cfg = _cfgs(arch, 1.25)
    ref, _ = _params(jcfg, seed=2)
    ref["gate"] = ref["gate"].copy()
    x = np.abs(_x(cfg, seed=3))
    ref["gate"][:, 0] = np.abs(ref["gate"][:, 0]) + 0.3
    port = bridge._map(ref, bridge.tensor_from_numpy)
    pe, je = _choices(cfg, ref["gate"], x)
    np.testing.assert_array_equal(pe, je)
    N, E, K = B * T, cfg.num_experts, cfg.top_k
    C = moe.capacity(N, cfg)
    assert (pe[:, 0] == 0).all() and N > C
    seen, kept = np.zeros(E, int), 0
    for e in pe.reshape(-1):                # token-major, as the cumsum
        kept += seen[e] < C
        seen[e] += 1
    jy, jaux, py, paux = _run_both(jcfg, cfg, ref, port, x)
    assert abs(paux["moe_drop_frac"] - jaux["moe_drop_frac"]) <= DROP_TOL
    assert abs(paux["moe_drop_frac"] - (1.0 - kept / (N * K))) <= DROP_TOL
    assert paux["moe_drop_frac"] >= (N - C) / (N * K) - DROP_TOL
    _close(py, jy)
    # a dropped first choice: the token's output is its second slot alone
    cut = dict(port, w_down=port["w_down"].clone())
    cut["w_down"][0].zero_()
    y0, _ = moe.moe_apply(cut, torch.from_numpy(x), cfg)
    tail = py.reshape(N, -1)[C:]
    np.testing.assert_array_equal(tail, y0.numpy().reshape(N, -1)[C:])


def test_arctic_int4_residual_matches_pallas_kernel():
    """Arctic's dense residual quantized (2-D ``w`` leaves only: the expert
    leaves and ``gate`` stay fp32) through the port's int4 matmul (plain
    version) against the reference's Pallas int4 kernel in interpret
    mode."""
    jcfg, cfg = _cfgs("arctic-480b", 1.25, use_kernels=True)
    ref, _ = _params(jcfg, seed=4)
    q = jax.tree_util.tree_map(np.asarray, jquantize_params(
        jax.tree_util.tree_map(jnp.asarray, ref), 64, True, 1 << 12))
    assert "w_int" in q["dense"]["gu"] and "w_int" in q["dense"]["down"]
    assert q["w_up"].dtype == np.float32 and q["gate"].dtype == np.float32
    port = bridge._map(q, bridge.tensor_from_numpy)
    mine = quantize_params(bridge._map(ref, bridge.tensor_from_numpy), 64,
                           True, 1 << 12)
    for name in ("gu", "down"):
        for leaf in ("w_int", "scale"):
            assert torch.equal(mine["dense"][name][leaf],
                               port["dense"][name][leaf])
    assert torch.equal(mine["w_up"], port["w_up"])
    x = _x(cfg, seed=5)
    jy, jaux, py, paux = _run_both(jcfg, cfg, q, port, x)
    _close(py, jy)
    assert abs(paux["moe_drop_frac"] - jaux["moe_drop_frac"]) <= DROP_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_moe_tree_both_ways(arch, dtype):
    """The reference's whole smoke tree (its scan-stacked ``stages`` hold
    the experts as 4-D leaves) into the port's per-layer blocks (3-D
    expert leaves, ``gate`` [D, E], Arctic's ``dense``) and back, bit for
    bit."""
    from repro.models import model as jmodel
    jcfg, cfg = _cfgs(arch)
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(3), jcfg))
    assert ref["stack"]["stages"]["pos0"]["ffn"]["inner"]["w_up"].ndim == 4
    port = bridge.from_reference(ref, cfg)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    for blk in port["blocks"]:
        inner = blk["ffn"]["inner"]
        assert not layers.mlp_fusable(inner)
        assert inner["w_up"].shape == (E, D, F)
        assert inner["w_down"].shape == (E, F, D)
        assert inner["gate"].shape == (D, E)
        assert ("dense" in inner) == cfg.dense_residual
    back = bridge.to_reference(port, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(ref)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(a, flat_b[path])
