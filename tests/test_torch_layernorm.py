"""The port's LayerNorm pieces and unfused projections on the CPU against
the JAX package on the same numpy inputs (stablelm-3b smoke: LayerNorm,
partial rotary 0.25, head dim 32).

Held here: ``norm_init`` (gamma and beta), ``norm_apply`` on its own
statistics and on an injected (μ, σ²), ``norm_stats`` (the two-pass
variance, on a large-offset input where the one-pass E[x²] − μ² cancels),
``fuse_norm_linear``, the unfused GLU ``mlp_apply``, the unfused
``project_qkv`` (one product over the widened ``wqkv``) against the
reference's ``project_q`` + ``project_kv`` (three column-slice products),
``output_proj``, with dense and int4 leaves, and ``_router_and_stats``'s
LayerNorm branch (the plain router product, the pair, a carry ignored).

Tolerances (fp32): outputs ≤ 1e-4·max|ref| (sums in another order); the
statistics μ ≤ 1e-6·max|μ| and σ² ≤ 1e-5·max|σ²|; leaves exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import skip_block as jskip
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.quant import quantize_params as jquantize_params
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import skip_block
from repro_torch.models import attention, layers

torch.set_num_threads(2)

TOL = 1e-4
JCFG = dataclasses.replace(jget_config("stablelm-3b").smoke(),
                           dtype="float32", use_kernels=False)
CFG = dataclasses.replace(get_config("stablelm-3b").smoke(), dtype="float32")


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _x(shape, seed=0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + offset).astype(np.float32)


@pytest.fixture(scope="module")
def block():
    """(reference numpy block, port block) of layer 0, the norm's gamma and
    beta drawn away from 1 and 0 (the init's would not show a missing
    term)."""
    rng = np.random.default_rng(1)
    ref = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), JCFG))
    for b in (ref["stack"]["stage0"]["pos0"],):
        for sub in ("mixer", "ffn"):
            n = b[sub]["norm"]
            n["gamma"] = rng.uniform(0.5, 1.5, n["gamma"].shape).astype(
                np.float32)
            n["beta"] = rng.uniform(-0.5, 0.5, n["beta"].shape).astype(
                np.float32)
    port = bridge.from_reference(ref, CFG)
    return ref["stack"]["stage0"]["pos0"], port["blocks"][0]


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("arch", ["stablelm-3b", "llama2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_init_and_fuse_match_reference(arch, dtype):
    jcfg = dataclasses.replace(jget_config(arch), dtype=dtype,
                               use_kernels=True, fuse_linear=True)
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    j = jlayers.norm_init(48, jcfg)
    p = layers.norm_init(48, cfg, "cpu")
    assert set(p) == set(j)
    for k in j:
        assert str(p[k].dtype).split(".")[-1] == str(j[k].dtype)
        np.testing.assert_array_equal(p[k].float().numpy(),
                                      np.asarray(j[k], np.float32))
    assert layers.fuse_norm_linear(cfg) == jlayers.fuse_norm_linear(jcfg) \
        == (arch == "llama2-7b")


@pytest.mark.parametrize("offset", [0.0, 1e4])
def test_norm_stats_and_apply_match_reference(block, offset):
    """(μ, σ²) two-pass, then the norm on its own and on injected
    statistics.  At offset 1e4 a one-pass variance loses the row's spread
    (checked), the two-pass one does not."""
    _, pb = block
    jn = _jtree(block[0]["mixer"]["norm"])
    x = _x((2, 7, CFG.d_model), offset=offset)
    mu, var = layers.norm_stats(torch.from_numpy(x), CFG)
    jmu, jvar = jlayers.norm_stats(jnp.asarray(x), JCFG)
    _close(mu, jmu, 1e-6)
    _close(var, jvar, 1e-5)
    if offset:
        xf = torch.from_numpy(x)
        one_pass = (xf * xf).mean(-1) - xf.mean(-1) ** 2
        assert (one_pass - var).abs().max() > 0.5 * var.max()
    else:   # at offset 1e4 one ulp of μ is ~1e-3 of the normalised row
        ref = jlayers.norm_apply(jn, jnp.asarray(x), JCFG)
        for stats in (None, (mu, var)):
            out = layers.norm_apply(pb["mixer"]["norm"], torch.from_numpy(x),
                                    CFG, stats=stats)
            _close(out, ref)
    # the same injected statistics on both sides
    jinj = jlayers.norm_apply(jn, jnp.asarray(x), JCFG,
                              stats=(jnp.asarray(mu.numpy()),
                                     jnp.asarray(var.numpy())))
    _close(layers.norm_apply(pb["mixer"]["norm"], torch.from_numpy(x), CFG,
                             stats=(mu, var)), jinj)
    # the RMS statistics without a config, as the fused path takes them
    _close(layers.norm_stats(torch.from_numpy(x)), (x * x).mean(-1))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp_apply_matches_reference(block, act):
    jb, pb = block
    jcfg = dataclasses.replace(JCFG, mlp_act=act)
    cfg = dataclasses.replace(CFG, mlp_act=act)
    x = _x((2, 5, CFG.d_model), seed=2)
    ref = jlayers.mlp_apply(_jtree(jb["ffn"]["inner"]), jnp.asarray(x),
                            jcfg)
    _close(layers.mlp_apply(pb["ffn"]["inner"], torch.from_numpy(x), cfg),
           ref)


def _int4_block(jb):
    """The block's linears quantized by the reference (group 32, pow2
    scales, every linear), and the port's copy of them."""
    jq = jax.tree_util.tree_map(np.asarray, jquantize_params(
        _jtree(jb), 32, True, min_size=0))
    return jq, bridge.from_reference(
        {"embed": {}, "final_norm": {},
         "stack": {"stage0": {"pos0": jq}}},
        dataclasses.replace(CFG, num_layers=1, layer_pattern=("attn",)))[
        "blocks"][0]


@pytest.mark.parametrize("int4", [False, True])
def test_unfused_projections_match_reference(block, int4):
    """The port's one product over ``wqkv`` against the reference's three
    column-slice products, the norm applied on injected (μ, σ²); the
    o-projection; the MLP.  With int4 leaves the products are the int4
    matmul's plain version against the reference's Pallas kernel in
    interpret mode (its jnp path multiplies by the exact dequantized
    weights instead of the BFP product), each on inputs identical on both
    sides (the reference's normalised rows; each linear of the MLP on its
    own): BFP mantissas are rounded from the activation, so a last-bit
    difference upstream could move one by a step."""
    jb, pb = block
    jcfg = dataclasses.replace(JCFG, use_kernels=int4)
    if int4:
        jb, pb = _int4_block(jb)
        assert "w_int" in pb["mixer"]["inner"]["wqkv"]
    ji, pi = _jtree(jb["mixer"]["inner"]), pb["mixer"]["inner"]
    jn = _jtree(jb["mixer"]["norm"])
    x = _x((2, 9, CFG.d_model), seed=3)
    pos = np.random.default_rng(4).integers(0, 300, (2, 9)).astype(np.int32)
    mu, var = layers.norm_stats(torch.from_numpy(x), CFG)
    jst = jlayers.norm_stats(jnp.asarray(x), JCFG)
    kw, jkw = dict(norm=pb["mixer"]["norm"], stats=(mu, var)), dict(
        norm=jn, stats=jst)
    if int4:
        x = np.asarray(jlayers.norm_apply(jn, jnp.asarray(x), JCFG))
        kw, jkw = {}, {}
    jq = jattn.project_q(ji, jnp.asarray(x), jnp.asarray(pos), jcfg, **jkw)
    jk, jv = jattn.project_kv(ji, jnp.asarray(x), jnp.asarray(pos), jcfg,
                              **jkw)
    q, k, v = attention.project_qkv(pi, torch.from_numpy(x),
                                    torch.from_numpy(pos), CFG, **kw)
    H, dh = CFG.num_heads, CFG.resolved_head_dim
    assert q.shape == (2, 9, H, dh) and k.shape == (2, 9, CFG.num_kv_heads,
                                                    dh)
    for a, b in ((q, jq), (k, jk), (v, jv)):
        _close(a, b)
    o = _x((2, 9, H, dh), seed=5)
    _close(attention.output_proj(pi, torch.from_numpy(o), CFG),
           jattn.output_proj(ji, jnp.asarray(o), jcfg))
    jf, pf = _jtree(jb["ffn"]["inner"]), pb["ffn"]["inner"]
    xn = _x((2, 9, CFG.d_model), seed=6)
    if not int4:
        _close(layers.mlp_apply(pf, torch.from_numpy(xn), CFG),
               jlayers.mlp_apply(jf, jnp.asarray(xn), jcfg))
        return
    h = _x((2, 9, CFG.d_ff), seed=7)
    for name, inp in (("gu", xn), ("down", h)):
        _close(layers.linear_apply(pf[name], torch.from_numpy(inp)),
               jlayers.linear_apply(jf[name], jnp.asarray(inp), jcfg))


def test_router_and_stats_layernorm_branch(block):
    """LayerNorm takes the plain router product and the (μ, σ²) pair, and
    ignores a carried Σy² (there is none on the unfused path)."""
    jb, pb = block
    x = _x((2, 6, CFG.d_model), seed=7)
    carried = torch.rand((2, 6))
    for carry in (None, carried):
        lg, st = skip_block._router_and_stats(pb["mixer"],
                                              torch.from_numpy(x), CFG,
                                              True, carry)
        jlg, jst = jskip._router_and_stats(
            _jtree(jb["mixer"]), jnp.asarray(x), JCFG, True,
            None if carry is None else jnp.asarray(carry.numpy()))
        _close(lg, jlg)
        assert isinstance(st, tuple) and len(st) == 2
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
