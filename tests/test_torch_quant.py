"""The port's int4 weight quantization (``repro_torch.quant``) and the
bridge's quantized leaves on the CPU against the JAX package's
``repro.quant``, on the same numpy weights.

Tolerance: none.  Codes, scales, dequantized weights and bridged leaves
must be equal bit for bit (both sides run fp32 arithmetic with the same
``ceil(log2(·))`` exponent formula and half-to-even rounding)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.quant import dequantize, quantize_params, quantize_rtn

torch.set_num_threads(2)

MIN_SIZE = 1 << 12          # smoke weights qualify (the default is 1 << 16)
GROUP = 64


def _weight(K, N, dtype, seed):
    """(numpy weight as the reference holds it, the port's tensor)."""
    w = (np.random.default_rng(seed).standard_normal((K, N))
         / np.sqrt(K)).astype(np.float32)
    a = np.asarray(jnp.asarray(w).astype(dtype))
    return a, bridge.tensor_from_numpy(a)


@pytest.mark.parametrize("K,N,G", [(256, 48, 64), (200, 33, 64),
                                   (40, 16, 128)])
@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_rtn_matches_reference_bit_for_bit(K, N, G, pow2, dtype):
    a, w = _weight(K, N, dtype, seed=K + N + G)
    codes, scale = quantize_rtn(w, G, pow2)
    jcodes, jscale = jquant.quantize_rtn(jnp.asarray(a), G, pow2)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if pow2:
        m, _ = np.frexp(scale.numpy())
        assert np.all(m == 0.5)                 # exact powers of two
    for k in (0, K):
        np.testing.assert_array_equal(
            dequantize(codes, scale, k).numpy(),
            np.asarray(jquant.dequantize(jcodes, jscale, k)))


def test_quantize_rtn_zero_groups_and_padding():
    w = torch.zeros((200, 8))
    w[:64, 1] = 0.5
    codes, scale = quantize_rtn(w, 64)
    assert codes.shape == (256, 8) and scale.shape == (4, 8)
    assert torch.all(codes[200:] == 0)          # zero-padded last group
    assert scale[0, 1] == 0.125 and torch.all(codes[:64, 1] == 4)
    assert torch.all(scale[:, 0] == 1.0)        # all-zero groups
    np.testing.assert_array_equal(
        dequantize(codes, scale, 200).numpy(), w.numpy())


def _cfgs(dtype, layers=3):
    jcfg = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype=dtype,
                               num_layers=layers)
    cfg = dataclasses.replace(get_config("llama2-7b").smoke(), dtype=dtype,
                              num_layers=layers)
    return jcfg, cfg


def quantize_all_layers(tree, group=GROUP, pow2=True, min_size=MIN_SIZE):
    """The reference tree with every layer quantized: the reference's rule
    (2-D ``w`` leaves of >= min_size elements) applied to each slice of the
    scan-stacked ``stages`` leaves too, the slices restacked."""
    def walk(t):
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            if k == "w" and v.ndim in (2, 3) and \
                    (v.size if v.ndim == 2 else v[0].size) >= min_size:
                pieces = [jquant.quantize_rtn(jnp.asarray(s), group, pow2)
                          for s in (v if v.ndim == 3 else [v])]
                codes, scales = (np.stack([np.asarray(p[i]) for p in pieces])
                                 for i in (0, 1))
                out["w_int"] = codes if v.ndim == 3 else codes[0]
                out["scale"] = scales if v.ndim == 3 else scales[0]
            else:
                out[k] = walk(v)
        return out
    return walk(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for path, t in la.items():
        u = lb[path]
        assert t.dtype == u.dtype and t.shape == u.shape, path
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, u.view(torch.int16)
                           if u.dtype == torch.bfloat16 else u), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_reference_all_layers(dtype):
    jcfg, cfg = _cfgs(dtype)
    ref = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(3), jcfg))
    mine = quantize_params(bridge.from_reference(ref, cfg), GROUP, True,
                           MIN_SIZE)
    _assert_trees_equal(mine, bridge.from_reference(quantize_all_layers(ref),
                                                    cfg))
    # every linear of every layer and the lm head; routers and the
    # embedding table stay dense
    for blk in mine["blocks"]:
        for sub in blk.values():
            assert "w" in sub["router"] and "w_int" not in sub["router"]
            for lin in ("wqkv", "wo", "gu", "down"):
                node = sub["inner"].get(lin)
                if node is not None:
                    assert set(node) == {"w_int", "scale"}
    assert set(mine["lm_head"]) == {"w_int", "scale"}
    assert "table" in mine["embed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_reference_mixed_tree_bit_for_bit(dtype):
    """The reference's own ``quantize_params`` quantizes the 2-D stage0 and
    lm-head leaves and leaves the 3-D stacked ``stages`` dense: the bridge
    carries that mixed tree both ways leaf for leaf."""
    jcfg, cfg = _cfgs(dtype)
    ref = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_params(
            jmodel.init_params(jax.random.PRNGKey(4), jcfg), GROUP, True,
            MIN_SIZE))
    port = bridge.from_reference(ref, cfg)
    k_len = cfg.stage_len
    for i, blk in enumerate(port["blocks"]):
        wqkv = blk["mixer"]["inner"]["wqkv"]
        if i < k_len:
            assert wqkv["w_int"].dtype == torch.int8
            assert wqkv["scale"].dtype == torch.float32
        else:
            assert set(wqkv) == {"w"}
    assert port["lm_head"]["w_int"].dtype == torch.int8
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
