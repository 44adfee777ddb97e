"""The GELU epilogue of the port's fused linear (GeGLU with ``glu``, GELU on
every column without) on the CPU, its plain version, against the JAX
package's jnp oracle (``repro.kernels.ref.fused_linear_ref``) and its
Pallas kernel in interpret mode, for dense weights and int4 codes.  Also
``ref.act`` against ``jax.nn.gelu`` elementwise, the epilogue's
activation codes and the MLP's activation name.

Tolerances (fp32 on both sides): outputs ≤ 1e-4·max|ref| (the sums run in
another order), Σy² ≤ 1e-5 relative; the activation alone ≤ 2·eps·|x|
(x times a cdf within 2 fp32 ulps of 1: tanh and the cube round
differently)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.fused_linear import fused_linear_pallas
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

torch.set_num_threads(2)

TOL = 1e-4
TOL_SQ = 1e-5


def _close(out, want, tol=TOL):
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_gelu_matches_jax_elementwise():
    x = np.concatenate([np.linspace(-12.0, 12.0, 4001),
                        np.random.default_rng(0).standard_normal(4000) * 3])
    x = x.astype(np.float32)
    got = ref.act(torch.from_numpy(x), "gelu").numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - want) <= 2 * eps * np.abs(x))
    # the tanh approximation, not erf's: they differ by up to ~1e-3 here
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    assert np.abs(got - exact).max() > 1e-4


def test_epilogue_activation_codes():
    assert fl._ACTS == {None: 0, "silu": 1, "gelu": 2}
    with pytest.raises(ValueError, match="activation"):
        ref.act(torch.zeros(3), "relu")
    with pytest.raises(ValueError, match="activation"):
        ops.fused_linear({"w": torch.zeros(4, 4)}, torch.zeros(2, 4),
                         act="relu")


@pytest.mark.parametrize("arch", ["gemma3-12b", "llama2-7b", "qwen3-8b"])
def test_mlp_act_name_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert layers.mlp_act_name(cfg) == jlayers.mlp_act_name(jcfg)
    for act in ("swiglu", "geglu", "gelu_mlp"):
        assert layers.mlp_act_name(dataclasses.replace(cfg, mlp_act=act)) \
            == jlayers.mlp_act_name(dataclasses.replace(jcfg, mlp_act=act))
    with pytest.raises(NotImplementedError, match="13.6"):
        layers.mlp_init(torch.Generator().manual_seed(0),
                        dataclasses.replace(cfg.smoke(), mlp_act="gelu_mlp"),
                        "cpu")


def _codes(rng, K, N, G):
    """int4 codes [-8, 7] as int8, group-padded to a multiple of G rows
    (zero codes), and pow2 scales [C, N] fp32."""
    C = -(-K // G)
    codes = rng.integers(-8, 8, (C * G, N)).astype(np.int8)
    codes[K:] = 0
    scale = (2.0 ** rng.integers(-8, -3, (C, N))).astype(np.float32)
    return codes, scale


# glu, prologue, gate_mul, residual, emit_sq: gemma3's gu (GeGLU with the
# norm prologue), the non-GLU GELU alone and with the routed epilogue
_CASES = [(True, True, False, False, False),
          (True, True, True, True, True),
          (False, False, False, False, False),
          (False, True, True, True, True)]


@pytest.mark.parametrize("weights", ["dense", "int4"])
@pytest.mark.parametrize("M", [4, 37])
@pytest.mark.parametrize("glu,prologue,gmul,res,emit_sq", _CASES)
def test_gelu_fused_linear_matches_oracle_and_pallas(weights, M, glu,
                                                     prologue, gmul, res,
                                                     emit_sq):
    rng = np.random.default_rng(M + 10 * glu)
    K, F = 192, 70
    N = 2 * F if glu else F
    x = rng.standard_normal((M, K)).astype(np.float32)
    kw = {}
    if prologue and weights == "dense":
        # (an int4 prologue can move a BFP mantissa by its last bit, which
        # test_torch_int4 bounds; int4 here runs on x as it is)
        kw["mean_sq"] = (x ** 2).mean(-1).astype(np.float32)
        kw["gamma"] = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    if res:
        kw["residual"] = rng.standard_normal((M, F)).astype(np.float32)
    if gmul:
        kw["gate_mul"] = (rng.random(M) > 0.5).astype(np.float32)
    if weights == "dense":
        w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
        params, jw = {"w": torch.from_numpy(w)}, dict(w=jnp.asarray(w))
    else:
        codes, scale = _codes(rng, K, N, 64)
        params = {"w_int": torch.from_numpy(codes),
                  "scale": torch.from_numpy(scale)}
        jw = dict(w_codes=jnp.asarray(codes), scale=jnp.asarray(scale))
    out, sq = ops.fused_linear(
        params, torch.from_numpy(x), glu=glu, act="gelu", emit_sq=emit_sq,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    for jo, jsq in (
            jref.fused_linear_ref(jnp.asarray(x), glu=glu, act="gelu",
                                  emit_sq=emit_sq, **jw, **jkw),
            fused_linear_pallas(jnp.asarray(x), glu=glu, act="gelu",
                                emit_sq=emit_sq, interpret=True, **jw,
                                **jkw)):
        _close(out, jo)
        if emit_sq:
            want = np.asarray(jsq, np.float64)
            assert np.all(np.abs(sq.numpy() - want) <= TOL_SQ * np.abs(want))
        else:
            assert sq is None and jsq is None
    # GELU really ran: the silu epilogue gives another output
    other, _ = ops.fused_linear(
        params, torch.from_numpy(x), glu=glu, act="silu",
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert (other - out).abs().max() > 1e-3 * out.abs().max()
