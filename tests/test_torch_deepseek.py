"""deepseek-coder-33b in the port on the CPU: the config copy, a reduced
config at its grouped-query ratio (7 query heads over 1 kv head, G 7, as
the full width's 56 over 8) against the JAX package lock-step and in
teacher-forced paged decode steps, and the int4 tree built layer by layer
as the weights are drawn (``init_params(int4=True)``, how the card holds
the full width's int4 weights) against ``quantize_params`` of the dense
tree.

The smoke config keeps G 1 (``ModelConfig.smoke`` caps the kv heads at the
heads), so the G 7 config here is the smoke one with 7 heads over 1 kv
head of 32 dims.  Tolerances (fp32): logits ≤ 1e-4·max|ref|; gate logs,
tokens and the paged store's metadata equal; the int4 trees bit for
bit."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kvcache import paged as jpaged
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kvcache import paged as ppaged
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as pmodel
from repro_torch.models.model import LanguageModel, init_params
from repro_torch.quant import int4_head, int4_linears, quantize_params

torch.set_num_threads(2)

SEED = 0
TOL = 1e-4
B, T0, STEPS = 2, 24, 3
G7 = dict(num_heads=7, num_kv_heads=1, head_dim=32)


def _cfgs():
    return (dataclasses.replace(jget_config("deepseek-coder-33b").smoke(),
                                dtype="float32", use_kernels=True, **G7),
            dataclasses.replace(get_config("deepseek-coder-33b").smoke(),
                                dtype="float32", **G7))


JCFG, CFG = _cfgs()


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def world():
    """(jnp tree, port model): routers at unit scale with zero bias."""
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED),
                                               JCFG))
    rng = np.random.default_rng(SEED)

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, ref), model


def test_config_copy_matches_reference():
    for full in (False, True):
        a, b = (jget_config("deepseek-coder-33b"),
                get_config("deepseek-coder-33b"))
        if not full:
            a, b = a.smoke(), b.smoke()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    full = get_config("deepseek-coder-33b")
    assert (full.num_heads // full.num_kv_heads, full.resolved_head_dim,
            full.d_model, full.d_ff) == (7, 128, 7168, 19200)
    assert CFG.num_heads // CFG.num_kv_heads == 7


def test_g7_lockstep_matches_reference(world):
    """Prefill (7·24 packed rows a kv head) and teacher-forced decode steps
    (7 rows) against the reference's fused path (Pallas in interpret
    mode)."""
    jparams, model = world
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, (B, T0))
    forced = rng.integers(0, CFG.vocab_size, (B, STEPS))
    prefill = jax.jit(partial(jmodel.prefill, cfg=JCFG, pad_to=T0 + STEPS))
    decode = jax.jit(partial(jmodel.decode_step, cfg=JCFG))
    lg, cache, st = prefill(jparams, {"tokens": jnp.asarray(toks)})
    pl, pcache, pst = model.prefill(torch.from_numpy(toks), pad_to=T0 + STEPS)
    for s in range(STEPS + 1):
        np.testing.assert_array_equal(pst["attn_gate"].numpy(),
                                      np.asarray(st["attn_gate"]))
        _close(pl, lg)
        np.testing.assert_array_equal(pl.numpy().argmax(-1),
                                      np.asarray(lg).argmax(-1))
        if s == STEPS:
            break
        f = forced[:, s:s + 1]
        lg, cache, st = decode(jparams, cache, {"tokens": jnp.asarray(f)},
                               jnp.int32(T0 + s))
        pl, pcache, pst = model.decode_step(pcache, torch.from_numpy(f),
                                            T0 + s)


def test_g7_paged_decode_matches_reference(world):
    """Teacher-forced paged decode steps (7 query heads over the entry
    stream's one kv head) against the reference's jnp path, both from the
    reference's packed store."""
    jparams, model = world
    params = model.params()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, (12,)) for _ in range(2)]
    forced = rng.integers(0, CFG.vocab_size, (STEPS, 2))
    nA, P, ps = CFG.num_layers, 32, 8
    alloc = ppaged.PageAllocator(P, ps, 2, slot_entry_capacity=32 * nA)
    jcfg = dataclasses.replace(JCFG, use_kernels=False)
    jstore = jpaged.init_store(jcfg, P, ps)
    jprefill = jax.jit(partial(jmodel.prefill, cfg=jcfg))
    for i, p in enumerate(prompts):
        _, c, st = jprefill(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        n = jpaged.prefill_entry_count(g, 12, True)
        assert alloc.ensure(i, n + nA)
        jstore = jpaged.pack_prefill(jstore, c, jnp.asarray(g), jnp.int32(12),
                                     jnp.asarray(alloc.block_table[i]), jcfg)
        alloc.append(i, n, nA * 12)
    store = bridge.store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()})
    jstep = jax.jit(partial(jmodel.paged_decode_step, cfg=jcfg))
    t = np.array([12, 12], np.int32)
    for s in range(STEPS):
        for i in range(2):
            assert alloc.ensure(i, int(alloc.fill[i]) + nA)
        bt, fill = alloc.block_table.copy(), alloc.fill.copy()
        jl, jstore, jst = jstep(jparams, jstore,
                                {"tokens": jnp.asarray(forced[s][:, None])},
                                jnp.asarray(t), jnp.asarray(bt),
                                jnp.asarray(fill))
        pl, store, pst = pmodel.paged_decode_step(
            params, store, torch.from_numpy(forced[s][:, None]),
            torch.from_numpy(t), torch.from_numpy(bt),
            torch.from_numpy(fill), CFG)
        gates = pst["attn_gate"].numpy()
        np.testing.assert_array_equal(gates, np.asarray(jst["attn_gate"]))
        _close(pl, jl)
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(store[k].numpy(),
                                          np.asarray(jstore[k]))
        for i in range(2):
            alloc.append(i, int(1 + gates[1:, i].sum()), nA)
        t = t + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_by_layer_int4_equals_whole_tree(dtype):
    """``init_params(int4=True)`` (each layer quantized as soon as it is
    drawn) equals ``quantize_params`` of the dense tree drawn from the
    same seed, leaf for leaf and bit for bit, at widths where every linear
    passes its 2**16-element threshold."""
    cfg = dataclasses.replace(get_config("deepseek-coder-33b").smoke(),
                              dtype=dtype, d_model=256, d_ff=512)
    dense = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    want = quantize_params(dense, cfg.quant.group_size,
                           cfg.quant.pow2_scales)
    got = init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                      int4=True)
    assert int4_linears(got) and int4_head(got)
    assert all("w_int" in leaf for b in got["blocks"]
               for sub in ("mixer", "ffn")
               for leaf in b[sub]["inner"].values())

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}.{i}")
        else:       # the model's leaves are Parameters of the same data
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype \
                and torch.equal(a, b), path
    walk(got, want)
    m = LanguageModel(cfg, device="cpu", seed=3, int4=True)
    walk(m.params(), want)


@pytest.mark.parametrize("extra", [["--int4"], ["--int4", "--continuous"]])
def test_launcher_deepseek_int4_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "deepseek-coder-33b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "21",
                       "--new-tokens", "3", *extra])
    out = capsys.readouterr().out
    assert "deepseek-coder-33b-smoke: routing: " in out
