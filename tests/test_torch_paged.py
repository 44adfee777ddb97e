"""The port's paged §4.4 path on the CPU against the JAX package: the paged
attention plain version against the jnp oracle and the Pallas kernel
(interpret mode), the history indirection, the page allocator, the store
writes (``pack_prefill``, ``commit_decode``) and ``paged_decode_step``,
which must also agree with the port's own dense ``decode_step`` (the
reference's contract in ``tests/test_paged_kv.py``).

Tolerances: attention outputs within 2e-5 (the reference's own kernel
test); logits ≤ 1e-4·max|ref| (fp32, sums in another order); gates, entry
metadata and allocator traces exactly.  Quantized codes are exact except
where ``amax/qmax`` is within one ulp of a power of two (XLA's and torch's
``log2`` may round differently there); dequantized rows are then within one
quantization step."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kvcache import history as jhistory
from repro.kvcache import paged as jpaged
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kvcache import history, paged
from repro_torch.models import model as pmodel

torch.set_num_threads(2)

TOL_ATTN = 2e-5
TOL = 1e-4
SEED = 0
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
_JPREFILL = jax.jit(partial(jmodel.prefill, cfg=JCFG))
_JSTEP = jax.jit(partial(jmodel.paged_decode_step, cfg=JCFG))


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a))


def _close(out, want, tol=TOL):
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _params(rng):
    """Reference init, routers redrawn at unit scale with zero bias (routing
    really skips and no gate sits near the strict `>` tie)."""
    p = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(p)
    return p


# ---------------------------------------------------------------------------
# Paged attention: plain version vs the jnp oracle and the Pallas kernel
# ---------------------------------------------------------------------------

# (B, Hkv, dh, P, ps, J): the default history, and a page of 5 entries over
# 3 kv-heads (the split walk's head groups of 2 leave the last one short)
_SHAPE = (3, 2, 32, 16, 4, 3)
_SHAPE_PS5 = (2, 3, 32, 16, 5, 7)


def _attn_inputs(rng, G, kv_dtype, empty, shape=_SHAPE):
    B, Hkv, dh, P, ps, J = (2, 1, 16, 4, 4, 2) if empty else shape
    Hq = G * Hkv
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    q, kt, vt = f(B, 1, Hq, dh), f(B, 1, Hkv, dh), f(B, 1, Hkv, dh)
    kp, vp = f(P, ps, Hkv, dh), f(P, ps, Hkv, dh)
    scales = {}
    if kv_dtype is not None:
        kc, vc, ks, vs = (np.asarray(a) for a in jpaged.quantize_entries(
            jnp.asarray(kp), jnp.asarray(vp), kv_dtype))
        kp, vp = kc, vc
        scales = {"k_scales": ks, "v_scales": vs}
    if empty:
        bt = np.zeros((B, J), np.int32)
        pos = np.full((B, J * ps), history.MASKED_POS, np.int32)
        qpos = np.zeros((B, 1), np.int32)
    else:
        bt = rng.integers(0, P, (B, J)).astype(np.int32)
        pos = rng.integers(0, 9, (B, J * ps)).astype(np.int32)
        pos[rng.random((B, J * ps)) < 0.4] = history.MASKED_POS
        qpos = np.full((B, 1), 9, np.int32)
    return (q, kp, vp, bt, pos, kt, vt), qpos, scales


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("G,shape", [(1, _SHAPE), (2, _SHAPE), (8, _SHAPE),
                                     (16, _SHAPE), (2, _SHAPE_PS5)],
                         ids=["1", "2", "8", "16", "ps5-hkv3"])
def test_paged_attention_matches_oracle_and_pallas(G, shape, kv_dtype):
    rng = np.random.default_rng(10 * G + len(kv_dtype or "")
                                + 100 * (shape != _SHAPE))
    args, qpos, scales = _attn_inputs(rng, G, kv_dtype, empty=False,
                                      shape=shape)
    _check_attention(args, qpos, scales, kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int4"])
def test_paged_attention_empty_history(kv_dtype):
    """A fresh slot (all MASKED_POS, all-zero block table) degrades to
    attention over the in-flight token alone."""
    args, qpos, scales = _attn_inputs(np.random.default_rng(1), 2, kv_dtype,
                                      empty=True)
    out = _check_attention(args, qpos, scales, kv_dtype)
    G = args[0].shape[2] // args[5].shape[2]
    np.testing.assert_allclose(out, np.repeat(args[6], G, axis=2),
                               rtol=TOL_ATTN, atol=TOL_ATTN)


def _check_attention(args, qpos, scales, kv_dtype):
    jkw = {k: jnp.asarray(v) for k, v in scales.items()}
    pkw = {k: _t(v) for k, v in scales.items()}
    want = [np.asarray(fn(*map(jnp.asarray, args),
                          q_positions=jnp.asarray(qpos), kv_dtype=kv_dtype,
                          **jkw))
            for fn in (jref.paged_attention_ref, jops.paged_decode_attention)]
    np.testing.assert_allclose(want[1], want[0], rtol=TOL_ATTN,
                               atol=TOL_ATTN)
    got = [fn(*map(_t, args), q_positions=_t(qpos), kv_dtype=kv_dtype,
              **pkw).numpy()
           for fn in (ref.paged_attention_ref, ops.paged_decode_attention)]
    for g in got:
        for w in want:
            np.testing.assert_allclose(g, w, rtol=TOL_ATTN, atol=TOL_ATTN)
    return got[1]


# ---------------------------------------------------------------------------
# History indirection and accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reuse", [True, False])
def test_history_functions_match_reference(reuse):
    rng = np.random.default_rng(3)
    gates = (rng.random((5, 3, 7)) < 0.5).astype(np.float32)
    fresh = history.fresh_mask(_t(gates), reuse)
    jfresh = jhistory.fresh_mask(jnp.asarray(gates), reuse)
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))
    np.testing.assert_array_equal(history.next_fresh_layer(fresh).numpy(),
                                  np.asarray(jhistory.next_fresh_layer(
                                      jfresh)))
    S, E = 3, 24
    pos = rng.integers(0, 50, (S, E)).astype(np.int32)
    l0 = rng.integers(0, 5, (S, E)).astype(np.int32)
    l1 = (l0 + rng.integers(1, 4, (S, E))).astype(np.int32)
    in_fill = rng.random((S, E)) < 0.8
    for a in range(5):
        np.testing.assert_array_equal(
            history.effective_positions(_t(pos), _t(l0), _t(l1),
                                        _t(in_fill), a).numpy(),
            np.asarray(jhistory.effective_positions(
                *map(jnp.asarray, (pos, l0, l1, in_fill)), a)))

    acc, jacc = (h.HistoryAccounting(5, 3, reuse) for h in (history,
                                                          jhistory))
    for h in (acc, jacc):
        h.on_prefill(0, gates[:, 0], 6)
        h.on_prefill(2, gates[:, 1], 4)
        for s in range(4):
            h.on_decode_step(s % 3, gates[:, 2, s])
        h.on_release(1)
    np.testing.assert_array_equal(acc.hits, jacc.hits)
    np.testing.assert_array_equal(acc.reads, jacc.reads)
    assert acc.per_layer_hit_rate == jacc.per_layer_hit_rate
    assert acc.hit_rate == jacc.hit_rate


def test_page_allocator_trace_matches_reference():
    rng = np.random.default_rng(4)
    mine = paged.PageAllocator(12, 4, 3, slot_entry_capacity=20)
    theirs = jpaged.PageAllocator(12, 4, 3, slot_entry_capacity=20)
    pins = {}
    for _ in range(200):
        op, slot = rng.integers(0, 7), int(rng.integers(0, 3))
        n = int(rng.integers(1, 21))
        empty = [s for s in range(3) if not mine.chain(s)]
        if op == 0:
            assert mine.ensure(slot, n) == theirs.ensure(slot, n)
        elif op == 1 and mine.capacity(slot) - mine.fill[slot] > 0:
            k = int(rng.integers(1, mine.capacity(slot) - mine.fill[slot]
                                 + 1))
            mine.append(slot, k, 2 * k)
            theirs.append(slot, k, 2 * k)
        elif op == 2:
            assert mine.release(slot) == theirs.release(slot)
        elif op == 3:
            assert mine.trim(slot) == theirs.trim(slot)
        elif op == 4 and mine.chain(slot):
            page = mine.chain(slot)[0]
            mine.ref_pages([page])
            theirs.ref_pages([page])
            pins[page] = pins.get(page, 0) + 1
        elif op == 5:
            hidden = (mine.hide_pages(n % 4), theirs.hide_pages(n % 4))
            assert hidden[0] == hidden[1]
            mine.unhide_pages(hidden[0])
            theirs.unhide_pages(hidden[1])
        elif op == 6 and empty and mine.chain(slot):
            # adopt the first full pages of another chain (prefix sharing)
            shared = mine.chain(slot)[:max(1, int(mine.fill[slot]) // 4)]
            for a in (mine, theirs):
                a.alias_into(empty[0], shared)
                a.seed_fill(empty[0], min(4 * len(shared),
                                          int(mine.fill[slot])))
        for a, b in (("block_table", "block_table"), ("fill", "fill"),
                     ("refcount", "refcount")):
            np.testing.assert_array_equal(getattr(mine, a),
                                          getattr(theirs, b))
        assert mine._free == theirs._free
        assert dataclasses.asdict(mine.stats) == dataclasses.asdict(
            theirs.stats)
        mine.check_conservation(pins)
    assert mine.saved_fraction == theirs.saved_fraction
    for page, n in pins.items():
        assert mine.deref_pages([page] * n) == theirs.deref_pages([page] * n)
    for s in range(3):
        mine.release(s)
        theirs.release(s)
    mine.check_conservation()
    assert mine.free_pages == theirs.free_pages == 12


# ---------------------------------------------------------------------------
# Store writes: pack_prefill and commit_decode
# ---------------------------------------------------------------------------

def _near_pow2(amax, qmax):
    """Rows whose amax/qmax lies within one ulp of a power of two."""
    r = (np.asarray(amax, np.float32) / np.float32(qmax)).astype(np.float32)
    p = np.exp2(np.round(np.log2(np.maximum(r, 1e-30)))).astype(np.float32)
    return np.abs(r - p) <= np.spacing(p)


def _check_store(mine, theirs, kv_dtype, k_rows=None, v_rows=None):
    """Metadata exactly; payload exactly (fp32) or codes exactly except at
    near-pow2 rows, dequantized rows within one quantization step."""
    got = {k: bridge.tensor_to_numpy(v) for k, v in mine.items()}
    want = {k: np.asarray(v) for k, v in theirs.items()}
    assert sorted(got) == sorted(want)
    for k in ("pos_pages", "l0_pages", "l1_pages"):
        np.testing.assert_array_equal(got[k], want[k])
    if kv_dtype is None:
        for k in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(got[k], want[k])
        return
    qmax = 127.0 if kv_dtype == "int8" else 7.0
    for name, rows in (("k", k_rows), ("v", v_rows)):
        sc, jsc = got[f"{name}_scales"], want[f"{name}_scales"]
        same = sc == jsc
        assert np.all(same | _near_pow2(rows, qmax))
        np.testing.assert_array_equal(got[f"{name}_pages"][same],
                                      want[f"{name}_pages"][same])
        deq = paged.dequantize_entries(_t(got[f"{name}_pages"]), _t(sc),
                                       kv_dtype).numpy()
        jdeq = np.asarray(jpaged.dequantize_entries(
            jnp.asarray(want[f"{name}_pages"]), jnp.asarray(jsc), kv_dtype))
        assert np.all(np.abs(deq - jdeq) <= np.maximum(sc, jsc)[..., None])


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_pack_prefill_and_commit_match_reference(kv_dtype):
    rng = np.random.default_rng(5)
    nA, T, Hkv, dh = CFG.num_layers, 11, CFG.num_kv_heads, \
        CFG.resolved_head_dim
    P, ps, S = 24, 4, 2
    k_views = rng.standard_normal((nA, T, Hkv, dh)).astype(np.float32)
    v_views = rng.standard_normal((nA, T, Hkv, dh)).astype(np.float32)
    gates = (rng.random((nA, T)) < 0.5).astype(np.float32)
    alloc = paged.PageAllocator(P, ps, S, slot_entry_capacity=16 * nA)
    n = paged.prefill_entry_count(gates, 9, paged.reuse_enabled(CFG))
    assert n == jpaged.prefill_entry_count(gates, 9,
                                           jpaged.reuse_enabled(JCFG))
    assert alloc.ensure(0, n + nA) and alloc.ensure(1, 2 * nA)
    alloc.append(0, n, nA * 9)

    jstore = jpaged.init_store(JCFG, P, ps, kv_dtype=kv_dtype)
    store = paged.init_store(CFG, P, ps, kv_dtype=kv_dtype, device="cpu")
    jcache = {"stage0": {"pos0": {"k": jnp.asarray(k_views[0][None]),
                                  "v": jnp.asarray(v_views[0][None])}},
              "stages": {"pos0": {"k": jnp.asarray(k_views[1:, None]),
                                  "v": jnp.asarray(v_views[1:, None])}}}
    assert JCFG.stage_len == 1 and JCFG.num_stages == nA
    cache = [{"k": _t(k_views[a][None]), "v": _t(v_views[a][None])}
             for a in range(nA)]
    jstore = jpaged.pack_prefill(jstore, jcache, jnp.asarray(gates),
                                 jnp.int32(9),
                                 jnp.asarray(alloc.block_table[0]), JCFG,
                                 kv_dtype=kv_dtype)
    paged.pack_prefill(store, cache, _t(gates), 9, _t(alloc.block_table[0]),
                       CFG, kv_dtype=kv_dtype)

    # per stored (entry, head): amax of the row that landed there
    pos = np.asarray(jstore["pos_pages"])
    l0 = np.asarray(jstore["l0_pages"])
    ok = pos < history.MASKED_POS
    k_amax = np.zeros(pos.shape + (Hkv,), np.float32)
    v_amax = k_amax.copy()
    k_amax[ok] = np.abs(k_views[l0[ok], pos[ok]]).max(-1)
    v_amax[ok] = np.abs(v_views[l0[ok], pos[ok]]).max(-1)
    _check_store(store, jstore, kv_dtype, k_amax, v_amax)

    # one decode commit for both slots (slot 1 inactive: nothing lands)
    buf_k = rng.standard_normal((nA, S, Hkv, dh)).astype(np.float32)
    buf_v = rng.standard_normal((nA, S, Hkv, dh)).astype(np.float32)
    g = (rng.random((nA, S)) < 0.5).astype(np.float32)
    t = np.array([9, 3], np.int32)
    fill = alloc.fill.copy()
    active = np.array([True, False])
    jstore = jpaged.commit_decode(jstore, jnp.asarray(buf_k),
                                  jnp.asarray(buf_v), jnp.asarray(g),
                                  jnp.asarray(t),
                                  jnp.asarray(alloc.block_table),
                                  jnp.asarray(fill), jnp.asarray(active),
                                  JCFG, kv_dtype=kv_dtype)
    paged.commit_decode(store, _t(buf_k), _t(buf_v), _t(g), _t(t),
                        _t(alloc.block_table), _t(fill), _t(active), CFG,
                        kv_dtype=kv_dtype)
    pos = np.asarray(jstore["pos_pages"])
    l0 = np.asarray(jstore["l0_pages"])
    k_amax2, v_amax2 = k_amax.copy(), v_amax.copy()
    new = pos == 9
    k_amax2[new] = np.abs(buf_k[l0[new], 0]).max(-1)
    v_amax2[new] = np.abs(buf_v[l0[new], 0]).max(-1)
    _check_store(store, jstore, kv_dtype, k_amax2, v_amax2)
    assert int(new.sum()) == int(1 + g[1:, 0].sum())


# ---------------------------------------------------------------------------
# paged_decode_step: port vs reference, and port paged vs port dense
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(SEED)
    ref_params = _params(rng)
    params = bridge.from_reference(ref_params, CFG)
    lens = [10, 6]
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    forced = rng.integers(0, CFG.vocab_size, (3, 2)).astype(np.int32)
    return ref_params, params, lens, prompts, forced


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_decode_step_matches_reference(setup, kv_dtype):
    """Both packages step from the same (bridged) store: gates exactly,
    logits ≤ 1e-4·max, entry metadata exactly, payloads within 1e-4·max
    (fp32) or one quantization step (int8 and int4; the committed rows
    differ in their last bits, so a code may round the other way)."""
    ref_params, params, lens, prompts, forced = setup
    jparams = jax.tree_util.tree_map(jnp.asarray, ref_params)
    nA = CFG.num_layers
    P, ps = 32, 8
    alloc = paged.PageAllocator(P, ps, 2, slot_entry_capacity=32 * nA)
    jstore = jpaged.init_store(JCFG, P, ps, kv_dtype=kv_dtype)
    for i, p in enumerate(prompts):
        _, c, st = _JPREFILL(jparams, {"tokens": jnp.asarray(p[None])})
        g = np.asarray(st["attn_gate"])[:, 0]
        n = jpaged.prefill_entry_count(g, lens[i], True)
        assert alloc.ensure(i, n + nA)
        jstore = jpaged.pack_prefill(jstore, c, jnp.asarray(g),
                                     jnp.int32(lens[i]),
                                     jnp.asarray(alloc.block_table[i]), JCFG,
                                     kv_dtype=kv_dtype)
        alloc.append(i, n, nA * lens[i])
    store = bridge.store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()})
    t = np.array(lens, np.int32)
    for s in range(forced.shape[0]):
        for i in range(2):
            assert alloc.ensure(i, int(alloc.fill[i]) + nA)
        bt, fill = alloc.block_table.copy(), alloc.fill.copy()
        jl, jstore, jst = _JSTEP(jparams, jstore,
                                {"tokens": jnp.asarray(forced[s][:, None])},
                                jnp.asarray(t), jnp.asarray(bt),
                                jnp.asarray(fill))
        pl, store, pst = pmodel.paged_decode_step(
            params, store, _t(forced[s][:, None]).long(), _t(t), _t(bt),
            _t(fill), CFG)
        gates = pst["attn_gate"].numpy()
        np.testing.assert_array_equal(gates, np.asarray(jst["attn_gate"]))
        _close(pl.numpy(), np.asarray(jl))
        got = {k: v.numpy() for k, v in store.items()}
        want = {k: np.asarray(v) for k, v in jstore.items()}
        for k in ("pos_pages", "l0_pages", "l1_pages"):
            np.testing.assert_array_equal(got[k], want[k])
        for name in ("k", "v"):
            if kv_dtype is None:
                _close(got[f"{name}_pages"], want[f"{name}_pages"])
                continue
            sc, jsc = got[f"{name}_scales"], want[f"{name}_scales"]
            deq = paged.dequantize_entries(_t(got[f"{name}_pages"]),
                                           _t(sc), kv_dtype).numpy()
            jdeq = np.asarray(jpaged.dequantize_entries(
                jnp.asarray(want[f"{name}_pages"]), jnp.asarray(jsc),
                kv_dtype))
            assert np.all(np.abs(deq - jdeq)
                          <= np.maximum(sc, jsc)[..., None])
        for i in range(2):
            alloc.append(i, int(1 + gates[1:, i].sum()), nA)
        t = t + 1
    assert 0.0 < gates.mean() < 1.0


def test_port_paged_decode_matches_port_dense(setup):
    """The reference's own contract: paged decode equals dense decode —
    greedy tokens and gates exactly, logits ≤ 1e-4·max."""
    _, params, lens, prompts, _ = setup
    nA, max_len = CFG.num_layers, 32
    P, ps = 64, 8
    dense = [{"k": torch.zeros(2, max_len, CFG.num_kv_heads,
                               CFG.resolved_head_dim),
              "v": torch.zeros(2, max_len, CFG.num_kv_heads,
                               CFG.resolved_head_dim)} for _ in range(nA)]
    store = paged.init_store(CFG, P, ps, device="cpu")
    alloc = paged.PageAllocator(P, ps, 2, slot_entry_capacity=max_len * nA)
    toks = []
    for i, p in enumerate(prompts):
        lg, c, st = pmodel.prefill(params, _t(p[None]).long(), CFG,
                                   pad_to=max_len)
        for a in range(nA):
            dense[a]["k"][i] = c[a]["k"][0]
            dense[a]["v"][i] = c[a]["v"][0]
        g = st["attn_gate"][:, 0]
        n = paged.prefill_entry_count(g.numpy(), lens[i], True)
        assert alloc.ensure(i, n + nA)
        paged.pack_prefill(store, c, g, lens[i], _t(alloc.block_table[i]),
                           CFG)
        alloc.append(i, n, nA * lens[i])
        toks.append(int(lg[0].argmax()))
    t = torch.tensor(lens, dtype=torch.int32)
    tok = torch.tensor(toks)
    for _ in range(4):
        lg_d, dense, sd = pmodel.decode_step(params, dense, tok[:, None], t,
                                             CFG)
        for i in range(2):
            assert alloc.ensure(i, int(alloc.fill[i]) + nA)
        lg_p, store, sp = pmodel.paged_decode_step(
            params, store, tok[:, None], t, _t(alloc.block_table),
            _t(alloc.fill), CFG)
        g = sp["attn_gate"].numpy()
        for i in range(2):
            alloc.append(i, int(1 + g[1:, i].sum()), nA)
        np.testing.assert_array_equal(g, sd["attn_gate"].numpy())
        np.testing.assert_array_equal(lg_p.argmax(-1).numpy(),
                                      lg_d.argmax(-1).numpy())
        _close(lg_p.numpy(), lg_d.numpy())
        tok = lg_d.argmax(-1)
        t = t + 1
    assert 0.0 < alloc.saved_fraction < 1.0


def test_paged_wrapper_raises_instead_of_falling_back():
    """A tensor on neither the CPU nor CUDA takes no plain version: the
    kernel path raises, and nothing is counted as a launch."""
    from repro_torch.kernels import paged_attention as pa
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention(
            torch.empty(2, 1, 2, 32, **meta),
            torch.empty(4, 4, 1, 32, **meta), torch.empty(4, 4, 1, 32, **meta),
            torch.zeros(2, 2, dtype=torch.int32, **meta),
            torch.zeros(2, 8, dtype=torch.int32, **meta),
            torch.empty(2, 1, 1, 32, **meta), torch.empty(2, 1, 1, 32, **meta),
            torch.zeros(2, 1, dtype=torch.int32, **meta), scale=1.0)
    assert pa.launches == 0
    assert ops.kernel_launches()["paged_attention"] == 0
