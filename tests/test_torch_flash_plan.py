"""Flash attention's plan (``flash_attention.plan``), the walk its grids
make, the plain version's positions read in place, and ``chip_smoke.py``'s
mirror of the bf16 routes' rounding, on the CPU.

``plan`` is the one place that decides a call's route, tiles, split, grid
and shared memory; the C entries of ``csrc/flash_attention.cu`` launch
exactly that and refuse a plan they have no instantiation of
(``chip_smoke.py``'s ragged phase checks the refusals on the card).  Here
its choices are held against values worked out by hand at the llama2-7b
shapes of the main path (lock-step prefill R 512 over B·Hkv 128, the
continuous buckets R 256/512 at B·Hkv 32, decode R 1 against a 544-row
cache, 16-row prefills), and the grids are walked as the kernels walk them
to check that every packed row and every key below a row tile's causal
limit is covered exactly once.

Tolerances: the mirror (P rounded to bf16 against an integer row maximum,
as the bf16 routes round it) within 2^-7·max|ref| (``TOL_BF16``) of the
exact plain version and of the JAX package's Pallas kernel in interpret
mode; the plain version on unpacked positions equal to the packed oracle
bit for bit, and within 1e-6·max|ref| of the dense oracle (fp32 sums in
another order)."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_packed
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

torch.set_num_threads(2)

_BF, _F32 = torch.bfloat16, torch.float32

# (B·Hkv, R, Tk) of the main path: lock-step prefill, the continuous
# buckets at B 1, decode against the 544-row cache, 16-row prefills.
_SHAPES = {"prefill": (128, 512, 512), "bucket512": (32, 512, 512),
           "bucket256": (32, 256, 256), "decode": (128, 1, 544),
           "prefill16": (32, 16, 16)}

# (shape, dtype) -> (route, tile_r, tile_k, splits, kc, grid), worked out
# by hand from the rules in plan's docstring: the tile's items are 128
# rows of one (b, kv-head) and its persistent blocks number min(items,
# 132); the split-KV walk splits Tk into about two blocks per SM (256 /
# B·Hkv), at most 8, at least 64 keys each, kc a multiple of 16; the SIMT
# kernel 16 rows per block.
_EXPECTED = {
    ("prefill", _BF): ("wgmma", 128, 128, 1, 0, (132, 1)),
    ("bucket512", _BF): ("wgmma", 128, 128, 1, 0, (128, 1)),
    ("bucket256", _BF): ("wgmma", 128, 128, 1, 0, (64, 1)),
    ("decode", _BF): ("splitkv", 16, 64, 2, 272, (2, 128)),
    ("prefill16", _BF): ("splitkv", 16, 64, 1, 16, (1, 32)),
    ("prefill", _F32): ("simt", 16, 32, 1, 0, (32, 128)),
    ("bucket512", _F32): ("simt", 16, 32, 1, 0, (32, 32)),
    ("bucket256", _F32): ("simt", 16, 32, 1, 0, (16, 32)),
    ("decode", _F32): ("simt", 16, 32, 1, 0, (1, 128)),
    ("prefill16", _F32): ("simt", 16, 32, 1, 0, (1, 32)),
}
# Dynamic shared memory by route and head dim: the tile's two Q buffers
# (128 rows) and 2 stages of K and V (128 keys), rows of dh rounded up to
# whole 64 (dh 80: 128, its last 48 columns TMA's zero fill), 10 barriers
# and 1 KB of alignment; the split-KV walk's Q (16 rows) and 2 stages of
# K and V (64 keys), rows of dh + 8; none for SIMT (dh 80: K [32][161], V
# [32][80], Q [16][80] fp32 and 16 positions, 25792 B of static memory).
_SMEM = {("wgmma", 128): 197712, ("wgmma", 64): 99408,
         ("wgmma", 32): 99408, ("wgmma", 80): 197712,
         ("splitkv", 128): 73984, ("splitkv", 64): 39168,
         ("splitkv", 32): 21760, ("splitkv", 80): 47872,
         ("simt", 128): 0, ("simt", 64): 0, ("simt", 32): 0,
         ("simt", 80): 0}


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("key", list(_EXPECTED),
                         ids=lambda k: f"{k[0]}-{str(k[1])[6:]}")
def test_plan_matches_hand_worked_values(key, dh):
    name, dtype = key
    p = fa.plan(*_SHAPES[name], dh, dtype)
    assert (p.route, p.tile_r, p.tile_k, p.splits, p.kc, p.grid) == \
        _EXPECTED[key]
    assert p.smem == _SMEM[(p.route, dh)]


@pytest.mark.parametrize("key", list(_EXPECTED),
                         ids=lambda k: f"{k[0]}-{str(k[1])[6:]}")
def test_plan_dh80_matches_hand_worked_values(key):
    """stablelm-3b's head dim 80 at the main path's shapes: the same
    routes, tiles, splits and grids as at dh 128 (the rows are padded to
    128 on the tile), with its own shared memory."""
    name, dtype = key
    p = fa.plan(*_SHAPES[name], 80, dtype)
    assert (p.route, p.tile_r, p.tile_k, p.splits, p.kc, p.grid) == \
        _EXPECTED[key]
    assert p.smem == _SMEM[(p.route, 80)]


# deepseek-coder-33b (56 heads over 8 kv heads: G 7, dh 128): lock-step
# prefill 4 × 512 (R 3584 over B·Hkv 32: 28 row tiles each, 896 items),
# decode (R 7: 8 splits wanted, kc = ⌈544 / 8 / 16⌉·16 = 80, so 7 splits),
# a verify window of 5 columns (R 35), a 2-token prefill (R 14).  By hand
# as _EXPECTED.
_SHAPES_G7 = {"prefill": (32, 3584, 512), "decode": (32, 7, 544),
              "verify": (32, 35, 544), "prefill2": (8, 14, 2)}
_EXPECTED_G7 = {
    "prefill": ("wgmma", 128, 128, 1, 0, (132, 1)),
    "decode": ("splitkv", 16, 64, 7, 80, (7, 32)),
    "verify": ("wgmma", 128, 128, 1, 0, (32, 1)),
    "prefill2": ("splitkv", 16, 64, 1, 16, (1, 8)),
}


@pytest.mark.parametrize("name", list(_EXPECTED_G7))
def test_plan_g7_matches_hand_worked_values(name):
    p = fa.plan(*_SHAPES_G7[name], 128, _BF)
    assert (p.route, p.tile_r, p.tile_k, p.splits, p.kc, p.grid) == \
        _EXPECTED_G7[name]
    _walk(*_SHAPES_G7[name], 128, _BF, balance=False)


# grok-1-314b (48 heads over 8 kv heads: G 6, dh 128): lock-step prefill
# 4 × 512 (R 3072 over B·Hkv 32: 24 row tiles each, 768 items), decode (R
# 6: 8 splits wanted, kc = ⌈544 / 8 / 16⌉·16 = 80, so 7 splits), a verify
# window of 5 columns (R 30), a 2-token prefill (R 12).  By hand as
# _EXPECTED; the same tiles and splits as G 7's.
_SHAPES_G6 = {"prefill": (32, 3072, 512), "decode": (32, 6, 544),
              "verify": (32, 30, 544), "prefill2": (8, 12, 2)}
_EXPECTED_G6 = {
    "prefill": ("wgmma", 128, 128, 1, 0, (132, 1)),
    "decode": ("splitkv", 16, 64, 7, 80, (7, 32)),
    "verify": ("wgmma", 128, 128, 1, 0, (32, 1)),
    "prefill2": ("splitkv", 16, 64, 1, 16, (1, 8)),
}


@pytest.mark.parametrize("name", list(_EXPECTED_G6))
def test_plan_g6_matches_hand_worked_values(name):
    p = fa.plan(*_SHAPES_G6[name], 128, _BF)
    assert (p.route, p.tile_r, p.tile_k, p.splits, p.kc, p.grid) == \
        _EXPECTED_G6[name]
    assert p.smem == _SMEM[(p.route, 128)]
    _walk(*_SHAPES_G6[name], 128, _BF, balance=False)


# gemma3-12b (16 heads over 8 kv heads, dh 256, window 1024): lock-step
# prefill 2 × 1536 (R = G·T 3072 over B·Hkv 16), a dense-pool prefill of
# one 1000-token prompt, decode of 4 slots over a LOCAL layer's ring of
# 1024 keys and a global layer's 1600-row cache, a 4-token prefill.
_SHAPES_256 = {"prefill": (16, 3072, 1536), "prompt1000": (8, 2000, 1000),
               "ring": (32, 2, 1024), "global": (32, 2, 1600),
               "prefill4": (8, 8, 4)}
# Worked out by hand as _EXPECTED, with the tile's 64-key tiles at dh 256;
# the SIMT kernel's 82112 bytes (K [32][257], V [32][256], Q [16][256]
# fp32 and 16 positions) are dynamic, past the 48 KB static limit.
_EXPECTED_256 = {
    ("prefill", _BF): ("wgmma", 128, 64, 1, 0, (132, 1), 197712),
    ("prompt1000", _BF): ("wgmma", 128, 64, 1, 0, (128, 1), 197712),
    ("ring", _BF): ("splitkv", 16, 64, 8, 128, (8, 32), 143616),
    ("global", _BF): ("splitkv", 16, 64, 8, 208, (8, 32), 143616),
    ("prefill4", _BF): ("splitkv", 16, 64, 1, 16, (1, 8), 143616),
    ("prefill", _F32): ("simt", 16, 32, 1, 0, (192, 16), 82112),
    ("ring", _F32): ("simt", 16, 32, 1, 0, (1, 32), 82112),
}
# the tile's static shared memory beside its dynamic: positions [2][128]
# and the items' ranges [2][5], int32
_WG_STATIC = (2 * 128 + 2 * 5) * 4


@pytest.mark.parametrize("key", list(_EXPECTED_256),
                         ids=lambda k: f"{k[0]}-{str(k[1])[6:]}")
def test_plan_dh256_matches_hand_worked_values(key):
    name, dtype = key
    p = fa.plan(*_SHAPES_256[name], 256, dtype)
    assert (p.route, p.tile_r, p.tile_k, p.splits, p.kc, p.grid, p.smem) \
        == _EXPECTED_256[key]


@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
def test_every_plan_fits_shared_memory(dh):
    """Every route's shared memory fits a block of the H100: 227 KB of
    dynamic shared memory (the tile's static positions beside it), and the
    SIMT tile 48 KB of static or 227 KB of dynamic."""
    for BH, R, Tk in _WALKS + list(_SHAPES_256.values()):
        for dt in (_BF, _F32):
            p = fa.plan(BH, R, Tk, dh, dt)
            static = _WG_STATIC if p.route == "wgmma" else 0
            assert p.smem + static <= fa.SMEM_MAX
            if p.route == "simt":
                tile = (32 * (2 * dh + 1) + 16 * dh) * 4 + 16 * 4
                assert p.smem == (0 if tile <= fa.SIMT_STATIC_MAX else tile)
                assert p.smem == (82112 if dh == 256 else 0)


_PINNED = {  # today's dh 32/64/128 plans, pinned: (route, tile_k, smem)
    (32, _BF, 3072): ("wgmma", 128, 99408),
    (64, _BF, 3072): ("wgmma", 128, 99408),
    (128, _BF, 3072): ("wgmma", 128, 197712),
    (32, _BF, 2): ("splitkv", 64, 21760),
    (64, _BF, 2): ("splitkv", 64, 39168),
    (128, _BF, 2): ("splitkv", 64, 73984)}


@pytest.mark.parametrize("dh,dt,R", list(_PINNED),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_earlier_head_dims_unchanged(dh, dt, R):
    p = fa.plan(16, R, 1536, dh, dt)
    assert (p.route, p.tile_k, p.smem) == _PINNED[(dh, dt, R)]
    assert fa.plan(16, R, 1536, dh, _F32).smem == 0


def _items(p: fa.Plan, BH: int, R: int):
    """The tile's work items as its blocks walk them (``wg_item`` in the
    source): block x takes item j·P + x in even rounds and j·P + P-1-x in
    odd ones; item w is row tile nrt-1-w%nrt of (b, kv-head) w / nrt."""
    P, nrt = p.grid[0], -(-R // p.tile_r)
    for x in range(P):
        j = 0
        while True:
            w = j * P + (P - 1 - x if j & 1 else x)
            if w >= BH * nrt:
                break
            yield x, w // nrt, (nrt - 1 - w % nrt) * p.tile_r
            j += 1


_WALKS = [(128, 512, 512), (32, 512, 512), (32, 256, 256), (4, 80, 70),
          (8, 37, 37), (300, 130, 130), (128, 1, 544), (32, 16, 16),
          (8, 1, 544), (6, 4, 50), (3, 16, 1000), (2, 1, 5)]


@pytest.mark.parametrize("dtype", [_BF, _F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("BH,R,Tk", _WALKS)
def test_grid_covers_every_row_and_key_once(BH, R, Tk, dtype):
    _walk(BH, R, Tk, 64, dtype)


@pytest.mark.parametrize("dtype", [_BF, _F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("BH,R,Tk", list(_SHAPES_256.values()))
def test_grid_covers_every_row_and_key_once_dh256(BH, R, Tk, dtype):
    """The walk at gemma3's shapes and dh 256: the tile's 64-key tiles."""
    _walk(BH, R, Tk, 256, dtype)


def _walk(BH, R, Tk, dh, dtype, balance=True):
    """Walked as the kernels walk it, the plan's grid covers each packed
    row of each (b, kv-head) once, and each key below a causal limit once:
    the tile and the SIMT kernel walk a row tile's keys [0, limit) in
    whole tiles; the split-KV clusters cut [0, Tk) into kc-key splits, none
    of them empty.  ``balance``: the tile's blocks share square causal
    work evenly (not so for G > 1, whose packed rows repeat the keys)."""
    p = fa.plan(BH, R, Tk, dh, dtype)
    rows = np.zeros((BH, R), np.int64)
    if p.route == "wgmma":
        seen = list(_items(p, BH, R))
        assert p.grid[1] == 1 and p.grid[0] <= fa.WG_MAX_BLOCKS
        assert {x for x, _, _ in seen} == set(range(p.grid[0]))
        for _, bh, r0 in seen:
            rows[bh, r0:r0 + p.tile_r] += 1
        # balance: over square causal items (row tile t walks t + 1 key
        # tiles) no block does more than one item above the mean
        work = np.zeros(p.grid[0])
        for x, _, r0 in seen:
            work[x] += r0 // p.tile_r + 1
        assert not balance or \
            work.max() <= work.sum() / p.grid[0] + -(-R // p.tile_r)
    else:
        tiles = p.grid[0] if p.route == "simt" else 1
        assert p.grid[1] == BH
        for t in range(tiles):
            rows[:, t * p.tile_r:(t + 1) * p.tile_r] += 1
        assert p.tile_r >= (R if p.route == "splitkv" else 1)
    assert (rows == 1).all()
    if p.route == "splitkv":
        assert R <= fa.SPLITKV_MAX_R and p.kc % fa.SKV_SPLIT_STEP == 0
        assert 1 <= p.splits <= fa.SKV_MAX_SPLITS
        assert p.grid == (p.splits, BH)
        keys = np.zeros(Tk, np.int64)
        for s in range(p.splits):
            lo = s * p.kc
            assert lo < Tk                       # no empty split
            keys[lo:min(Tk, lo + p.kc)] += 1
        assert (keys == 1).all()
    else:
        for limit in sorted({1, Tk // 2, Tk}):
            keys = np.zeros(Tk, np.int64)
            for t in range(-(-limit // p.tile_k)):
                keys[t * p.tile_k:(t + 1) * p.tile_k] += 1
            assert (keys[:limit] == 1).all()


@pytest.mark.parametrize("dtype", [_BF, _F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", chip_smoke.FLASH_RAGGED
                         + chip_smoke.FLASH_RAGGED_19
                         + chip_smoke.FLASH_RAGGED_20,
                         ids=lambda c: "-".join(map(str, c)))
def test_ragged_cases_plan_and_walk(case, dtype):
    """chip_smoke's ragged flash cases, dh 256, dh 80, G 7 and G 6 among
    them (phases 3, 19 and 20): bf16 takes the
    tile where G·Tq > 16 and the split-KV walk otherwise, fp32 the SIMT
    kernel, and each plan's grid covers every row and key once."""
    B, Tq, Tk, Hq, Hkv, dh, _, _ = case
    R = Hq // Hkv * Tq
    route = fa.plan(B * Hkv, R, Tk, dh, dtype).route
    assert route == ("simt" if dtype == _F32 else
                     "wgmma" if R > fa.SPLITKV_MAX_R else "splitkv")
    _walk(B * Hkv, R, Tk, dh, dtype)


@pytest.mark.parametrize("R", [1, 4, 16, 17, 24, 37, 512])
def test_plan_routes_by_dtype_and_rows(R):
    for BH, Tk in ((1, 16), (32, 544), (128, 512)):
        want = "splitkv" if R <= fa.SPLITKV_MAX_R else "wgmma"
        assert fa.plan(BH, R, Tk, 128, _BF).route == want
        assert fa.plan(BH, R, Tk, 128, _F32).route == "simt"
    with pytest.raises(ValueError):
        fa.plan(1, R, 16, 128, torch.float16)
    with pytest.raises(ValueError):
        fa.plan(1, R, 16, 96, _BF)


def test_strides_of_size_one_dims():
    """The kernels and the tensor maps take any stride on a size-1 dim;
    ``_strides`` replaces torch's by the extent inside it, so a decode q
    [B, 1, Hq, dh] or a one-sequence cache gives strides in whole rows."""
    q = torch.empty(4, 1, 8, 64)[:, :, :, :]
    assert fa._strides(q, 3) == [512, 512, 64]
    k = torch.empty(1, 10, 1, 32)
    assert fa._strides(k, 3) == [320, 32, 32]
    qkv = torch.empty(2, 5, 3 * 4 * 16)        # a q | k | v projection
    v = qkv[..., 2 * 64:].reshape(2, 5, 4, 16)
    assert fa._strides(v, 3) == [5 * 192, 192, 16]


def _case(B, Tq, Tk, Hq, Hkv, dh, kind, seed):
    """Seeded bf16 q, k, v and int32 positions: "prefill" 0..Tq-1 as the
    model's expanded arange (kv_len None), "pads" the same with kv_len
    Tk - 3b and the last 3 rows of batch 1 at -1, "decode" at kv_len - 1."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(_BF) for s in ((B, Tq, Hq, dh), (B, Tk, Hkv, dh),
                                  (B, Tk, Hkv, dh)))
    if kind == "decode":
        kvl = torch.from_numpy(rng.integers(1, Tk + 1, B).astype(np.int32))
        return q, k, v, kvl[:, None] - 1, kvl
    pos = torch.arange(Tq, dtype=torch.int32)[None].expand(B, Tq)
    if kind == "prefill":
        return q, k, v, pos, None
    pos = pos.clone()
    pos[1, -3:] = -1
    kvl = torch.tensor([Tk - 3 * b for b in range(B)], dtype=torch.int32)
    return q, k, v, pos, kvl


_MIRROR = [(2, 24, 24, 4, 2, 32, 0, "prefill"),
           (2, 24, 24, 4, 4, 64, 8, "prefill"),
           (2, 20, 20, 6, 2, 32, 0, "pads"),
           (3, 1, 40, 8, 2, 64, 0, "decode"),
           (2, 20, 20, 4, 4, 80, 0, "pads"),
           (3, 1, 40, 14, 2, 80, 0, "decode")]


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,dh,window,kind", _MIRROR)
def test_mirror_within_bf16_tolerance(B, Tq, Tk, Hq, Hkv, dh, window, kind):
    """chip_smoke's mirror of the bf16 routes (P rounded to bf16 against an
    integer row maximum, l in fp32) stays within TOL_BF16·max|ref| of the
    exact plain version and of the Pallas kernel in interpret mode, pad
    rows zero in both the mirror and the plain version."""
    q, k, v, pos, kvl = _case(B, Tq, Tk, Hq, Hkv, dh, kind, seed=Tq + dh)
    s = 1.0 / np.sqrt(dh)
    kw = dict(window=window, scale=s)
    mo = chip_smoke.flash_mirror(torch, q, k, v, pos, kvl, **kw)
    assert mo.dtype == _F32 and mo.shape == q.shape
    ro = fa.flash_attention_plain(q, k, v, pos, kvl, **kw).float()
    tol = chip_smoke.TOL_BF16 * ro.abs().max().item()
    assert (mo - ro).abs().max().item() <= tol
    G = Hq // Hkv
    qp, kp, vp, jpos, jlen, _ = jops._pack_heads(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), jnp.asarray(pos.numpy()),
        None if kvl is None else jnp.asarray(kvl.numpy()))
    jo = np.asarray(flash_attention_packed(
        qp, kp, vp, jpos, jlen, window=window, scale=s,
        interpret=True).astype(jnp.float32))
    mp = mo.reshape(B, Tq, Hkv, G, dh).permute(0, 2, 3, 1, 4).reshape(
        B * Hkv, G * Tq, dh).numpy()
    valid = np.asarray(jpos) >= 0           # the kernel leaves pad rows
    assert np.abs(mp - jo)[valid].max() <= tol
    if kind == "pads":
        assert (mo[1, -3:] == 0).all() and (ro[1, -3:] == 0).all()


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,dh,window,kind", _MIRROR)
def test_plain_version_reads_positions_unpacked(B, Tq, Tk, Hq, Hkv, dh,
                                                window, kind):
    """The plain version on [B, Tq] positions and a [B] kv_len (or None)
    equals pack_positions + the packed oracle bit for bit, and the dense
    oracle within 1e-6·max in fp32."""
    q, k, v, pos, kvl = _case(B, Tq, Tk, Hq, Hkv, dh, kind, seed=Tk + dh)
    q, k, v = q.float(), k.float(), v.float()
    s = 1.0 / np.sqrt(dh)
    out = fa.flash_attention_plain(q, k, v, pos, kvl, window=window, scale=s)
    ppos, plen = fa.pack_positions(pos, kvl, B, Hkv, Hq // Hkv, Tk)
    assert ppos.shape == (B * Hkv, Hq // Hkv * Tq) and plen.shape == (B * Hkv,)
    po = ref.flash_attention_packed_ref(*fa.pack_qkv(q, k, v), ppos, plen,
                                        window=window, scale=s)
    po = (po.reshape(B, Hkv, Hq // Hkv, Tq, dh).permute(0, 3, 1, 2, 4)
          .reshape(B, Tq, Hq, dh))
    assert torch.equal(out, po)
    do = ref.flash_attention_ref(q, k, v, q_positions=pos, window=window,
                                 kv_valid_len=kvl, softmax_scale=s)
    assert (out - do).abs().max() <= 1e-6 * do.abs().max()
