"""Paged attention's plan (``paged_attention.plan``), the head groups and
splits its grids make, and the split walk's rule for which admitted entries
each block of a cluster takes, on the CPU.

``plan`` is the one place that decides a call's route, kv-heads per block,
blocks per cluster, ring and shared memory; the C entries of
``csrc/paged_attention.cu`` launch exactly that and refuse a plan they
have no instantiation of (``chip_smoke.py``'s ragged phase checks the
refusals on the card).  Here its choices are held against values worked
out by hand at the llama2-7b decode shape of the main path and at
``chip_smoke.py``'s ragged shapes; the grids are walked as the kernels walk
them (every kv-head of every slot in exactly one block group, Hkv 3 and 6
included); ``split_bounds`` and a step-for-step mirror of the split walk's
scan (counts per slice, the first slice of a block's share, rounds of
listed rows, chunks rescanned when a round fills) cover every admitted
entry exactly once, in order.  Everything here is exact (integers)."""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

_BF, _F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 227 * 1024      # what the blocks on one SM may share

# The main path's paged decode: B 4 slots, 32 kv-heads, G 1, dh 128, a
# 1024-page chain of 16 entries.  By hand: 4 kv-heads a block give 4 · 8
# groups · 8 blocks = 256 blocks (SPLIT_BLOCKS), so S = 8, and a step of
# 64 / 4 = 16 entries.  A bf16 ring stage is K and V of 16 entries, rows
# 4·128 + 8 bf16 wide: 2·16·520·2 = 33280 B; with the 4096 B list, 2
# stages (70656 B) fit 74752, 3 do not.  An int8 stage is 2·16·4·(128 + 4)
# = 16896 B beside the warps' bf16 tiles, 4·16·136·2 = 17408 B: 3 stages,
# 72192 B; int4 2·16·4·(64 + 4) = 8704 B: 4 stages (the most), 56320 B.
# fp32 q: the SIMT kernel, one row a block.
_FULL = (4, 32, 1, 128, 16384)
_EXPECTED_FULL = {
    (None, _BF): ("split", 16, 4, 8, 16, 2, (8, 32), 70656),
    ("int8", _BF): ("split", 16, 4, 8, 16, 3, (8, 32), 72192),
    ("int4", _BF): ("split", 16, 4, 8, 16, 4, (8, 32), 56320),
    ("int8", _F32): ("simt", 1, 1, 1, 8, 0, (128, 1), 0),
    ("int4", _F32): ("simt", 1, 1, 1, 8, 0, (128, 1), 0),
}

# chip_smoke.PAGED_RAGGED in bf16 q: (route, heads, splits, stages for
# bf16 / int8 / int4 pages, grid, shared memory for each).  By hand: S is
# the most of 8 and ⌈E / 256⌉ that 256 blocks need; heads halve from
# min(4, Hkv) while B · ⌈Hkv/heads⌉ · S < 256 (so only B 16 keeps more
# than one); a step holds 64 / heads entries; the ring takes the most
# stages (2-4) within 74752 B of 4096 B list plus stages of 2·(64/heads)·
# (heads·dh + 8)·2 B (bf16) or 2·64·(row + 4) B beside 4·16·(dh + 8)·2 B
# of warp tiles (int8, int4).  G 32 takes the SIMT kernel.
_EXPECTED_RAGGED = [
    ("split", 1, 1, (3, 4, 4), (1, 6), (59392, 48128, 31744)),
    ("split", 1, 1, (4, 4, 4), (1, 2), (45056, 27648, 19456)),
    ("split", 1, 1, (3, 4, 4), (1, 4), (59392, 48128, 31744)),
    ("split", 1, 1, (4, 4, 4), (1, 3), (45056, 27648, 19456)),
    ("split", 1, 3, (2, 3, 4), (3, 4), (73728, 72192, 56320)),
    ("split", 1, 4, (3, 4, 4), (4, 2), (59392, 48128, 31744)),
    ("split", 4, 8, (4, 4, 4), (8, 32), (71680, 48128, 31744)),
    ("split", 2, 8, (4, 4, 4), (8, 32), (40960, 27648, 19456)),
    ("split", 1, 8, (2, 3, 4), (8, 2), (73728, 72192, 56320)),
    ("split", 1, 8, (2, 3, 4), (8, 8), (73728, 72192, 56320)),
    ("split", 1, 8, (3, 4, 4), (8, 1), (59392, 48128, 31744)),
    ("simt", 1, 1, (0, 0, 0), (1, 8), (0, 0, 0)),
]


# Phase 19's full shapes.  stablelm-3b (B 4, 32 kv-heads, G 1, dh 80, the
# same 1024-page chain): 4 kv-heads a block and S 8 as at dh 128; a bf16
# stage is 2·16·(4·80 + 8)·2 = 20992 B, so 3 stages (67072 B) fit and 4
# do not; int8 2·64·(80 + 4) = 10752 B beside 4·16·88·2 = 11264 B of warp
# tiles: 4 stages, 58368 B; int4 2·64·(40 + 4) = 5632 B: 4 stages, 37888
# B.  deepseek-coder-33b (8 kv-heads, G 7, dh 128): 4 · 8 groups · 8 <
# 256 and 4 · 4 · 8 < 256, so one kv-head a block, S 8, steps of 64
# entries: bf16 2·64·136·2 = 34816 B a stage, 2 stages (73728 B); int8 3
# (72192 B); int4 4 (56320 B); fp32 q: the SIMT kernel, 4 query heads a
# block, 2 blocks a kv-head.
_FULL_19 = {"stablelm": (4, 32, 1, 80, 16384),
            "deepseek": (4, 8, 7, 128, 16384)}
_EXPECTED_19 = {
    ("stablelm", None, _BF): ("split", 16, 4, 8, 16, 3, (8, 32), 67072),
    ("stablelm", "int8", _BF): ("split", 16, 4, 8, 16, 4, (8, 32), 58368),
    ("stablelm", "int4", _BF): ("split", 16, 4, 8, 16, 4, (8, 32), 37888),
    ("stablelm", "int4", _F32): ("simt", 1, 1, 1, 8, 0, (128, 1), 0),
    ("deepseek", None, _BF): ("split", 16, 1, 8, 64, 2, (8, 32), 73728),
    ("deepseek", "int8", _BF): ("split", 16, 1, 8, 64, 3, (8, 32), 72192),
    ("deepseek", "int4", _BF): ("split", 16, 1, 8, 64, 4, (8, 32), 56320),
    ("deepseek", "int8", _F32): ("simt", 4, 1, 1, 8, 0, (32, 2), 0),
}


def _tuple(p):
    return (p.route, p.rows, p.heads, p.splits, p.tile, p.stages, p.grid,
            p.smem)


@pytest.mark.parametrize("key", list(_EXPECTED_FULL),
                         ids=lambda k: f"{k[0]}-{str(k[1])[6:]}")
def test_plan_full_shape_matches_hand_worked_values(key):
    kd, dt = key
    B, Hkv, G, dh, E = _FULL
    assert _tuple(pa.plan(B, Hkv, G, dh, E, kd, dt)) == _EXPECTED_FULL[key]


def test_plan_ragged_shapes_match_hand_worked_values():
    assert len(chip_smoke.PAGED_RAGGED) == len(_EXPECTED_RAGGED)
    for case, want in zip(chip_smoke.PAGED_RAGGED, _EXPECTED_RAGGED):
        B, Hkv, G, dh, ps, J, _ = case
        route, heads, splits, stages, grid, smem = want
        for kd, st, sm in zip((None, "int8", "int4"), stages, smem):
            p = pa.plan(B, Hkv, G, dh, J * ps, kd, _BF)
            assert (p.route, p.heads, p.splits, p.stages, p.grid,
                    p.smem) == (route, heads, splits, st, grid, sm), case
            # fp32 q: always the SIMT kernel
            assert pa.plan(B, Hkv, G, dh, J * ps, kd, _F32).route == "simt"


@pytest.mark.parametrize("key", list(_EXPECTED_19),
                         ids=lambda k: f"{k[0]}-{k[1]}-{str(k[2])[6:]}")
def test_plan_phase19_shapes_match_hand_worked_values(key):
    name, kd, dt = key
    B, Hkv, G, dh, E = _FULL_19[name]
    assert _tuple(pa.plan(B, Hkv, G, dh, E, kd, dt)) == _EXPECTED_19[key]


@pytest.mark.parametrize("case", chip_smoke.PAGED_RAGGED_19,
                         ids=lambda c: "-".join(map(str, c)))
def test_ragged_19_cases_plan(case):
    """chip_smoke's dh 80 and G 7 ragged paged cases (phase 19): bf16 q on
    the split walk up to G 16, fp32 on the SIMT kernel; every kv-head in
    one block group; the two B 16 cases group 4 and 2 kv-heads, so odd
    heads (int4 rows at 8-byte offsets) share a block, in a last group
    short of live heads; shared memory within three blocks an SM."""
    B, Hkv, G, dh, ps, J, _ = case
    for kd in (None, "int8", "int4"):
        p = pa.plan(B, Hkv, G, dh, J * ps, kd, _BF)
        assert p.route == ("split" if G <= pa.SPLIT_MAX_G else "simt")
        assert pa.plan(B, Hkv, G, dh, J * ps, kd, _F32).route == "simt"
        if p.route == "split":
            groups = -(-Hkv // p.heads)
            assert p.grid == (p.splits, B * groups)
            assert p.smem <= pa.SPLIT_SMEM and 3 * p.smem <= SMEM_PER_SM
            if (B, Hkv) in ((16, 6), (16, 3)):
                assert p.heads == (4 if Hkv == 6 else 2)
                assert Hkv % p.heads and p.splits == 8
    assert pa.row_bytes("int4", 80) == 40 and 40 % 16 == 8


# Phase 20's full shapes.  grok-1-314b (B 4 slots, 8 kv-heads, G 6, dh
# 128, the same 1024-page chain) groups as deepseek's G 7 above: 4 · 2 · 8
# and 4 · 4 · 8 blocks fall short of 256, so one kv-head a block, S 8,
# steps of 64 entries, 2 / 3 / 4 stages (73728 / 72192 / 56320 B); fp32 q:
# the SIMT kernel, 4 query heads a block, so ⌈6 / 4⌉ = 2 blocks a kv-head.
# arctic-480b's G 7 at the same shape: deepseek's plan.
_FULL_20 = {"grok": (4, 8, 6, 128, 16384), "arctic": (4, 8, 7, 128, 16384)}
_EXPECTED_20 = {
    ("grok", None, _BF): ("split", 16, 1, 8, 64, 2, (8, 32), 73728),
    ("grok", "int8", _BF): ("split", 16, 1, 8, 64, 3, (8, 32), 72192),
    ("grok", "int4", _BF): ("split", 16, 1, 8, 64, 4, (8, 32), 56320),
    ("grok", None, _F32): ("simt", 4, 1, 1, 8, 0, (32, 2), 0),
    ("arctic", "int8", _BF): ("split", 16, 1, 8, 64, 3, (8, 32), 72192),
}


@pytest.mark.parametrize("key", list(_EXPECTED_20),
                         ids=lambda k: f"{k[0]}-{k[1]}-{str(k[2])[6:]}")
def test_plan_phase20_shapes_match_hand_worked_values(key):
    name, kd, dt = key
    B, Hkv, G, dh, E = _FULL_20[name]
    assert _tuple(pa.plan(B, Hkv, G, dh, E, kd, dt)) == _EXPECTED_20[key]


# chip_smoke.PAGED_RAGGED_20 in bf16 q, by hand as _EXPECTED_RAGGED:
# (heads, splits, grid); the ring's stages and shared memory follow the
# kv-heads a block as above.
_EXPECTED_RAGGED_20 = [
    (1, 4, (4, 32)), (1, 4, (4, 4)), (4, 8, (8, 32)), (2, 8, (8, 32)),
    (1, 3, (3, 1)), (1, 1, (1, 2)), (1, 1, (1, 3)), (1, 1, (1, 4)),
    (1, 8, (8, 2)), (1, 4, (4, 32)),
]


@pytest.mark.parametrize("case,want", list(zip(chip_smoke.PAGED_RAGGED_20,
                                               _EXPECTED_RAGGED_20)),
                         ids=lambda c: "-".join(map(str, c)))
def test_ragged_20_cases_plan(case, want):
    """chip_smoke's G 6 (and arctic's G 7) ragged paged cases (phase 20):
    bf16 q on the split walk with the hand-worked groups and splits, fp32
    on the SIMT kernel with ⌈G / 4⌉ blocks a kv-head; every kv-head in one
    block group; shared memory within three blocks an SM."""
    B, Hkv, G, dh, ps, J, _ = case
    for kd in (None, "int8", "int4"):
        p = pa.plan(B, Hkv, G, dh, J * ps, kd, _BF)
        assert p.route == "split" and (p.heads, p.splits, p.grid) == want
        assert p.grid == (p.splits, B * -(-Hkv // p.heads))
        assert p.smem <= pa.SPLIT_SMEM and 3 * p.smem <= SMEM_PER_SM
        f = pa.plan(B, Hkv, G, dh, J * ps, kd, _F32)
        assert f.route == "simt" and f.grid == (B * Hkv, -(-G // f.rows))
    assert len(chip_smoke.PAGED_RAGGED_20) == len(_EXPECTED_RAGGED_20)


@pytest.mark.parametrize("G", [1, 2, 8, 16, 17, 32])
def test_routes_by_dtype_and_g(G):
    for kd in (None, "int8", "int4"):
        want = "split" if G <= pa.SPLIT_MAX_G else "simt"
        assert pa.plan(4, 8, G, 128, 4096, kd, _BF).route == want
        p = pa.plan(4, 8, G, 128, 4096, kd, _F32)
        assert p.route == "simt"
        assert p.grid == (32, -(-G // p.rows))
    with pytest.raises(ValueError):
        pa.plan(4, 8, G, 96, 4096, None, _BF)        # no such head dim
    with pytest.raises(ValueError):
        pa.plan(4, 8, G, 128, 4096, "int2", _BF)


_SWEEP = [(B, Hkv, E) for B in (1, 2, 4, 16, 64) for Hkv in (1, 3, 6, 8, 32)
          for E in (0, 12, 45, 640, 2048, 16384)]


def test_head_groups_cover_every_kv_head_once():
    for B, Hkv, E in _SWEEP:
        p = pa.plan(B, Hkv, 1, 128, E, None, _BF)
        assert p.grid[0] == p.splits and 1 <= p.splits <= pa.SPLIT_MAX_S
        assert p.heads in (1, 2, 4) and p.heads <= max(Hkv, 1)
        groups = -(-Hkv // p.heads)
        seen = []
        for y in range(p.grid[1]):              # as paged_split reads it
            b, h0 = y // groups, (y % groups) * p.heads
            hl = min(p.heads, Hkv - h0)
            assert hl >= 1
            seen += [(b, h0 + j) for j in range(hl)]
        assert sorted(seen) == [(b, h) for b in range(B) for h in range(Hkv)]
    # Hkv 3 and 6 in groups that do not divide them (chip_smoke's B 16)
    assert pa.plan(16, 3, 1, 32, 2048, None, _BF).heads == 2
    assert pa.plan(16, 6, 2, 64, 2048, None, _BF).heads == 4


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 2, 3, 8, 9830])
def test_split_bounds_cover_each_admitted_index_once(n, S):
    bounds = pa.split_bounds(n, S)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    sizes = [b - a for a, b in bounds]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    assert sum(sizes) == n


def _walk_rows(ep, qp, S, rank, slice_cap):
    """The entries block ``rank`` of S lists, mirroring paged_split step
    for step: windows of S slices of ``split_slice`` entries (at most
    ``slice_cap``); per window every rank's admitted bits, 32 entries a
    thread, and their prefix; the block's share of the window's admitted
    order taken from the slices that hold it, in entry order, in rounds of
    at most SPLIT_LIST."""
    E = len(ep)
    Ws = max(4, min(slice_cap, -(-E // (4 * S)) * 4))
    out = []
    for w0 in range(0, E, S * Ws):
        bits, cnt = [], []
        for r in range(S):
            s0 = min(w0 + r * Ws, E)
            s1 = min(s0 + Ws, E)
            b = [[e for e in range(e0, min(e0 + 32, s1)) if ep[e] <= qp]
                 for e0 in range(s0, s0 + Ws, 32)]
            bits.append(b)
            cnt.append(sum(len(x) for x in b))
        a, a_end = pa.split_bounds(sum(cnt), S)[rank]
        for base in range(a, a_end, pa.SPLIT_LIST):
            hi = min(a_end, base + pa.SPLIT_LIST)
            lst, pr = [None] * (hi - base), 0
            for r in range(S):
                if pr < hi and pr + cnt[r] > base:
                    g = pr
                    for thread in bits[r]:
                        for e in thread:
                            if base <= g < hi:
                                lst[g - base] = e
                            g += 1
                pr += cnt[r]
            assert None not in lst
            out += lst
    return out


@pytest.mark.parametrize("kind", ["random", "few", "front", "empty"])
def test_split_walk_lists_every_admitted_entry_once(kind):
    g = torch.Generator().manual_seed(3)
    for E, S, cap in ((2048, 8, pa.SPLIT_SLICE), (17408, 8, pa.SPLIT_SLICE),
                      (40000, 8, pa.SPLIT_SLICE), (12000, 1, pa.SPLIT_SLICE),
                      (640, 3, 64), (45, 1, 32), (300, 8, 8)):
        ep = chip_smoke.ragged_history(torch, "cpu", g, 1, E, kind,
                                       20)[0].numpy()
        want = list(np.nonzero(ep <= 20)[0])
        shares = [_walk_rows(ep, 20, S, r, cap) for r in range(S)]
        # windows in order, ranks in order within each: every admitted
        # entry once, in entry order, when the shares are merged by window
        got = sorted(e for sh in shares for e in sh)
        assert got == want, (E, S, cap)
        assert all(sh == sorted(sh) for sh in shares)
        assert max(len(sh) for sh in shares) <= -(-len(want) // S) + \
            -(-E // (S * max(4, min(cap, -(-E // (4 * S)) * 4))))


def test_ragged_histories_exercise_what_they_claim():
    """chip_smoke's "few" case leaves fewer admitted entries than blocks;
    its "front" case puts every admitted entry in the first block's slice;
    its large random case takes two windows."""
    g = torch.Generator().manual_seed(5)
    cases = {c[6]: c for c in chip_smoke.PAGED_RAGGED if c[6] != "random"}
    for kind in ("few", "front"):
        B, Hkv, G, dh, ps, J, _ = cases[kind]
        p = pa.plan(B, Hkv, G, dh, J * ps, None, _BF)
        ep = chip_smoke.ragged_history(torch, "cpu", g, B, J * ps, kind, 20)
        adm = ep <= 20
        if kind == "few":
            assert int(adm.sum()) == 3 < p.splits
        else:
            Es = pa.split_slice(J * ps, p.splits)
            assert p.splits > 1 and adm.any()
            assert not adm[:, Es:].any()
    B, Hkv, G, dh, ps, J, _ = chip_smoke.PAGED_RAGGED[-2]
    p = pa.plan(B, Hkv, G, dh, J * ps, None, _BF)
    ep = chip_smoke.ragged_history(torch, "cpu", g, B, J * ps, "random", 20)
    Ws = pa.split_slice(J * ps, p.splits)
    assert -(-J * ps // (p.splits * Ws)) == 2
    assert int((ep[:, p.splits * Ws:] <= 20).sum()) > p.splits


def test_shared_memory_fits_three_blocks_per_sm():
    plans = [pa.plan(B, Hkv, G, dh, E, kd, _BF)
             for B, Hkv, E in _SWEEP for G in (1, 7, 16)
             for dh in (32, 64, 80, 128) for kd in (None, "int8", "int4")]
    assert 3 * pa.SPLIT_SMEM <= SMEM_PER_SM
    for p in plans:
        assert p.route == "split"
        assert pa.SPLIT_MIN_STAGES <= p.stages <= pa.SPLIT_MAX_STAGES
        assert p.smem <= pa.SPLIT_SMEM and 3 * p.smem <= SMEM_PER_SM
    # the shallowest ring fits at every head dim, payload and grouping
    for kd in (None, "int8", "int4"):
        for heads in (1, 2, 4):
            for dh in (32, 64, 80, 128):
                assert (pa.split_smem(kd, heads, dh, pa.SPLIT_MIN_STAGES)
                        <= pa.SPLIT_SMEM)
    # the warps' partials (acc [4][16][dh] fp32) fit below the list
    for kd in (None, "int8", "int4"):
        for heads in (1, 2, 4):
            for dh in (32, 64, 80, 128):
                below = (pa.split_smem(kd, heads, dh, 2)
                         - pa.SPLIT_LIST * 4)
                assert pa.SPLIT_WARPS * 16 * dh * 4 <= below
