"""The int4-BFP plan (``fused_linear.plan_int4``), the plain version's
split mirror (``ref.bfp_matmul_f32(split_groups=)``), the tile's BFP
operand (``ref.bfp_operand``) and the wrapper's width padding, on the CPU.

``plan_int4`` is the one place that decides an int4 call's route, tile,
K split and scratch; the C entries of ``csrc/fused_linear_int4.cu`` launch
exactly its grid and refuse any other plan, or scratch shorter than that
grid writes (``chip_smoke.py``'s ragged phase checks the refusals on the
card).  Here its choices are held against values written out by hand for
the four linears of a llama2-7b block at the main path's M (decode 4,
continuous buckets 256 and 512, lock-step prefill 2048) and for the lm
head at M 4, and its grids are walked to check that every row, output
column and K-group is covered exactly once, at those shapes and at the
ragged ones of ``chip_smoke.py``.

Tolerances: the split mirror equals a float32 numpy sum in the same order
bit for bit, and the default order within 1e-6·max|y| (the same fp32
terms added in another order); mantissas, steps and padded operands are
compared bit for bit."""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

torch.set_num_threads(2)

_CFG = get_config("llama2-7b")
_G = _CFG.quant.group_size
_LLAMA = [(name, K, N // 2 if glu else N, glu)
          for name, K, N, glu, _, _ in chip_smoke.linear_shapes(_CFG)]
_LM_HEAD = ("lm_head", _CFG.d_model, _CFG.vocab_size, False)
_BF, _F32 = torch.bfloat16, torch.float32

# (M, linear) -> (route, F, Gq, tile_m, tile_n, group_split, splits, grid,
# mant, steps, sq_part), worked out by hand from the rules in plan_int4's
# docstring, G 128.  Widths: wqkv K 4096 (C 32), F 12288, 96 column tiles
# of 128; wo 4096, 4096, 32 tiles; gu 4096, 11008 (GLU: 172 tiles of 64
# outputs, their gate and up columns side by side); down K 11008 (C 86),
# F 4096, 32 tiles; lm head K 4096, N 32000, 250 tiles.
# The stream: groups per split = max(ceil(C / 32), ceil(tiles · C / 1056));
# wqkv ceil(3072 / 1056) = 3 -> 11 splits in 3 blocks of 4; wo 1 -> 32 in
# 8; gu ceil(5504 / 1056) = 6 -> 6 in 2; down max(3, ceil(2752 / 1056)) =
# 3 -> 29 in 8; lm head ceil(8000 / 1056) = 8 -> 4 in 1.  Σy² partials:
# tiles · blocks per cluster · M.  The tile: (M / 128, tiles) blocks,
# mantissas M · C · 128 int8, steps C · M, Σy² partials tiles · M.
_EXPECTED = {
    (4, "wqkv"): ("stream", 12288, 128, 8, 128, 3, 11, (3, 96), 0, 0, 1152),
    (4, "wo"): ("stream", 4096, 128, 8, 128, 1, 32, (8, 32), 0, 0, 1024),
    (4, "gu"): ("stream", 11008, 128, 8, 128, 6, 6, (2, 172), 0, 0, 1376),
    (4, "down"): ("stream", 4096, 128, 8, 128, 3, 29, (8, 32), 0, 0, 1024),
    (4, "lm_head"): ("stream", 32000, 128, 8, 128, 8, 4, (1, 250), 0, 0,
                     1000),
    (256, "wqkv"): ("tc", 12288, 128, 128, 128, 0, 0, (2, 96), 1048576, 8192,
                    24576),
    (256, "wo"): ("tc", 4096, 128, 128, 128, 0, 0, (2, 32), 1048576, 8192,
                  8192),
    (256, "gu"): ("tc", 11008, 128, 128, 128, 0, 0, (2, 172), 1048576, 8192,
                  44032),
    (256, "down"): ("tc", 4096, 128, 128, 128, 0, 0, (2, 32), 2818048, 22016,
                    8192),
    (512, "wqkv"): ("tc", 12288, 128, 128, 128, 0, 0, (4, 96), 2097152,
                    16384, 49152),
    (512, "wo"): ("tc", 4096, 128, 128, 128, 0, 0, (4, 32), 2097152, 16384,
                  16384),
    (512, "gu"): ("tc", 11008, 128, 128, 128, 0, 0, (4, 172), 2097152, 16384,
                  88064),
    (512, "down"): ("tc", 4096, 128, 128, 128, 0, 0, (4, 32), 5636096, 44032,
                    16384),
    (2048, "wqkv"): ("tc", 12288, 128, 128, 128, 0, 0, (16, 96), 8388608,
                     65536, 196608),
    (2048, "wo"): ("tc", 4096, 128, 128, 128, 0, 0, (16, 32), 8388608, 65536,
                   65536),
    (2048, "gu"): ("tc", 11008, 128, 128, 128, 0, 0, (16, 172), 8388608,
                   65536, 352256),
    (2048, "down"): ("tc", 4096, 128, 128, 128, 0, 0, (16, 32), 22544384,
                     176128, 65536),
}


def _shape(name):
    return next(s for s in _LLAMA + [_LM_HEAD] if s[0] == name)


def _plan(M, K, F, G, glu, dtype=_BF):
    return fl.plan_int4(M, K, F, G, -(-K // G), glu, dtype)


@pytest.mark.parametrize("key", list(_EXPECTED), ids=lambda k: f"{k[1]}-M{k[0]}")
def test_plan_int4_matches_hand_worked_values(key):
    M, name = key
    _, K, F, glu = _shape(name)
    for dtype in (_BF, _F32):       # the route and tile do not depend on it
        p = _plan(M, K, F, _G, glu, dtype)
        got = (p.route, p.F, p.Gq, p.tile_m, p.tile_n, p.group_split,
               p.splits, p.grid, p.mant, p.steps, p.sq_part)
        assert got == _EXPECTED[key]


# (M, K, F, glu, G): the main shapes, the lm head, chip_smoke's ragged
# fused-linear cases and its ragged int4-matmul cases.
_CASES = ([(M, K, F, glu, _G) for M in (4, 256, 512, 2048)
           for _, K, F, glu in _LLAMA]
          + [(4, _LM_HEAD[1], _LM_HEAD[2], False, _G)]
          + [(M, K, F, glu, G) for M, K, F, glu, G, *_ in
             chip_smoke.INT4_RAGGED]
          + [(1, 200, 33, False, 64), (17, 256, 130, False, 128),
             (3, 38, 7, False, 128)])


def _ids(case):
    M, K, F, glu, G = case
    return f"M{M}-K{K}-F{F}-G{G}{'-glu' if glu else ''}"


def _cover(n: int, starts, width: int) -> np.ndarray:
    """How often each index of [0, n) falls in [s, s + width) over starts."""
    hits = np.zeros(n, np.int64)
    for s0 in starts:
        hits[s0:min(n, s0 + width)] += 1
    return hits


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_plan_int4_covers_every_row_column_and_group_once(case):
    """Each grid, walked as the C entry launches it, covers each row,
    output column and K-group exactly once (on the tile: each code row of
    a group in exactly one of its 32-row slots), and the plan's scratch
    holds what that grid writes."""
    M, K, F, glu, G = case
    C = -(-K // G)
    p = fl.plan_int4(M, K, F, G, C, glu, _BF)
    assert p.F % fl.INT4_F_STEP == 0 and 0 <= p.F - F < fl.INT4_F_STEP
    assert p.Gq % fl.INT4_K_STEP == 0 and 0 <= p.Gq - G < fl.INT4_K_STEP
    assert p.tile_n == fl.INT4_COLS
    outs = p.tile_n // 2 if glu else p.tile_n   # output columns per tile
    assert (_cover(p.F, range(0, p.grid[1] * outs, outs), outs) == 1).all()
    assert (p.grid[1] - 1) * outs < p.F       # no empty column tile
    if p.route == "tc":
        assert p.tile_m == fl.INT4_TC_BM and p.group_split == p.splits == 0
        assert (_cover(M, range(0, p.grid[0] * p.tile_m, p.tile_m),
                       p.tile_m) == 1).all()
        assert (p.mant, p.steps, p.sq_part) == (M * C * p.Gq, C * M,
                                                p.grid[1] * M)
        reads = np.zeros(G * C, np.int64)      # code rows a real slot reads
        for slot in range(C * p.Gq // 32):
            c, o = divmod(slot * 32, p.Gq)
            for k in range(o, min(o + 32, G)):
                reads[c * G + k] += 1
        assert (reads == 1).all()
    else:
        assert M <= p.tile_m <= fl.INT4_STREAM_MAX_M and p.mant == 0
        S, gps = p.splits, p.group_split
        assert S <= fl.INT4_STREAM_WARPS * fl.INT4_MAX_CLUSTER
        assert (_cover(C, [s * gps for s in range(S)], gps) == 1).all()
        assert (S - 1) * gps < C               # no empty split
        ranks = p.grid[0]
        assert (ranks - 1) * fl.INT4_STREAM_WARPS < S \
            <= ranks * fl.INT4_STREAM_WARPS <= fl.INT4_STREAM_WARPS \
            * fl.INT4_MAX_CLUSTER
        per = -(-outs // ranks)                # a rank's share of a tile
        assert (_cover(outs, [r * per for r in range(ranks)], per)
                == 1).all()
        assert p.sq_part == p.grid[1] * ranks * M


@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 37, 256, 2048])
def test_plan_int4_routes_by_m_alone(M):
    want = "stream" if M <= fl.INT4_STREAM_MAX_M else "tc"
    for glu in (False, True):
        pb = _plan(M, 4096, 4096, _G, glu, _BF)
        assert pb == _plan(M, 4096, 4096, _G, glu, _F32)
        assert pb.route == want
        if want == "stream":
            assert pb.tile_m == (8 if M <= 8 else 16)


def test_plan_int4_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        _plan(4, 256, 64, 128, False, torch.float16)
    with pytest.raises(ValueError):
        _plan(4, 512, 64, 256, False)            # G past MAX_GROUP
    with pytest.raises(ValueError):
        fl.plan_int4(4, 300, 64, 128, 2, False, _BF)   # K past G·C


def _bfp_inputs(M, K, N, G, seed):
    rng = np.random.default_rng(seed)
    C = -(-K // G)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    codes = torch.from_numpy(
        rng.integers(-8, 8, (G * C, N)).astype(np.int8))
    codes[K:] = 0
    scale = torch.from_numpy(
        np.exp2(rng.integers(-9, -3, (C, N))).astype(np.float32))
    return x, codes, scale


def _numpy_split_sum(x, codes, scale, G, gps):
    """The stream's order in float32 numpy: per group t = float(Σ q·code)
    · 2^(e-7), term t · scale; a split's terms from zero in ascending
    order, then the splits from zero in ascending order."""
    M, K = x.shape
    C = scale.shape[0]
    xp = torch.nn.functional.pad(x, (0, G * C - K)).reshape(M, C, G)
    mant, pe = ref.bfp_quantize_rows(xp)
    mant = mant.numpy().astype(np.int64)
    step = (pe[..., 0] * np.float32(2.0 ** -ref.MBITS)).numpy()
    wg = codes.numpy().astype(np.int64).reshape(C, G, -1)
    sc = scale.numpy()
    y = np.zeros((M, codes.shape[1]), np.float32)
    for c0 in range(0, C, gps):
        part = np.zeros_like(y)
        for c in range(c0, min(C, c0 + gps)):
            acc = (mant[:, c] @ wg[c]).astype(np.float32)
            part = part + (acc * step[:, c, None]) * sc[c][None]
        y = y + part
    return y


@pytest.mark.parametrize("M,K,N,G,gps", [(4, 11008, 64, 128, 3),
                                         (4, 4096, 48, 128, 6),
                                         (5, 300, 32, 64, 2),
                                         (3, 200, 16, 38, 4)])
def test_split_mirror_order(M, K, N, G, gps):
    x, codes, scale = _bfp_inputs(M, K, N, G, seed=M * K + G)
    C = scale.shape[0]
    default = ref.bfp_matmul_f32(x, codes, scale)
    one = ref.bfp_matmul_f32(x, codes, scale, split_groups=C)
    assert torch.equal(one, default)            # one split: today's order
    split = ref.bfp_matmul_f32(x, codes, scale, split_groups=gps)
    assert np.array_equal(split.numpy(),
                          _numpy_split_sum(x, codes, scale, G, gps))
    tol = 1e-6 * default.abs().max().item()
    assert (split - default).abs().max().item() <= tol
    # the fused pipeline's plain version passes the order through
    y, _ = ref.fused_linear_ref(x, w_codes=codes, scale=scale,
                                split_groups=gps)
    assert torch.equal(y, split)


@pytest.mark.parametrize("G", [128, 64, 38, 32])
def test_bfp_operand_matches_quantize_rows(G):
    """The tile's operand: each group's mantissas equal
    ``bfp_quantize_rows``' (the stream's, which it computes per group),
    followed by Gq - G zeros; the steps are 2^(e-7), [C, M]."""
    M, K = 6, 3 * G - 5
    x, _, _ = _bfp_inputs(M, K, 8, G, seed=G)
    x[1, :G] = 0.0                               # an all-zero group
    C = -(-K // G)
    Gq = -(-G // 32) * 32
    mant, step = ref.bfp_operand(x, G, C, Gq)
    assert mant.dtype == torch.int8 and tuple(mant.shape) == (M, C * Gq)
    assert step.dtype == torch.float32 and tuple(step.shape) == (C, M)
    xp = torch.nn.functional.pad(x, (0, G * C - K)).reshape(M, C, G)
    want, pe = ref.bfp_quantize_rows(xp)
    got = mant.reshape(M, C, Gq)
    assert torch.equal(got[..., :G], want)
    assert not got[..., G:].any()
    assert torch.equal(step, (pe[..., 0] * 2.0 ** -ref.MBITS).t())
    assert (step[0, 1] == 2.0 ** -ref.MBITS).item()   # zero group: e = 0


@pytest.mark.parametrize("glu", [False, True], ids=["plain", "glu"])
def test_padded_int4_widths_leave_the_product_unchanged(glu):
    """Codes, scale and residual widened to the plan's F (the GLU's up half
    moved to column p.F) give the same plain result on the first F
    columns, bit for bit, and zeros past them."""
    M, K, F, G = 3, 200, 70, 64
    N = 2 * F if glu else F
    x, codes, scale = _bfp_inputs(M, K, N, G, seed=7)
    res = torch.randn(M, F, generator=torch.Generator().manual_seed(1))
    p = _plan(M, K, F, G, glu)
    assert p.F == 80
    c2, s2, r2 = fl._padded_int4(codes, scale, res, p, F, glu)
    assert tuple(c2.shape) == (codes.shape[0], 2 * p.F if glu else p.F)
    kw = dict(glu=glu, act_name="silu" if glu else None)
    want, _ = ref.fused_linear_ref(x, w_codes=codes, scale=scale,
                                   residual=res, **kw)
    got, _ = ref.fused_linear_ref(x, w_codes=c2, scale=s2, residual=r2,
                                  **kw)
    assert torch.equal(got[:, :F], want)
    assert not got[:, F:].any()
