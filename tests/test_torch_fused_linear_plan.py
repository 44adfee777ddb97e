"""The dense fused linear's plan (``fused_linear.plan``), its operand
padding, and ``chip_smoke.py``'s reference for the operand the
tensor-core tile feeds, on the CPU.

``plan`` is the one place that decides a call's route, tile, K split and
scratch; the C entries of ``csrc/fused_linear.cu`` launch exactly its grid
and refuse a tile they have no instantiation of or scratch shorter than
that grid writes (``chip_smoke.py``'s ragged phase checks the refusals on
the card).  Here its choices are held against values written out by hand
for the four linears of a llama2-7b block at the main path's M (decode 4,
continuous buckets 256 and 512, lock-step prefill 2048), and its grids are
walked to check that every row, output column and K index is covered
exactly once, at those shapes and at the ragged ones of ``chip_smoke.py``.

Tolerances: the mirrored bf16 operand within 2^-7·max|ref| of the exact
plain version (one bf16 rounding of x·gamma, by design); padded operands
within 1e-6·max|ref| of the unpadded ones (the same fp32 products, zero
terms added)."""
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
_LLAMA = [(name, K, N // 2 if glu else N, glu)
          for name, K, N, glu, _, _ in chip_smoke.linear_shapes(_CFG)]
_RAGGED = [("ragged", 200, 70, True), ("ragged", 300, 130, False),
           ("ragged", 40, 200, False), ("ragged", 300, 140, False)]
_CASES = ([(M, *s) for M in (4, 256, 512, 2048) for s in _LLAMA]
          + [(M, *s) for M in (4, 5, 37, 130) for s in _RAGGED])
_BF, _F32 = torch.bfloat16, torch.float32

# (M, linear, dtype) -> (route, tile_m, tile_n, splits, kc, grid, sq_part,
# part), worked out by hand from the rules in plan's docstring: the
# split-K stream takes 256 weight columns per block and splits K into
# multiples of 32 rows so that about 4 · 132 blocks run (kc · rows <=
# 4096); the tiles take 128 rows x 128 output columns (64 with the GLU,
# whose block reads the gate and up columns side by side); the SIMT
# kernel 16 x 64 up to M = 16.  Widths: wqkv K 4096, F 12288; wo 4096,
# 4096; gu 4096, 11008 (GLU); down 11008, 4096.
_EXPECTED = {
    (4, "wqkv", _BF): ("splitk", 4, 256, 11, 384, (48, 11), 0, 540672),
    (4, "wo", _BF): ("splitk", 4, 256, 32, 128, (16, 32), 0, 524288),
    (4, "gu", _BF): ("splitk", 4, 256, 6, 704, (86, 6), 0, 528384),
    (4, "down", _BF): ("splitk", 4, 256, 32, 352, (16, 32), 0, 524288),
    (256, "wqkv", _BF): ("wgmma", 128, 128, 0, 0, (2, 96), 24576, 0),
    (256, "wo", _BF): ("wgmma", 128, 128, 0, 0, (2, 32), 8192, 0),
    (256, "gu", _BF): ("wgmma", 128, 64, 0, 0, (2, 172), 44032, 0),
    (256, "down", _BF): ("wgmma", 128, 128, 0, 0, (2, 32), 8192, 0),
    (512, "wqkv", _BF): ("wgmma", 128, 128, 0, 0, (4, 96), 49152, 0),
    (512, "wo", _BF): ("wgmma", 128, 128, 0, 0, (4, 32), 16384, 0),
    (512, "gu", _BF): ("wgmma", 128, 64, 0, 0, (4, 172), 88064, 0),
    (512, "down", _BF): ("wgmma", 128, 128, 0, 0, (4, 32), 16384, 0),
    (2048, "wqkv", _BF): ("wgmma", 128, 128, 0, 0, (16, 96), 196608, 0),
    (2048, "wo", _BF): ("wgmma", 128, 128, 0, 0, (16, 32), 65536, 0),
    (2048, "gu", _BF): ("wgmma", 128, 64, 0, 0, (16, 172), 352256, 0),
    (2048, "down", _BF): ("wgmma", 128, 128, 0, 0, (16, 32), 65536, 0),
    (4, "wqkv", _F32): ("simt", 16, 64, 0, 0, (1, 192), 768, 0),
    (4, "wo", _F32): ("simt", 16, 64, 0, 0, (1, 64), 256, 0),
    (4, "gu", _F32): ("simt", 16, 64, 0, 0, (1, 172), 688, 0),
    (4, "down", _F32): ("simt", 16, 64, 0, 0, (1, 64), 256, 0),
    (256, "wqkv", _F32): ("simt", 128, 128, 0, 0, (2, 96), 24576, 0),
    (256, "wo", _F32): ("simt", 128, 128, 0, 0, (2, 32), 8192, 0),
    (256, "gu", _F32): ("simt", 128, 64, 0, 0, (2, 172), 44032, 0),
    (256, "down", _F32): ("simt", 128, 128, 0, 0, (2, 32), 8192, 0),
    (512, "wqkv", _F32): ("simt", 128, 128, 0, 0, (4, 96), 49152, 0),
    (512, "wo", _F32): ("simt", 128, 128, 0, 0, (4, 32), 16384, 0),
    (512, "gu", _F32): ("simt", 128, 64, 0, 0, (4, 172), 88064, 0),
    (512, "down", _F32): ("simt", 128, 128, 0, 0, (4, 32), 16384, 0),
    (2048, "wqkv", _F32): ("simt", 128, 128, 0, 0, (16, 96), 196608, 0),
    (2048, "wo", _F32): ("simt", 128, 128, 0, 0, (16, 32), 65536, 0),
    (2048, "gu", _F32): ("simt", 128, 64, 0, 0, (16, 172), 352256, 0),
    (2048, "down", _F32): ("simt", 128, 128, 0, 0, (16, 32), 65536, 0),
}


@pytest.mark.parametrize("key", list(_EXPECTED),
                         ids=lambda k: f"{k[1]}-M{k[0]}-{str(k[2])[6:]}")
def test_plan_matches_hand_worked_values(key):
    M, name, dtype = key
    _, K, F, glu = next(s for s in _LLAMA if s[0] == name)
    p = fl.plan(M, K, F, glu, dtype)
    got = (p.route, p.tile_m, p.tile_n, p.splits, p.kc, p.grid, p.sq_part,
           p.part)
    assert got == _EXPECTED[key]
    assert (p.K, p.F) == (K, F)     # no llama2-7b width is padded


def _ids(case):
    M, name, K, F, glu = case
    return f"{name}-M{M}-K{K}-F{F}{'-glu' if glu else ''}"


def _cover(n: int, starts, width: int) -> np.ndarray:
    """How often each index of [0, n) falls in [s, s + width) over starts."""
    hits = np.zeros(n, np.int64)
    for s0 in starts:
        hits[s0:min(n, s0 + width)] += 1
    return hits


@pytest.mark.parametrize("dtype", [_BF, _F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_plan_covers_every_row_column_and_k_once(case, dtype):
    """The main kernel's grid, walked as the C entry launches it, covers
    each row, output (or weight) column and K index exactly once, and
    the scratch plan sizes holds what that grid writes."""
    M, _, K, F, glu = case
    p = fl.plan(M, K, F, glu, dtype)
    assert p.K >= K and p.F >= F
    if dtype == _BF:                # padded to 16-byte rows, no further
        assert p.K % 8 == 0 and p.F % 8 == 0
        assert p.K - K < 8 and p.F - F < 8
    else:
        assert (p.K, p.F) == (K, F)
    n = 2 * p.F if glu else p.F     # the weight row the kernels read
    if p.route == "splitk":
        assert M <= p.tile_m <= fl.SPLITK_MAX_M
        assert p.kc * p.tile_m <= fl.SK_STAGE and p.kc % fl.SK_KC_STEP == 0
        assert (_cover(n, range(0, p.grid[0] * p.tile_n, p.tile_n),
                       p.tile_n) == 1).all()
        assert (_cover(p.K, [s * p.kc for s in range(p.grid[1])],
                       p.kc) == 1).all()
        assert (p.splits - 1) * p.kc < p.K     # no empty split
        assert p.part == p.splits * M * n and p.sq_part == 0
    else:
        assert p.splits == p.kc == p.part == 0
        assert (_cover(M, range(0, p.grid[0] * p.tile_m, p.tile_m),
                       p.tile_m) == 1).all()
        assert (_cover(p.F, range(0, p.grid[1] * p.tile_n, p.tile_n),
                       p.tile_n) == 1).all()
        assert p.sq_part == p.grid[1] * M      # one Σy² partial per tile
        if glu and p.route == "wgmma":
            # a block reads the gate and the up columns of its outputs
            assert 2 * p.tile_n == fl.TC_BW


@pytest.mark.parametrize("M", [1, 4, 5, 16, 17, 37, 256, 512, 2048])
def test_plan_routes_by_dtype_and_m(M):
    for _, K, F, glu in _LLAMA + _RAGGED:
        want = "splitk" if M <= fl.SPLITK_MAX_M else "wgmma"
        assert fl.plan(M, K, F, glu, _BF).route == want
        assert fl.plan(M, K, F, glu, _F32).route == "simt"
    with pytest.raises(ValueError):
        fl.plan(M, 64, 64, False, torch.float16)


@pytest.mark.parametrize("M,K,F,glu", [(37, 200, 70, True), (5, 300, 130, False),
                                       (4, 64, 48, True)])
def test_padded_operands_give_the_same_product(M, K, F, glu):
    """``_padded`` zero-fills K and F to multiples of 8 and moves the up
    half to column ``plan.F``: the plain version on the padded operands
    gives the unpadded outputs, and 0 in the padded columns (so Σy² is
    unchanged)."""
    rng = np.random.default_rng(M + K + F)
    N = 2 * F if glu else F
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.1).astype(np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(K).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((M, F)).astype(np.float32))
    ms = (x * x).mean(-1)
    p = fl.plan(M, K, F, glu, _BF)
    xp, wp, gp, rp = fl._padded(x, w, gamma, res, p, K, F, glu)
    assert xp.shape == (M, p.K) and rp.shape == (M, p.F)
    assert wp.shape == (p.K, 2 * p.F if glu else p.F)
    copies = ((xp, gp) if p.K != K else ()) + ((wp, rp) if p.F != F else ())
    assert all(t.data_ptr() % 16 == 0 for t in copies)   # fresh buffers
    kw = dict(mean_sq=ms, glu=glu, act_name="silu" if glu else None,
              emit_sq=True)
    out, sq = ref.fused_linear_ref(x, w, gamma=gamma, residual=res, **kw)
    outp, sqp = ref.fused_linear_ref(xp, wp, gamma=gp, residual=rp, **kw)
    assert (outp[:, :F] - out).abs().max() <= 1e-6 * out.abs().max()
    assert (outp[:, F:] == 0).all()
    assert ((sqp - sq).abs() <= 1e-6 * sq.abs()).all()


def _mirror_case(M, K, F, glu, seed):
    rng = np.random.default_rng(seed)
    N = 2 * F if glu else F
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(_BF)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                         .astype(np.float32)).to(_BF)
    kw = dict(mean_sq=(x.float() ** 2).mean(-1),
              gamma=torch.from_numpy(1 + 0.1 * rng.standard_normal(K)
                                     .astype(np.float32)).to(_BF),
              glu=glu, act_name="silu" if glu else None,
              residual=torch.from_numpy(rng.standard_normal((M, F))
                                        .astype(np.float32)).to(_BF),
              gate_mul=torch.from_numpy((rng.random(M) > 0.5)
                                        .astype(np.float32)),
              emit_sq=True)
    return x, w, kw


@pytest.mark.parametrize("M,K,F,glu", [
    (37, 128, 384, False),            # smoke-size wqkv
    (37, 128, 256, True),             # smoke-size gu (GLU)
    (64, 4096, 4096, False),          # llama2-7b wo at M = 64
])
def test_mirrored_operand_stays_within_bf16_tolerance(M, K, F, glu):
    """chip_smoke's reference for the tensor-core tile (bf16(x·gamma) fed
    to the product, the row rsqrt in fp32) against the exact plain
    version: within TOL_BF16·max|ref| in out, as the kernel must be."""
    x, w, kw = _mirror_case(M, K, F, glu, seed=M + K + F)
    out, sq = chip_smoke.fused_linear_mirror(torch, x, w, **kw)
    ro, rsq = ref.fused_linear_ref(x, w, **kw)
    err = (out.float() - ro.float()).abs().max().item()
    assert err <= chip_smoke.TOL_BF16 * ro.float().abs().max().item()
    assert out.dtype == _BF and sq.dtype == torch.float32
    assert torch.isfinite(sq).all()
    # without the prologue the mirror is the plain version itself
    kw0 = {k: v for k, v in kw.items() if k not in ("mean_sq", "gamma")}
    o0, s0 = chip_smoke.fused_linear_mirror(torch, x, w, **kw0)
    r0, q0 = ref.fused_linear_ref(x, w, **kw0)
    assert torch.equal(o0, r0) and torch.equal(s0, q0)
