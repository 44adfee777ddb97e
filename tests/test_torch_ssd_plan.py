"""The SSD scan's plan (``ssd_scan.plan``), its grid, the three-term bf16
split and the plain mirror of the tensor-core route, on the CPU.

``plan`` is the one place that decides a scan's route, P columns per block,
grid, threads, stages and shared memory; the C entries of
``csrc/ssd_scan.cu`` launch exactly that and refuse any other plan
(``chip_smoke.py``'s ragged phase checks the refusals on the card).  Here
its choices are held against values worked out by hand at mamba2-2.7b's
prefill shapes and at ``chip_smoke.py``'s ragged shapes; the grids are
walked as the kernels walk them; ``ref.split_bf16`` gives its input back
bit for bit; and ``ref.ssd_scan_split``, which rounds the operands as the
tensor-core route does, is held against the JAX package's jnp scan."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ss

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

_BF, _F32 = torch.bfloat16, torch.float32
SMEM_PER_SM = 227 * 1024      # what the blocks on one SM may share
SM_SMEM = 228 * 1024          # an SM's shared memory for blocks
SMEM_RESERVED = 1024          # the runtime's share of each resident block

# mamba2-2.7b prefill: H 80, P 64, N 128, G 1, chunk 128, T 512.  By hand,
# Q = 128 and 64 divides P, so PB = 64 (grid (B·H, 1)); the tc block's
# shared memory is two stages of B (128 rows × 136 bf16 = 34816 B) and of
# x (128 × 72, the pitch PB + 8 as PB / 8 is even), the state's three
# bf16 tiles (3 × 128 × 72 × 2 B), 4 × 128 floats and four partial state
# stripes of 16 × 72 floats: 69632 + 36864 + 55296 + 2048 + 18432 =
# 182272 B.  fp32: the SIMT kernel, one block per (b, h), 54400 floats =
# 217600 B.
_MAIN = [
    ((4, 512, 80, 64, 128, 1, 128), _BF, ("tc", 64, (320, 1), 256, 2, 182272)),
    ((1, 512, 80, 64, 128, 1, 128), _BF, ("tc", 64, (80, 1), 256, 2, 182272)),
    ((4, 512, 80, 64, 128, 1, 128), _F32,
     ("simt", 64, (320, 1), 256, 1, 217600)),
    ((1, 512, 80, 64, 128, 1, 128), _F32,
     ("simt", 64, (80, 1), 256, 1, 217600)),
]

# chip_smoke.SSD_RAGGED in bf16.  By hand: P 64 takes PB 64 (pitch 72,
# partial stripes 18432 B, the state's tiles 3 · 128 · 72 · 2 = 55296 B):
# Qp = 128 gives 182272; Qp = 48 (T 37) 2·48·136·2 + 2·48·72·2 + 55296 +
# 4·48·4 + 18432 = 114432; Qp = 16 (T 1) 8704 + 4608 + 55296 + 256 + 18432
# = 87296.  P 32 takes PB 8 (pitch 24, N 16, Qp 64): 6144 + 6144 + 2304 +
# 1024 + 4 · 16 · 16 · 4 = 19712 B.  T 129 at full width is the B 1 case.
_RAGGED = [
    ("tc", 64, (16, 1), 182272),
    ("tc", 64, (8, 1), 114432),
    ("tc", 64, (12, 1), 87296),
    ("tc", 8, (12, 4), 19712),
    ("tc", 64, (80, 1), 182272),
]


def _tuple(p):
    return (p.route, p.pb, p.grid, p.threads, p.stages, p.smem)


@pytest.mark.parametrize("shape,dtype,want", _MAIN,
                         ids=["tc-B4", "tc-B1", "simt-B4", "simt-B1"])
def test_plan_main_shapes_match_hand_worked_values(shape, dtype, want):
    assert _tuple(ss.plan(*shape, dtype)) == want


def test_plan_ragged_shapes_match_hand_worked_values():
    assert len(chip_smoke.SSD_RAGGED) == len(_RAGGED)
    for case, (route, pb, grid, smem) in zip(chip_smoke.SSD_RAGGED, _RAGGED):
        p = ss.plan(*case, _BF)
        assert _tuple(p) == (route, pb, grid, ss.TC_THREADS, ss.TC_STAGES,
                             smem), case
        assert ss.plan(*case, _F32).route == "simt", case


@pytest.mark.parametrize("P,pb", [(64, 64), (128, 64), (192, 64), (8, 8),
                                  (32, 8), (96, 8)])
def test_tc_slice_is_64_where_64_divides_p_else_8(P, pb):
    p = ss.plan(1, 512, 80, P, 128, 1, 128, _BF)
    assert (p.route, p.pb, p.grid) == ("tc", pb, (80, P // pb))


@pytest.mark.parametrize("N,P,chunk,want", [
    (128, 64, 128, "tc"), (16, 8, 1, "tc"), (48, 24, 100, "tc"),
    (24, 64, 128, "simt"),         # N a multiple of 8, not of 16
    (8, 64, 128, "simt"),          # N below one mma step
    (128, 12, 128, "simt"),        # P a multiple of 4, not of 8
    (136, 64, 128, None),          # N past both routes
    (128, 64, 256, None),          # a chunk past both routes
    (128, 6, 128, None),           # P off both routes
])
def test_routes_by_dtype_and_shape(N, P, chunk, want):
    T = 512
    if want is None:
        with pytest.raises(ValueError):
            ss.plan(2, T, 4, P, N, 1, chunk, _BF)
        return
    assert ss.plan(2, T, 4, P, N, 1, chunk, _BF).route == want
    if N % 8 == 0 and P % 4 == 0 and P <= 64:
        assert ss.plan(2, T, 4, P, N, 1, chunk, _F32).route == "simt"
    with pytest.raises(ValueError):
        ss.plan(2, T, 4, P, N, 1, chunk, torch.float16)
    with pytest.raises(ValueError):
        ss.plan(2, T, 3, P, N, 2, chunk, _BF)          # H not a multiple of G


_SWEEP = [(B, H, P, N, T) for B in (1, 2, 4, 16) for H in (1, 3, 8, 80)
          for P in (8, 24, 32, 64) for N in (16, 64, 128)
          for T in (1, 37, 512)]


def test_grid_covers_every_column_once():
    """Walk each plan's grid as the kernels read it (blockIdx.x = b·H + h,
    blockIdx.y = the P slice of pb columns): every (b, h, p) exactly once."""
    for B, H, P, N, T in _SWEEP:
        for dt in (_BF, _F32):
            p = ss.plan(B, T, H, P, N, 1, 128, dt)
            assert P % p.pb == 0 and p.grid == (B * H, P // p.pb)
            seen = np.zeros((B, H, P), dtype=np.int64)
            for bx in range(p.grid[0]):
                b, h = divmod(bx, H)
                for by in range(p.grid[1]):
                    seen[b, h, by * p.pb:(by + 1) * p.pb] += 1
            assert (seen == 1).all(), (B, H, P, N, T, dt)


def test_shared_memory_of_one_sm_fits():
    """The blocks one SM holds at once stay within 227 KB (with the
    runtime's 1 KB each within the SM's 228 KB), and a block within the
    227 KB a block may ask for."""
    for B, H, P, N, T in _SWEEP:
        for dt in (_BF, _F32):
            p = ss.plan(B, T, H, P, N, 1, 128, dt)
            assert p.smem <= ss.BLOCK_SMEM
            # PB 8 blocks are built for two a SM (their launch bounds)
            n = 2 if p.route == "tc" and p.pb == ss.TC_PB_NARROW else 1
            assert n * p.smem <= SMEM_PER_SM
            assert n * (p.smem + SMEM_RESERVED) <= SM_SMEM


def _bits(t):
    return t.view(torch.int32)


def _split_sum(a):
    hi, mid, lo = ref.split_bf16(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return (hi.float() + mid.float()) + lo.float()


def test_split_bf16_gives_its_input_back():
    rng = np.random.default_rng(7)
    mant = rng.uniform(1.0, 2.0, 20000)
    expo = rng.integers(-110, 100, 20000)
    sign = rng.choice([-1.0, 1.0], 20000)
    a = torch.from_numpy((sign * mant * 2.0 ** expo).astype(np.float32))
    # bf16 rounding boundaries: halfway between two bf16 values (ties to
    # even, both ways), one fp32 ulp either side of them, and bf16 values
    # (from 2^-110 up, where the split is exact)
    bits = rng.integers(0x08800000, 0x7f000000, 4000, dtype=np.int64)
    bits = (bits & ~0xFFFF).astype(np.int64)
    edges = np.concatenate([bits, bits | 0x8000, (bits | 0x8000) - 1,
                            (bits | 0x8000) + 1, bits | 0x7FFF,
                            (bits + 0x10000) & 0x7FFFFFFF])
    b = torch.from_numpy(edges.astype(np.int32)).view(torch.float32)
    b = torch.cat([b, -b])
    for x in (a, b, torch.tensor([0.0, 1.0, -2.0 ** -110, 2.0 ** 100])):
        assert torch.equal(_bits(_split_sum(x)), _bits(x))


def test_split_bf16_near_2_to_the_minus_120():
    """Near 2^-120 the fp32 significand reaches down to 2^-143, below
    bf16's smallest step (2^-133): no three bf16 terms can hold such a
    value.  Values whose bits stop at 2^-133 come back bit for bit; the
    rest within 2^-134, half that step."""
    rng = np.random.default_rng(8)
    mant = rng.uniform(1.0, 2.0, 5000)
    expo = rng.integers(-122, -118, 5000)
    a = torch.from_numpy((mant * 2.0 ** expo).astype(np.float32))
    step = 2.0 ** -133
    coarse = torch.from_numpy(
        (np.round(mant * 2.0 ** expo / step) * step).astype(np.float32))
    assert torch.equal(_bits(_split_sum(coarse)), _bits(coarse))
    err = (_split_sum(a).double() - a.double()).abs().max().item()
    assert err <= 2.0 ** -134


def _bf16_valued(rng, shape):
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return a.to(torch.bfloat16).float().numpy()


def test_split_mirror_matches_the_jax_scan():
    """``ref.ssd_scan_split`` (the tensor-core route's rounding) against
    the JAX package's ``ssm.ssd_scan`` at the main path's chunk shape (Q
    128, N 128, P 64) over a ragged T, bf16-valued inputs, within
    test_torch_ssm.py's 2e-4; and within 1e-5 of ``ref.ssd_scan_ref``."""
    rng = np.random.default_rng(0)
    B, T, H, P, N, G, Q = 1, 300, 2, 64, 128, 1, 128
    xh = _bf16_valued(rng, (B, T, H, P))
    dt = rng.uniform(0.0, 0.1, (B, T, H)).astype(np.float32)
    dt[:, 1::3] = 0.0                            # skipped tokens
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bm = _bf16_valued(rng, (B, T, G, N))
    Cm = _bf16_valued(rng, (B, T, G, N))
    per_head = [jnp.asarray(np.repeat(m, H // G, axis=2)) for m in (Bm, Cm)]
    y_j, s_j = jssm.ssd_scan(jnp.asarray(xh), jnp.asarray(dt),
                             jnp.asarray(A_log), *per_head, Q)
    args = [torch.from_numpy(a) for a in (xh, dt, A_log, Bm, Cm)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    y, s = ref.ssd_scan_split(*args, Q)
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-4)
    y_r, s_r = ref.ssd_scan_ref(*args, Q)
    assert (y - y_r).abs().max() <= 1e-5 * y_r.abs().max()
    assert (s - s_r).abs().max() <= 1e-5 * s_r.abs().max()


def _exact_inputs(rng, B, T, H, P, N, G):
    """chip_smoke.ssd_exact_inputs with numpy: cumsums exact in any order
    (A_log 0, dt on a 2^-10 grid, every third token 0)."""
    dt = (rng.integers(0, 103, (B, T, H)) / 1024.0).astype(np.float32)
    dt[:, 1::3] = 0.0
    return [torch.from_numpy(_bf16_valued(rng, (B, T, H, P))).bfloat16(),
            torch.from_numpy(dt), torch.zeros(H),
            torch.from_numpy(_bf16_valued(rng, (B, T, G, N))).bfloat16(),
            torch.from_numpy(_bf16_valued(rng, (B, T, G, N))).bfloat16()]


def test_split_limit_separates_the_lo_term(monkeypatch):
    """chip_smoke.TOL_SPLIT, which holds the tensor-core route against
    ``ref.ssd_scan_split`` on inputs whose cumsums are exact, passes the
    plain version and fails a mirror whose split drops the lo term (hi +
    mid: 16 bits of the significand)."""
    rng = np.random.default_rng(3)
    args = _exact_inputs(rng, 1, 512, 8, 64, 128, 1)
    y3, s3 = ref.ssd_scan_split(*args, 128)
    y_r, s_r = ref.ssd_scan_ref(*args, 128)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    tol = chip_smoke.TOL_SPLIT
    assert rel(y_r, y3) <= tol and rel(s_r, s3) <= tol
    split = ref.split_bf16

    def hi_mid(a):
        hi, mid, lo = split(a)
        return hi, mid, torch.zeros_like(lo)

    monkeypatch.setattr(ref, "split_bf16", hi_mid)
    y2, s2 = ref.ssd_scan_split(*args, 128)
    assert rel(y2, y3) > tol and rel(s2, s3) > tol


def _warp_scan_cumsum(t, dim):
    """torch.cumsum over the chunk axis (dim 2 of [B, nc, Q, H], Q 128) in
    the tensor-core route's order: each of 32 lanes sums 4 rows in turn,
    an inclusive Kogge-Stone scan over the lanes, then each row's
    exclusive lane prefix plus its running 4-row sum."""
    assert dim == 2 and t.shape[2] == 128
    v = t.reshape(*t.shape[:2], 32, 4, t.shape[3])
    runs, s = [], torch.zeros_like(v[:, :, :, 0])
    for r in range(4):
        s = s + v[:, :, :, r]
        runs.append(s)
    incl, o = s, 1
    while o < 32:
        shifted = torch.zeros_like(incl)
        shifted[:, :, o:] = incl[:, :, :-o]
        incl, o = incl + shifted, 2 * o
    excl = incl - s
    return torch.stack([excl + r for r in runs], dim=3).reshape(t.shape)


def test_cumsum_order_needs_exact_inputs(monkeypatch):
    """The tensor-core route sums a chunk's dt·A in another order than
    ``torch.cumsum``.  On chip_smoke.ssd_inputs-like data that order alone
    moves y past chip_smoke.TOL_SPLIT·max, as far as the split's lo term
    does; on ssd_exact_inputs-like data it moves nothing.  So the tight
    split check runs on the latter."""
    rng = np.random.default_rng(4)
    exact = _exact_inputs(rng, 1, 512, 8, 64, 128, 1)
    main = list(exact)
    dt = rng.uniform(0.0, 0.1, (1, 512, 8)).astype(np.float32)
    dt[:, 1::3] = 0.0
    main[1] = torch.from_numpy(dt)
    main[2] = torch.log(torch.linspace(1.0, 16.0, 8))
    base = [ref.ssd_scan_ref(*a, 128) for a in (main, exact)]
    monkeypatch.setattr(torch, "cumsum", _warp_scan_cumsum)
    moved = [ref.ssd_scan_ref(*a, 128) for a in (main, exact)]
    monkeypatch.undo()
    (y0, _), (y1, _) = base[0], moved[0]
    assert ((y1 - y0).abs().max() / y0.abs().max()).item() \
        > chip_smoke.TOL_SPLIT
    assert all(torch.equal(a, b) for u, w in zip(base[1:], moved[1:])
               for a, b in zip(u, w))
