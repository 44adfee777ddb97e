"""The router's plan (``fused_router_rmsnorm.plan``), the order of its
sums and its grids, and the routed blocks' router branch, on the CPU.

``plan`` is the one place that decides a router pass's grid, threads,
rows a block, vector width and shared memory; the C entries of
``csrc/router_stats.cu`` launch exactly that and refuse any other plan
(``chip_smoke.py``'s ragged phase checks the refusals on the card;
``_c_accepts`` below mirrors their checks).  Here its choices are held
against values worked out by hand at the main path's shapes and at
``chip_smoke.py``'s ragged ones; every plan stays within the source's
limits; the threads of every plan are walked as the kernel walks them,
and each must add every element of a row once, in the order of the
kernel's first version (256 order threads, thread t adding elements t,
t + 256, ...), so
a row's results depend on D alone; and a numpy mirror of the kernel's
lanes (E order threads a lane, the butterfly split between lanes and a
lane's own registers) is held bit for bit against a numpy mirror of that
first version's threads, and both against the JAX package's oracle.
Also: the port's router branch of a routed block (fused stats, carried
Σy²) against the reference's.

Tolerances: the mirrors' logits ≤ 1e-4·max|ref| and mean_sq ≤ 1e-5
relative of the oracle (fp32 sums in the kernel's order, not the
oracle's); the two mirrors bit for bit (the same additions)."""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import skip_block as jskip
from repro.kernels import ref as jref
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import skip_block
from repro_torch.kernels import fused_router_rmsnorm as frr

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repo root, beside src/)

torch.set_num_threads(2)

_BF, _F32 = torch.bfloat16, torch.float32
_ESIZE = {_BF: 2, _F32: 4}
TOL = 1e-4
TOL_SQ = 1e-5


def _cdiv(a, b):
    return -(-a // b)


def _c_accepts(p, T, D, dtype, x_ptr=0, w_ptr=0):
    """What ``launch`` in csrc/router_stats.cu accepts, written out again."""
    if (T < 0 or D < 0 or p.vec not in (1, 2) or D % p.vec
            or x_ptr % (p.vec * _ESIZE[dtype]) or w_ptr % 16):
        return False
    warps_a_row = 8 // p.vec
    cap = 264 * 16 // (p.rows * warps_a_row)
    return (p.rows in (1, 2, 4) and p.rows * warps_a_row <= 16
            and p.grid == min(_cdiv(T, p.rows), cap)
            and p.threads == 32 * warps_a_row * p.rows
            and p.smem == p.rows * 96)


def _tuple(p):
    return (p.grid, p.threads, p.rows, p.vec, p.smem)


# By hand.  vec 2 (D even, x aligned): a row over 4 warps.  rows: the most
# rows a block in (4, 2, 1) with ceil(T/rows) >= 264, else 1; threads
# 128·rows; grid min(ceil(T/rows), 264·16 / (4·rows)); smem 96·rows.  T
# 2048: 4 rows, 512 iterations on 264 blocks of 512 threads.  T 453:
# ceil(453/4) = 114, ceil(453/2) = 227 < 264 -> 1 row, 453 blocks of 128.
# T 4: 1 row, a block of 128 threads a row.  fp32 the same.
_MAIN = [((T, D, dt), want)
         for dt in (_BF, _F32) for D in (4096, 2560)
         for T, want in ((2048, (264, 512, 4, 2, 384)),
                         (453, (453, 128, 1, 2, 96)),
                         (4, (4, 128, 1, 2, 96)))]


@pytest.mark.parametrize("shape,want", _MAIN,
                         ids=[f"{t}x{d}-{str(dt)[6:]}" for (t, d, dt), _
                              in _MAIN])
def test_plan_main_shapes_match_hand_worked_values(shape, want):
    T, D, dt = shape
    p = frr.plan(T, D, dt)
    assert _tuple(p) == want
    assert _c_accepts(p, T, D, dt)
    assert T in chip_smoke.ROUTER_T


# chip_smoke.ROUTER_RAGGED in bf16, by hand.  D 300, 4096 and 4100 are
# even: vec 2, 128 threads a row.  T 1 to 37 -> 1 row a block, grid T; T
# 2049 -> 4 rows (513 iterations), 264 blocks of 512 threads.  D 301 is
# odd: vec 1, a row over 8 warps (256 threads a row).  Offsets of 1
# element (2 bytes) give vec 1, of 2 elements (4 bytes) vec 2.
_RAGGED = [
    (1, 128, 1, 2, 96),
    (16, 128, 1, 2, 96),
    (17, 128, 1, 2, 96),
    (37, 128, 1, 2, 96),
    (264, 512, 4, 2, 384),
    (1, 128, 1, 2, 96),
    (16, 128, 1, 2, 96),
    (17, 128, 1, 2, 96),
    (264, 512, 4, 2, 384),
    (1, 128, 1, 2, 96),
    (17, 128, 1, 2, 96),
    (3, 256, 1, 1, 96),
    (20, 256, 1, 1, 96),
    (4, 256, 1, 1, 96),
    (20, 256, 1, 1, 96),
    (4, 128, 1, 2, 96),
    (20, 128, 1, 2, 96),
]


def _ragged_ptr(T, D, off, dtype):
    """x's address as chip_smoke's ragged phase makes it, from a buffer at
    a 256-byte-aligned address (the caching allocator's)."""
    return _ESIZE[dtype] * (D if off is None else off)


def test_plan_ragged_shapes_match_hand_worked_values():
    assert len(chip_smoke.ROUTER_RAGGED) == len(_RAGGED)
    for (T, D, off), want in zip(chip_smoke.ROUTER_RAGGED, _RAGGED):
        p = frr.plan(T, D, _BF, _ragged_ptr(T, D, off, _BF))
        assert _tuple(p) == want, (T, D, off)
        assert _c_accepts(p, T, D, _BF, _ragged_ptr(T, D, off, _BF))


def test_ragged_cases_cover_both_vector_widths_and_block_sizes():
    seen = set()
    for dt in (_BF, _F32):
        for T, D, off in chip_smoke.ROUTER_RAGGED:
            p = frr.plan(T, D, dt, _ragged_ptr(T, D, off, dt))
            seen.add((dt, p.rows, p.vec))
    assert seen == {(dt, r, v) for dt in (_BF, _F32)
                    for r, v in ((4, 2), (1, 2), (1, 1))}


@pytest.mark.parametrize("T,rows2,rows1", [(0, 1, 1), (1, 1, 1), (16, 1, 1),
                                           (17, 1, 1), (2049, 4, 2),
                                           (8192, 4, 2)])
def test_one_rule_for_decode_and_prefill_rows(T, rows2, rows1):
    """Decode's few rows and prefill's many take the one rule: rows a
    block from T and the vector width alone (vec 2: up to 4; vec 1, a row
    over 8 warps: up to 2), at every width and in both dtypes."""
    for D in (256, 301, 2560, 4096, 40000):
        for dt in (_BF, _F32):
            p = frr.plan(T, D, dt)
            assert p.rows == (rows2 if p.vec == 2 else rows1), (D, dt, p)
            assert p.grid == min(_cdiv(T, p.rows),
                                 264 * 16 // (p.rows * (8 // p.vec)))


@pytest.mark.parametrize("T,rows,grid", [(17, 1, 17), (526, 1, 526),
                                         (527, 2, 264), (1052, 2, 526),
                                         (1053, 4, 264), (9000, 4, 264)])
def test_rows_a_block_keep_two_blocks_an_sm(T, rows, grid):
    p = frr.plan(T, 4096, _BF)
    assert (p.rows, p.grid, p.threads) == (rows, grid, 128 * rows)


@pytest.mark.parametrize("dt,ptr,vec", [
    (_BF, 0, 2), (_BF, 4, 2), (_BF, 2, 1), (_BF, 6, 1), (_F32, 8, 2),
    (_F32, 16, 2), (_F32, 4, 1), (_F32, 12, 1)])
def test_misaligned_pointers_get_the_narrow_vector_width(dt, ptr, vec):
    for T in (4, 2048):
        p = frr.plan(T, 4096, dt, ptr)
        assert p.vec == vec
        assert _c_accepts(p, T, 4096, dt, ptr)
        if vec == 1:                             # the aligned width refused
            assert not _c_accepts(dataclasses.replace(p, vec=2), T, 4096,
                                  dt, ptr)


_SWEEP = [(T, D) for T in (0, 1, 3, 4, 16, 17, 37, 128, 453, 2048, 2049,
                           4224, 9000)
          for D in (1, 7, 64, 300, 301, 2560, 4096, 4100, 29000)]


def test_every_plan_stays_within_the_source_limits():
    for T, D in _SWEEP:
        for dt in (_BF, _F32):
            for ptr in (0, 2, 4, 8):
                p = frr.plan(T, D, dt, ptr * _ESIZE[dt] // 2)
                assert _c_accepts(p, T, D, dt, ptr * _ESIZE[dt] // 2), \
                    (T, D, dt, ptr, p)
                assert p.threads % 32 == 0 and 32 <= p.threads <= 512
                assert p.smem <= 48 * 1024       # no opt-in needed
                assert p.grid * p.threads <= 264 * 512
                if T < 264:                      # a block a row
                    assert (p.rows, p.grid) == (1, T)


def test_c_mirror_refuses_plans_off_the_source():
    for T, D, dt in ((40, 4096, _BF), (4, 4096, _BF), (40, 4096, _F32),
                     (4, 4096, _F32), (40, 301, _BF)):
        p = frr.plan(T, D, dt)
        rep = dataclasses.replace
        bad = [rep(p, grid=p.grid + 1), rep(p, threads=p.threads + 32),
               rep(p, smem=p.smem + 16), rep(p, vec=4), rep(p, vec=3),
               rep(p, rows=2 * p.rows, grid=_cdiv(T, 2 * p.rows))]
        for r in (3, 8):          # not a power of 2; past 16 warps
            bad.append(rep(p, rows=r, grid=_cdiv(T, r),
                           threads=p.threads * r // p.rows,
                           smem=p.smem * r // p.rows))
        for b in bad:
            assert not _c_accepts(b, T, D, dt), b
        assert not _c_accepts(p, T, D, dt, w_ptr=8)
        if p.vec == 2:
            assert not _c_accepts(p, T, D, dt, x_ptr=_ESIZE[dt])


def _walk(p, T, D):
    """{(row, order thread t): the elements that the lane holding t adds,
    in the order it adds them}, walked as the kernel's threads walk them:
    block b takes iterations b, b + grid, ...; its warp w takes row w //
    (8 / vec) of the iteration's rows and order warps g·vec .. + vec - 1 (g
    = w % (8 / vec)); its lane l holds order threads 32·g·vec + vec·l + e
    and loads, in rounds of 16 windows, element 32·g·vec + vec·l + 256·i +
    e of window i."""
    V = p.vec
    n_win = _cdiv(D, 256)
    warps_a_row = 8 // V
    got = {}
    n_iter = _cdiv(T, p.rows)
    for b in range(p.grid):
        for it in range(b, n_iter, p.grid):
            for warp in range(p.threads // 32):
                row = it * p.rows + warp // warps_a_row
                g = warp % warps_a_row
                if row >= T:
                    continue
                for lane in range(32):
                    d0 = 32 * g * V + V * lane
                    for i in range(n_win):
                        if d0 + 256 * i < D:
                            for e in range(V):
                                got.setdefault((row, d0 + e), []).append(
                                    d0 + 256 * i + e)
    return got


@pytest.mark.parametrize("T,D", [(2048, 512), (453, 2560), (4, 4096),
                                 (17, 300), (1100, 300), (700, 64),
                                 (16, 301), (37, 64), (20, 301), (1200, 7),
                                 (3, 5000)])
def test_every_plan_adds_each_element_once_in_the_first_versions_order(T, D):
    for dt in (_BF, _F32):
        p = frr.plan(T, D, dt)
        want = {(row, t): list(range(t, D, 256))
                for row in range(T) for t in range(min(256, D))}
        assert _walk(p, T, D) == want, (T, D, dt, p)


def _butterfly(v):
    """repro::warp_sum on 32 lanes: every lane ends with the same sum."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _fma3(acc, v, w0, w1):
    return (acc + np.float32(v) * np.array([w0, w1, v], np.float32)).astype(
        np.float32)


def _first_version(x, w):
    """The order of the kernel's first version, thread by thread: thread t
    of 256 adds elements t, t + 256, ...; warp_sum within each of the 8
    warps; the warps' sums in order from 0."""
    T, D = x.shape
    logits, ms = np.zeros((T, 2), np.float32), np.zeros(T, np.float32)
    for row in range(T):
        acc = np.zeros((256, 3), np.float32)
        for t in range(256):
            for d in range(t, D, 256):
                acc[t] = _fma3(acc[t], x[row, d], w[d, 0], w[d, 1])
        tot = np.zeros(3, np.float32)
        for k in range(8):
            tot = (tot + np.array([_butterfly(acc[32 * k:32 * k + 32, c])[0]
                                   for c in range(3)])).astype(np.float32)
        logits[row], ms[row] = tot[:2], tot[2] / np.float32(D)
    return logits, ms


def _lanes(x, w, V):
    """The kernel's lanes: lane l of warp g holds order threads 32·g·V +
    V·l + e; the butterfly's offsets of V and more between lanes (lane xor
    o / V), the rest between a lane's own registers; lane l of warp g then
    holds order warp g·V + l / (32 / V); the 8 in order from 0."""
    T, D = x.shape
    logits, ms = np.zeros((T, 2), np.float32), np.zeros(T, np.float32)
    for row in range(T):
        tot = np.zeros(3, np.float32)
        warp_sums = {}
        for g in range(8 // V):
            acc = np.zeros((32, V, 3), np.float32)
            for lane in range(32):
                d0 = 32 * g * V + V * lane
                for i in range(_cdiv(D, 256)):
                    if d0 + 256 * i < D:
                        for e in range(V):
                            d = d0 + 256 * i + e
                            acc[lane, e] = _fma3(acc[lane, e], x[row, d],
                                                 w[d, 0], w[d, 1])
            o = 16
            while o:
                if o >= V:
                    acc = (acc + acc[np.arange(32) ^ (o // V)]).astype(
                        np.float32)
                else:
                    acc = acc.copy()
                    for e in range(V):
                        if e & o == 0:
                            acc[:, e] = (acc[:, e] + acc[:, e + o]).astype(
                                np.float32)
                o >>= 1
            for lane in range(0, 32, 32 // V):
                warp_sums[g * V + lane // (32 // V)] = acc[lane, 0]
        for k in range(8):
            tot = (tot + warp_sums[k]).astype(np.float32)
        logits[row], ms[row] = tot[:2], tot[2] / np.float32(D)
    return logits, ms


@pytest.mark.parametrize("T,D", [(2, 256), (2, 600), (3, 300), (2, 301),
                                 (2, 96), (1, 2560), (2, 7)])
def test_lanes_add_as_the_first_version_and_match_the_oracle(T, D):
    rng = np.random.default_rng(T * 1000 + D)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, 2)) * 0.1).astype(np.float32)
    for dt in (_BF, _F32):
        xd = torch.from_numpy(x).to(dt).float().numpy()
        jl, jm = (np.asarray(a) for a in jref.router_stats_ref(
            jnp.asarray(xd), jnp.asarray(w)))
        lo, ms = _first_version(xd, w)
        for V in (2, 1) if D % 2 == 0 else (1,):
            lo2, ms2 = _lanes(xd, w, V)
            np.testing.assert_array_equal(lo, lo2)
            np.testing.assert_array_equal(ms, ms2)
        assert np.abs(lo - jl).max() <= TOL * np.abs(jl).max()
        assert np.all(np.abs(ms - jm) <= TOL_SQ * np.abs(jm))


# ---------------------------------------------------------------------------
# The routed block's router branch against the reference's
# ---------------------------------------------------------------------------

JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("carried", [False, True])
def test_router_branch_matches_reference(routed, carried):
    """``skip_block._router_and_stats`` on each branch: the fused stats
    (kernel on the device, its plain version here; bias added after it),
    mean(x²) alone when unrouted, and with a carried Σy²/D the router
    product alone in plain torch (the reference computes it outside
    Pallas) and the carry passed through unchanged."""
    ref = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), JCFG))
    port = bridge.from_reference(ref, CFG)
    pj = jax.tree_util.tree_map(jnp.asarray,
                                ref["stack"]["stage0"]["pos0"]["mixer"])
    pt = port["blocks"][0]["mixer"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    pt = dict(pt, router=dict(pt["router"], b=torch.tensor([0.3, -0.2])))
    pj = dict(pj, router=dict(pj["router"], b=jnp.asarray([0.3, -0.2])))
    sq = (np.abs(rng.standard_normal((2, 5))) + 0.5).astype(np.float32) \
        if carried else None
    lt, st = skip_block._router_and_stats(
        pt, torch.from_numpy(x), CFG, routed,
        None if sq is None else torch.from_numpy(sq))
    lj, sj = jskip._router_and_stats(pj, jnp.asarray(x), JCFG, routed,
                                     None if sq is None else jnp.asarray(sq))
    assert (lt is None) == (lj is None) == (not routed)
    if routed:
        assert lt.shape == (2, 5, 2) and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=0, atol=TOL * np.abs(lj).max())
    if carried:
        np.testing.assert_array_equal(st.numpy(), sq)
        np.testing.assert_array_equal(np.asarray(sj), sq)
    else:
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=TOL_SQ)
        np.testing.assert_allclose(st.numpy(), (x.astype(np.float64) ** 2)
                                   .mean(-1), rtol=TOL_SQ)
