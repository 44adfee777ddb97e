"""Fused linear pipeline: RMSNorm prologue x matmul x {GLU, gate_mul,
residual, Σy²} epilogue (paper Alg. 1 + §4.2), over dense weights or int4
codes with per-group power-of-2 scales.

Kernels (CUDA C++, sm_90a), the port of ``fused_linear_pallas`` in the JAX
package's ``kernels/fused_linear.py``:

- ``csrc/fused_linear.cu``, its dense branch, three routes that ``plan``
  picks by dtype and M alone: bf16 with M > ``SPLITK_MAX_M`` runs the
  tensor-core tile (wgmma over a TMA ring; prefill), bf16 with
  M <= ``SPLITK_MAX_M`` the split-K weight stream and its epilogue pass
  (decode), fp32 the SIMT kernel (the parity instrument);
- ``csrc/fused_linear_int4.cu``, its int4-BFP branch: per row and K-group
  the (normalised) activation becomes a shared exponent with int8
  mantissas, int8×int4 products accumulate exactly in int32, and floating
  point is rebuilt once per group (the paper's float-fixed hybrid PE
  array).  Two routes that ``plan_int4`` picks by M alone, for bf16 and
  fp32 activations: M > ``INT4_STREAM_MAX_M`` runs a BFP pre-pass and the
  s8 tensor-core tile (wgmma over a TMA ring, the codes turned K-major in
  shared memory; prefill), M <= ``INT4_STREAM_MAX_M`` the split-K code
  stream (mma.sync, one thread-block cluster along K per column tile;
  decode and the lm head).

Prefill is bound by operations and decode by weight bytes; see the sources
for their designs, for where the bf16 tile rounds the normalised
activation, and for how Σy² is reduced across tiles without atomics.  The
plain version is ``ref.fused_linear_ref`` (for the int4 stream with
``split_groups``, its order of the fp32 group terms).

``fused_linear`` takes the plain version for a CPU tensor and launches the
kernel of its weight type for a CUDA tensor; any other device, or a failed
build or launch, raises.  ``launches`` counts dense calls (one per call),
``launches_wgmma``, ``launches_splitk`` and ``launches_simt`` the route each
took, ``launches_int4`` int4 calls and ``launches_int4_tc`` and
``launches_int4_stream`` their routes.  The kernels allocate nothing and
keep no state between calls: the wrapper allocates every scratch buffer
per call.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_wgmma = 0
launches_splitk = 0
launches_simt = 0
launches_int4 = 0
launches_int4_tc = 0
launches_int4_stream = 0
_FNS = {}
_FNS_INT4 = {}
_ACTS = {None: 0, "silu": 1}

# The tiles csrc/fused_linear.cu instantiates.  plan() chooses among them;
# the C entries refuse any other tile, and scratch shorter than the grid
# they launch writes.
SPLITK_MAX_M = 16        # bf16 rows up to this take the split-K stream
TC_BM, TC_BW = 128, 128  # tensor-core tile: rows, weight columns per block
SK_COLS = 256            # split-K stream block: weight columns
SK_ROWS = (4, 8, 16)     # split-K stream block: register rows (>= M)
SK_STAGE = 4096          # split-K: staged activations, kc · rows <= this
SK_KC_STEP = 32          # split-K: K rows per split, a multiple of this
SK_BLOCKS = 4 * 132      # split-K: one wave of 4 blocks per SM of an H100
SIMT_SMALL_M = 16        # SIMT tiles: 16 x 64 up to this M, above it
#                          128 x 64 with the GLU and 128 x 128 without

# What csrc/fused_linear_int4.cu instantiates.  plan_int4() chooses among
# it; the C entries refuse any other plan, and scratch shorter than the
# grid they launch writes.
MAX_GROUP = 128          # widest K-group either int4 route takes
INT4_STREAM_MAX_M = 16   # rows up to this take the split-K code stream
INT4_TC_BM = 128         # tensor-core tile: rows per block
INT4_COLS = 128          # code columns per block (GLU: 64 outputs' gate+up)
INT4_F_STEP = 16         # output columns padded to a multiple of this
INT4_K_STEP = 32         # tile: a K-group's mantissas padded to this
INT4_STREAM_ROWS = (8, 16)  # stream: register rows (>= M)
INT4_STREAM_WARPS = 4    # stream: splits (warps) per block
INT4_MAX_CLUSTER = 8     # stream: blocks per cluster along K
INT4_STREAM_WANT = 8 * 132  # stream: about 8 warps per SM of an H100


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one dense fused-linear call runs (``plan``).

    ``K``, ``F``: the sizes the kernels walk; on the bf16 routes both are
    padded to multiples of 8 (16-byte copies), and the weight they read
    is [K, 2F] for the GLU (the up half at column F) or [K, F].
    ``tile_m`` x ``tile_n``: rows x output columns of one block on the
    tiles; register rows (>= M) x weight columns of one stream block on
    the split-K route, which splits K ``splits`` ways, ``kc`` rows each
    (both 0 on the tiles).  ``grid``: the main kernel's blocks, (row
    tiles, column tiles) on the tiles, (column tiles, splits) on the
    stream.  ``sq_part``, ``part``: f32 scratch entries, the tiles' Σy²
    partials [column tiles, M] (needed with Σy² only) and the stream's
    K partials [splits, M, N]."""
    route: str            # "wgmma", "splitk" or "simt"
    K: int
    F: int
    tile_m: int
    tile_n: int
    splits: int
    kc: int
    grid: Tuple[int, int]
    sq_part: int
    part: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, K: int, F: int, glu: bool, dtype: torch.dtype) -> Plan:
    """The route, tile, K split and scratch sizes of a dense fused linear
    x [M, K] @ w [K, 2F if glu else F] in ``dtype``: fp32 -> the SIMT
    kernel; bf16 -> the split-K stream for M <= SPLITK_MAX_M, else the
    tensor-core tile.  Pure: the one place these choices are made."""
    if dtype == torch.float32:
        tm, tn = (16, 64) if M <= SIMT_SMALL_M else (128, 64 if glu else 128)
        cols = _cdiv(F, tn)
        return Plan("simt", K, F, tm, tn, 0, 0, (_cdiv(M, tm), cols),
                    cols * M, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_linear kernel: {dtype} must be bfloat16 or "
                         "float32")
    kp, fp = _cdiv(K, 8) * 8, _cdiv(F, 8) * 8
    if M <= SPLITK_MAX_M:
        n = 2 * fp if glu else fp
        rows = next(r for r in SK_ROWS if M <= r)
        cols = _cdiv(n, SK_COLS)
        want = max(1, SK_BLOCKS // cols)
        kc = _cdiv(_cdiv(kp, want), SK_KC_STEP) * SK_KC_STEP
        kc = max(SK_KC_STEP, min(kc, SK_STAGE // rows))
        splits = _cdiv(kp, kc)
        return Plan("splitk", kp, fp, rows, SK_COLS, splits, kc,
                    (cols, splits), 0, splits * M * n)
    tn = TC_BW // 2 if glu else TC_BW
    cols = _cdiv(fp, tn)
    return Plan("wgmma", kp, fp, TC_BM, tn, 0, 0, (_cdiv(M, TC_BM), cols),
                cols * M, 0)


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    """How one int4-BFP fused-linear or int4-matmul call runs
    (``plan_int4``).

    ``F``: the output columns the kernels write, F padded to a multiple of
    INT4_F_STEP (the codes' halves, scale and residual padded with it).
    ``Gq``: a K-group's width in the tile's mantissa operand, G padded to
    a multiple of INT4_K_STEP.  ``tile_m`` x ``tile_n``: rows (register
    rows >= M on the stream) x code columns of one block.  ``group_split``
    K-groups per split and ``splits`` splits on the stream, whose grid is
    (blocks per cluster along K, column tiles); 0 and 0 on the tile, whose
    grid is (row tiles, column tiles).  Scratch, in entries: ``mant``
    int8 mantissas [M, C·Gq] and ``steps`` f32 [C, M] (the tile's
    pre-pass), ``sq_part`` f32 Σy² partials, one per row and column tile
    (per column tile and cluster rank on the stream), needed with Σy²
    only."""
    route: str            # "tc" or "stream"
    F: int
    Gq: int
    tile_m: int
    tile_n: int
    group_split: int
    splits: int
    grid: Tuple[int, int]
    mant: int
    steps: int
    sq_part: int


def plan_int4(M: int, K: int, F: int, G: int, C: int, glu: bool,
              dtype: torch.dtype) -> Int4Plan:
    """The route, tile, K split and scratch sizes of an int4-BFP call
    x [M, K] x codes [G·C, 2F if glu else F] in ``dtype`` (bf16 or fp32):
    the tensor-core tile for M > INT4_STREAM_MAX_M, else the split-K code
    stream, whose splits take whole K-groups, enough of them that about
    INT4_STREAM_WANT warps stream the codes, and at most INT4_STREAM_WARPS
    x INT4_MAX_CLUSTER splits.  Pure: the one place these choices are
    made (``int4_matmul`` takes it with glu False)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4 kernels: {dtype} must be bfloat16 or "
                         "float32")
    if not 0 < G <= MAX_GROUP or K > G * C:
        raise ValueError(f"int4 kernels take groups of 1..{MAX_GROUP} rows "
                         f"covering K, got G={G}, C={C}, K={K}")
    fp = _cdiv(F, INT4_F_STEP) * INT4_F_STEP
    gq = _cdiv(G, INT4_K_STEP) * INT4_K_STEP
    tiles = _cdiv(fp, INT4_COLS // 2 if glu else INT4_COLS)
    if M > INT4_STREAM_MAX_M:
        return Int4Plan("tc", fp, gq, INT4_TC_BM, INT4_COLS, 0, 0,
                        (_cdiv(M, INT4_TC_BM), tiles), M * C * gq, C * M,
                        tiles * M)
    rows = next(r for r in INT4_STREAM_ROWS if M <= r)
    gps = max(_cdiv(C, INT4_STREAM_WARPS * INT4_MAX_CLUSTER),
              min(C, _cdiv(tiles * C, INT4_STREAM_WANT)))
    splits = _cdiv(C, gps)
    ranks = _cdiv(splits, INT4_STREAM_WARPS)
    return Int4Plan("stream", fp, gq, rows, INT4_COLS, gps, splits,
                    (ranks, tiles), 0, 0, tiles * ranks * M)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("fused_linear")
        if dtype == torch.bfloat16:
            fn = lib.fused_linear_bf16
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
                + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]
        else:
            fn = lib.fused_linear_f32
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
                + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def _fn_int4(dtype: torch.dtype):
    if dtype not in _FNS_INT4:
        lib = build.load("fused_linear_int4")
        fn = lib.fused_linear_int4_bf16 if dtype == torch.bfloat16 \
            else lib.fused_linear_int4_f32
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS_INT4[dtype] = fn
    return _FNS_INT4[dtype]


def fused_linear(x: torch.Tensor, w: Optional[torch.Tensor] = None, *,
                 w_codes: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 mean_sq: Optional[torch.Tensor] = None,
                 gamma: Optional[torch.Tensor] = None, eps: float = 1e-5,
                 glu: bool = False, act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None,
                 gate_mul: Optional[torch.Tensor] = None,
                 emit_sq: bool = False):
    """x: [M, K] × w [K, N] (dense) or int4 ``w_codes`` [Kw >= K, N] with
    ``scale`` [Kw/G, N] -> (out [M, F], Σy² [M] f32 or None); F = N/2 with
    ``glu`` (the weight is the widened [gate | up] one), else F = N."""
    if (w is None) == (w_codes is None):
        raise ValueError("fused_linear takes exactly one of w / w_codes")
    kw = dict(mean_sq=mean_sq, gamma=gamma, eps=eps, glu=glu,
              residual=residual, gate_mul=gate_mul, emit_sq=emit_sq)
    if x.device.type == "cpu":
        return ref.fused_linear_ref(x, w, w_codes=w_codes, scale=scale,
                                    act_name=act, **kw)
    if w_codes is not None:
        return fused_linear_int4_cuda(x, w_codes, scale, act=act, **kw)
    return fused_linear_cuda(x, w, act=act, **kw)


def _opt(t: Optional[torch.Tensor], dtype, shape, what: str):
    if t is None:
        return None
    if not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_linear {what}: need a CUDA tensor of shape "
                         f"{tuple(shape)}, got {t.device} {tuple(t.shape)}")
    return t.to(dtype).contiguous()


def _check_common(x, N, act, mean_sq, gamma, glu):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_linear kernel: x {x.dtype} must be "
                         "bfloat16 or float32")
    if act not in _ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    if (mean_sq is None) != (gamma is None):
        raise ValueError("the norm prologue needs both mean_sq and gamma")
    if glu and N % 2:
        raise ValueError(f"GLU weight width {N} is odd")
    return N // 2 if glu else N


def _epilogue_buffers(x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq,
                      sq_part):
    """The optional inputs checked and made contiguous, the output, and
    Σy² with its scratch of ``sq_part`` partials."""
    K = x.shape[1]
    mean_sq = _opt(mean_sq, torch.float32, (M,), "mean_sq")
    gamma = _opt(gamma, x.dtype, (K,), "gamma")
    residual = _opt(residual, x.dtype, (M, F), "residual")
    gate_mul = _opt(gate_mul, torch.float32, (M,), "gate_mul")
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    sq = part = None
    if emit_sq:
        sq = torch.empty((M,), dtype=torch.float32, device=x.device)
        if sq_part:
            part = torch.empty((sq_part,), dtype=torch.float32,
                               device=x.device)
    return mean_sq, gamma, residual, gate_mul, out, sq, part


def _p(t):
    return None if t is None else t.data_ptr()


def _n(t) -> int:
    return 0 if t is None else t.numel()


def _padded(x, w, gamma, residual, p: Plan, K: int, F: int, glu: bool):
    """x, w, gamma and the residual as the bf16 routes read them: K and F
    zero-padded to multiples of 8 (only shapes off those multiples are
    copied; no llama2-7b width is), the GLU's up half at column p.F.
    Padded columns come out 0 and add 0 to Σy²."""
    if p.K != K:
        x = torch.nn.functional.pad(x, (0, p.K - K))
        if gamma is not None:
            gamma = torch.nn.functional.pad(gamma, (0, p.K - K))
    if p.K != K or p.F != F:
        wp = w.new_zeros((p.K, 2 * p.F if glu else p.F))
        wp[:K, :F] = w[:, :F]
        if glu:
            wp[:K, p.F:p.F + F] = w[:, F:]
        w = wp
    if residual is not None and p.F != F:
        residual = torch.nn.functional.pad(residual, (0, p.F - F))
    return x, w, gamma, residual


def fused_linear_cuda(x, w, *, mean_sq=None, gamma=None, eps=1e-5, glu=False,
                      act=None, residual=None, gate_mul=None, emit_sq=False):
    """The dense CUDA kernels alone (raises for anything they do not take),
    on the route ``plan`` picks."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"fused_linear kernel needs CUDA tensors, got "
                         f"{x.device} / {w.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"fused_linear kernel: x {x.dtype} and w {w.dtype} "
                         "must have one dtype")
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"weight {tuple(w.shape)} does not take K={K}")
    F = _check_common(x, w.shape[1], act, mean_sq, gamma, glu)
    return run_plan(plan(M, K, F, glu, x.dtype), x, w, mean_sq=mean_sq,
                    gamma=gamma, eps=eps, glu=glu, act=act, residual=residual,
                    gate_mul=gate_mul, emit_sq=emit_sq)


def run_plan(p: Plan, x, w, *, mean_sq, gamma, eps, glu, act, residual,
             gate_mul, emit_sq):
    """One launch of plan ``p`` on checked CUDA inputs, its scratch sized
    from the plan; the C entry is told what each buffer holds and refuses
    the call if the grid it launches would write past one."""
    global launches, launches_wgmma, launches_splitk, launches_simt
    M, K = x.shape
    F = w.shape[1] // 2 if glu else w.shape[1]
    x = x.contiguous()
    w = w.contiguous()
    mean_sq, gamma, residual, gate_mul, out, sq, sq_part = _epilogue_buffers(
        x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq, p.sq_part)
    stream = build.stream_ptr(x.device)
    if p.route == "simt":
        err = _fn(x.dtype)(_p(x), _p(mean_sq), _p(gamma), _p(w),
                           _p(residual), _p(gate_mul), _p(out), _p(sq_part),
                           _p(sq), M, K, F, int(glu), _ACTS[act], p.tile_m,
                           p.tile_n, _n(sq_part), float(eps), stream)
    else:
        x, w, gamma, residual = _padded(x, w, gamma, residual, p, K, F, glu)
        kout = out if p.F == F else torch.empty(
            (M, p.F), dtype=x.dtype, device=x.device)
        part = None
        if p.part:
            part = torch.empty((p.part,), dtype=torch.float32,
                               device=x.device)
        err = _fn(x.dtype)(_p(x), _p(mean_sq), _p(gamma), _p(w),
                           _p(residual), _p(gate_mul), _p(kout), _p(sq_part),
                           _p(sq), _p(part), M, p.K, p.F, int(glu),
                           _ACTS[act], p.tile_m, p.tile_n, p.splits, p.kc,
                           _n(sq_part), _n(part), float(eps), stream)
        if kout is not out:
            out.copy_(kout[:, :F])
    build.check(err, f"fused_linear ({p.route})")
    launches += 1
    if p.route == "wgmma":
        launches_wgmma += 1
    elif p.route == "splitk":
        launches_splitk += 1
    else:
        launches_simt += 1
    return out, sq


def check_codes(x: torch.Tensor, w_codes: torch.Tensor,
                scale: torch.Tensor):
    """Checks what the int4 kernels take; returns (G, number of groups)."""
    if not (x.is_cuda and w_codes.is_cuda and scale.is_cuda):
        raise ValueError(f"int4 kernels need CUDA tensors, got {x.device} / "
                         f"{w_codes.device} / {scale.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int4 kernels: x {x.dtype} must be bfloat16 or "
                         "float32")
    if w_codes.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"int4 kernels take int8 codes and float32 scales, "
                         f"got {w_codes.dtype} / {scale.dtype}")
    Kw, N = w_codes.shape
    C = scale.shape[0]
    if x.ndim != 2 or scale.shape[1] != N or C == 0 or Kw % C:
        raise ValueError(f"codes {tuple(w_codes.shape)} / scale "
                         f"{tuple(scale.shape)} / x {tuple(x.shape)} "
                         "do not fit")
    G = Kw // C
    if G > MAX_GROUP or x.shape[1] > Kw:
        raise ValueError(f"int4 kernels take K <= {Kw} and groups of at "
                         f"most {MAX_GROUP} rows, got K={x.shape[1]}, G={G}")
    return G, C


def _padded_int4(w_codes, scale, residual, p: Int4Plan, F: int, glu: bool):
    """Codes, scale and residual with F zero-padded to p.F (the GLU's up
    half at column p.F; only widths off INT4_F_STEP are copied, no
    llama2-7b width is).  Padded columns come out 0 and add 0 to Σy²."""
    if p.F == F:
        return w_codes, scale, residual

    def widen(t):
        wide = t.new_zeros((t.shape[0], 2 * p.F if glu else p.F))
        wide[:, :F] = t[:, :F]
        if glu:
            wide[:, p.F:p.F + F] = t[:, F:]
        return wide

    if residual is not None:
        residual = torch.nn.functional.pad(residual, (0, p.F - F))
    return widen(w_codes), widen(scale), residual


def run_plan_int4(p: Int4Plan, x, w_codes, scale, *, mean_sq=None,
                  gamma=None, eps=1e-5, glu=False, act=None, residual=None,
                  gate_mul=None, emit_sq=False):
    """One launch of int4 plan ``p`` on checked CUDA inputs (the pre-pass
    and the tile, or the stream; then sq_reduce with Σy²), every scratch
    buffer sized from the plan; the C entry is told what each holds and
    refuses the call if the grid it launches would write past one."""
    M, K = x.shape
    N = w_codes.shape[1]
    F = N // 2 if glu else N
    C = scale.shape[0]
    G = w_codes.shape[0] // C
    x = x.contiguous()
    mean_sq, gamma, residual, gate_mul, out, sq, sq_part = _epilogue_buffers(
        x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq, p.sq_part)
    codes, scale, residual = _padded_int4(w_codes.contiguous(),
                                          scale.contiguous(), residual, p, F,
                                          glu)
    kout = out if p.F == F else torch.empty(
        (M, p.F), dtype=x.dtype, device=x.device)
    mant = steps = None
    if p.mant:
        mant = torch.empty((p.mant,), dtype=torch.int8, device=x.device)
        steps = torch.empty((p.steps,), dtype=torch.float32, device=x.device)
    err = _fn_int4(x.dtype)(
        _p(x), _p(mean_sq), _p(gamma), _p(codes), _p(scale), _p(residual),
        _p(gate_mul), _p(kout), _p(mant), _p(steps), _p(sq_part), _p(sq), M,
        K, p.F, G, C, int(glu), _ACTS[act], p.tile_m, p.tile_n,
        p.group_split, p.splits, p.grid[0], p.grid[1], _n(mant), _n(steps),
        _n(sq_part), float(eps), build.stream_ptr(x.device))
    build.check(err, f"int4 ({p.route})")
    if kout is not out:
        out.copy_(kout[:, :F])
    return out, sq


def fused_linear_int4_cuda(x, w_codes, scale, *, mean_sq=None, gamma=None,
                           eps=1e-5, glu=False, act=None, residual=None,
                           gate_mul=None, emit_sq=False):
    """The int4-BFP CUDA kernels alone (raises for anything they do not
    take), on the route ``plan_int4`` picks: codes [Kw >= K, N] int8,
    scale [Kw/G, N] f32, G <= 128."""
    global launches_int4, launches_int4_tc, launches_int4_stream
    M, K = x.shape
    G, C = check_codes(x, w_codes, scale)
    F = _check_common(x, w_codes.shape[1], act, mean_sq, gamma, glu)
    p = plan_int4(M, K, F, G, C, glu, x.dtype)
    out = run_plan_int4(p, x, w_codes, scale, mean_sq=mean_sq, gamma=gamma,
                        eps=eps, glu=glu, act=act, residual=residual,
                        gate_mul=gate_mul, emit_sq=emit_sq)
    launches_int4 += 1
    if p.route == "tc":
        launches_int4_tc += 1
    else:
        launches_int4_stream += 1
    return out
