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
  array).

Prefill is bound by operations and decode by weight bytes; see the sources
for their designs, for where the bf16 tile rounds the normalised
activation, and for how Σy² is reduced across tiles without atomics.  The
plain version is ``ref.fused_linear_ref``.

``fused_linear`` takes the plain version for a CPU tensor and launches the
kernel of its weight type for a CUDA tensor; any other device, or a failed
build or launch, raises.  ``launches`` counts dense calls (one per call),
``launches_wgmma``, ``launches_splitk`` and ``launches_simt`` the route each
took, and ``launches_int4`` int4 calls.  The kernels allocate nothing and
keep no state between calls: the wrapper allocates every scratch buffer
per call.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import int4_matmul as im

launches = 0
launches_wgmma = 0
launches_splitk = 0
launches_simt = 0
launches_int4 = 0
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
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
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


INT4_TILE_N = 64         # smallest output tile of fused_linear_int4.cu


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


def fused_linear_int4_cuda(x, w_codes, scale, *, mean_sq=None, gamma=None,
                           eps=1e-5, glu=False, act=None, residual=None,
                           gate_mul=None, emit_sq=False):
    """The int4-BFP CUDA kernel alone (raises for anything it does not
    take): codes [Kw >= K, N] int8, scale [Kw/G, N] f32, G <= 128."""
    global launches_int4
    M, K = x.shape
    G, C = im.check_codes(x, w_codes, scale)
    F = _check_common(x, w_codes.shape[1], act, mean_sq, gamma, glu)
    x = x.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.contiguous()
    mean_sq, gamma, residual, gate_mul, out, sq, part = _epilogue_buffers(
        x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq,
        -(-F // INT4_TILE_N) * M)
    err = _fn_int4(x.dtype)(
        _p(x), _p(mean_sq), _p(gamma), _p(w_codes), _p(scale), _p(residual),
        _p(gate_mul), _p(out), _p(part), _p(sq), M, K, F, G, C, int(glu),
        _ACTS[act], float(eps), build.stream_ptr(x.device))
    build.check(err, "fused_linear_int4")
    launches_int4 += 1
    return out, sq
