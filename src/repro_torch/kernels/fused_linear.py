"""Fused linear pipeline: RMSNorm prologue x matmul x {GLU, gate_mul,
residual, Σy²} epilogue (paper Alg. 1 + §4.2), over dense weights or int4
codes with per-group power-of-2 scales.

Kernels (CUDA C++, sm_90a), the port of ``fused_linear_pallas`` in the JAX
package's ``kernels/fused_linear.py``:

- ``csrc/fused_linear.cu``, its dense branch (fp32 FMAs);
- ``csrc/fused_linear_int4.cu``, its int4-BFP branch: per row and K-group
  the (normalised) activation becomes a shared exponent with int8
  mantissas, int8×int4 products accumulate exactly in int32, and floating
  point is rebuilt once per group (the paper's float-fixed hybrid PE
  array).

Prefill is bound by operations and decode by weight bytes; see the sources
for their designs and for how Σy² is reduced across output tiles without
atomics.  The plain version is ``ref.fused_linear_ref``.

``fused_linear`` takes the plain version for a CPU tensor and launches the
kernel of its weight type for a CUDA tensor; any other device, or a failed
build or launch, raises.  ``launches`` counts dense launches and
``launches_int4`` int4 launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import int4_matmul as im

launches = 0
launches_int4 = 0
_FNS = {}
_FNS_INT4 = {}
_ACTS = {None: 0, "silu": 1}
_MIN_TILE_N = 64            # smallest output tile width in the kernel


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("fused_linear")
        fn = lib.fused_linear_bf16 if dtype == torch.bfloat16 \
            else lib.fused_linear_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
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


def _epilogue_buffers(x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq):
    """The optional inputs checked and made contiguous, the output, and
    Σy² with its per-tile scratch."""
    K = x.shape[1]
    mean_sq = _opt(mean_sq, torch.float32, (M,), "mean_sq")
    gamma = _opt(gamma, x.dtype, (K,), "gamma")
    residual = _opt(residual, x.dtype, (M, F), "residual")
    gate_mul = _opt(gate_mul, torch.float32, (M,), "gate_mul")
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    sq = part = None
    if emit_sq:
        sq = torch.empty((M,), dtype=torch.float32, device=x.device)
        part = torch.empty((-(-F // _MIN_TILE_N) * M,), dtype=torch.float32,
                           device=x.device)
    return mean_sq, gamma, residual, gate_mul, out, sq, part


def _p(t):
    return None if t is None else t.data_ptr()


def fused_linear_cuda(x, w, *, mean_sq=None, gamma=None, eps=1e-5, glu=False,
                      act=None, residual=None, gate_mul=None, emit_sq=False):
    """The dense CUDA kernel alone (raises for anything it does not take)."""
    global launches
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
    x = x.contiguous()
    w = w.contiguous()
    mean_sq, gamma, residual, gate_mul, out, sq, part = _epilogue_buffers(
        x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq)
    err = _fn(x.dtype)(_p(x), _p(mean_sq), _p(gamma), _p(w), _p(residual),
                       _p(gate_mul), _p(out), _p(part), _p(sq), M, K, F,
                       int(glu), _ACTS[act], float(eps),
                       build.stream_ptr(x.device))
    build.check(err, "fused_linear")
    launches += 1
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
        x, M, F, mean_sq, gamma, residual, gate_mul, emit_sq)
    err = _fn_int4(x.dtype)(
        _p(x), _p(mean_sq), _p(gamma), _p(w_codes), _p(scale), _p(residual),
        _p(gate_mul), _p(out), _p(part), _p(sq), M, K, F, G, C, int(glu),
        _ACTS[act], float(eps), build.stream_ptr(x.device))
    build.check(err, "fused_linear_int4")
    launches_int4 += 1
    return out, sq
