"""Fused linear pipeline, dense weights: RMSNorm prologue x matmul x
{GLU, gate_mul, residual, Σy²} epilogue (paper Alg. 1 + §4.2).

Kernel: ``csrc/fused_linear.cu`` (CUDA C++, sm_90a), the port of the dense
branch of ``fused_linear_pallas`` in the JAX package's
``kernels/fused_linear.py``.  Prefill is bound by operations and decode by
weight bytes; see the source for its design and for how Σy² is reduced
across output tiles without atomics.  The plain version is
``ref.fused_linear_ref``.

``fused_linear`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

launches = 0
_FNS = {}
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


def fused_linear(x: torch.Tensor, w: torch.Tensor, *,
                 mean_sq: Optional[torch.Tensor] = None,
                 gamma: Optional[torch.Tensor] = None, eps: float = 1e-5,
                 glu: bool = False, act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None,
                 gate_mul: Optional[torch.Tensor] = None,
                 emit_sq: bool = False):
    """x: [M, K] × w [K, N] -> (out [M, F], Σy² [M] f32 or None); F = N/2
    with ``glu`` (w is the widened [gate | up] weight), else F = N."""
    if x.device.type == "cpu":
        return ref.fused_linear_ref(
            x, w, mean_sq=mean_sq, gamma=gamma, eps=eps, glu=glu,
            act_name=act, residual=residual, gate_mul=gate_mul,
            emit_sq=emit_sq)
    return fused_linear_cuda(x, w, mean_sq=mean_sq, gamma=gamma, eps=eps,
                             glu=glu, act=act, residual=residual,
                             gate_mul=gate_mul, emit_sq=emit_sq)


def _opt(t: Optional[torch.Tensor], dtype, shape, what: str):
    if t is None:
        return None
    if not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_linear {what}: need a CUDA tensor of shape "
                         f"{tuple(shape)}, got {t.device} {tuple(t.shape)}")
    return t.to(dtype).contiguous()


def fused_linear_cuda(x, w, *, mean_sq=None, gamma=None, eps=1e-5, glu=False,
                      act=None, residual=None, gate_mul=None, emit_sq=False):
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"fused_linear kernel needs CUDA tensors, got "
                         f"{x.device} / {w.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise ValueError(f"fused_linear kernel: x {x.dtype} and w {w.dtype} "
                         "must both be bfloat16 or both float32")
    if act not in _ACTS:
        raise ValueError(f"unsupported epilogue activation {act!r}")
    if (mean_sq is None) != (gamma is None):
        raise ValueError("the norm prologue needs both mean_sq and gamma")
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"weight {tuple(w.shape)} does not take K={K}")
    N = w.shape[1]
    if glu and N % 2:
        raise ValueError(f"GLU weight width {N} is odd")
    F = N // 2 if glu else N
    x = x.contiguous()
    w = w.contiguous()
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

    def p(t):
        return None if t is None else t.data_ptr()

    err = _fn(x.dtype)(p(x), p(mean_sq), p(gamma), p(w), p(residual),
                       p(gate_mul), p(out), p(part), p(sq), M, K, F,
                       int(glu), _ACTS[act], float(eps),
                       build.stream_ptr(x.device))
    build.check(err, "fused_linear")
    launches += 1
    return out, sq
