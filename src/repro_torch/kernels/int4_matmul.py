"""int4-weight matmul with BFP fixed-point accumulation (paper §4.2):
x [M, K] (bf16/fp32) × int4 codes [Kw >= K, N] (int8 storage in [-8, 7])
with per-group scales [Kw/G, N] -> [M, N] in x's dtype.

Kernel: the ``int4_matmul`` entries of ``csrc/fused_linear_int4.cu`` (CUDA
C++, sm_90a), the port of ``int4_matmul_pallas`` in the JAX package's
``kernels/int4_matmul.py``: the fused int4 pipeline with its prologue and
epilogue compiled out.  It carries the lm head; at decode it is bound by
the codes' bytes.  The plain version is ``ref.bfp_matmul_ref`` (the BFP
product, not an exact dequantization).

``int4_matmul`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
MAX_GROUP = 128             # widest K-group the kernel stages
_FNS = {}


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("fused_linear_int4")
        fn = lib.int4_matmul_bf16 if dtype == torch.bfloat16 \
            else lib.int4_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


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


def int4_matmul(x: torch.Tensor, w_codes: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.bfp_matmul_ref(x, w_codes, scale)
    return int4_matmul_cuda(x, w_codes, scale)


def int4_matmul_cuda(x: torch.Tensor, w_codes: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
    G, C = check_codes(x, w_codes, scale)
    M, K = x.shape
    N = w_codes.shape[1]
    x = x.contiguous()
    w_codes = w_codes.contiguous()
    scale = scale.contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _fn(x.dtype)(x.data_ptr(), w_codes.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), M, K, N, G, C,
                       build.stream_ptr(x.device))
    build.check(err, "int4_matmul")
    launches += 1
    return out
