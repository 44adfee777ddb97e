"""Router logits + RMSNorm mean square in one pass (paper Alg. 1 ll. 4-7).

Kernel: ``csrc/router_stats.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``router_stats_pallas`` in the JAX package's
``kernels/fused_router_rmsnorm.py``.  It is bound by reading x once; see the
source for its design.  The plain version is ``ref.router_stats_ref``.

``router_stats`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
_FNS = {}


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("router_stats")
        fn = lib.router_stats_bf16 if dtype == torch.bfloat16 \
            else lib.router_stats_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def router_stats(x: torch.Tensor, w: torch.Tensor):
    """x: [T, D]; w: [D, 2] -> (logits [T, 2] f32, mean_sq [T] f32)."""
    if x.device.type == "cpu":
        return ref.router_stats_ref(x, w)
    return router_stats_cuda(x, w)


def router_stats_cuda(x: torch.Tensor, w: torch.Tensor):
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"router_stats kernel needs CUDA tensors, got "
                         f"{x.device} / {w.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"router_stats kernel: unsupported dtype {x.dtype}")
    T, D = x.shape
    if w.shape != (D, 2):
        raise ValueError(f"router weight {tuple(w.shape)} != ({D}, 2)")
    x = x.contiguous()
    w = w.float().contiguous()
    logits = torch.empty((T, 2), dtype=torch.float32, device=x.device)
    mean_sq = torch.empty((T,), dtype=torch.float32, device=x.device)
    err = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), logits.data_ptr(),
                       mean_sq.data_ptr(), T, D, build.stream_ptr(x.device))
    build.check(err, "router_stats")
    launches += 1
    return logits, mean_sq
