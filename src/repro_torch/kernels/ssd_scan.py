"""Mamba-2 SSD chunk scan: y and the final state from a zero state.

Kernel: ``csrc/ssd_scan.cu`` (CUDA C++, sm_90a), the port of the TPU kernel
``ssd_scan_pallas`` in the JAX package's ``kernels/ssd_scan.py``.  One block
per (batch, head) walks the chunks in order with the state in shared
memory, and writes the final state too (the TPU kernel leaves it to the jnp
scan); see the source for its design and bound.  The plain version is
``ref.ssd_scan_ref``.

``ssd_scan`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
MAX_SMEM_BYTES = 232_448          # a block's dynamic shared memory on sm_90
_FNS = {}


def _lib():
    lib = build.load("ssd_scan")
    if "smem" not in _FNS:
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        _FNS["smem"] = lib.ssd_scan_smem_bytes
    return lib


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = _lib()
        fn = lib.ssd_scan_bf16 if dtype == torch.bfloat16 \
            else lib.ssd_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel loads 4 elements at a
    time); a misaligned view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """xh [B, T, H, P]; dt [B, T, H] f32; A_log [H] f32; Bm/Cm [B, T, G, N]
    -> (y [B, T, H, P] f32, state [B, H, P, N] f32)."""
    if xh.device.type == "cpu":
        return ref.ssd_scan_ref(xh, dt, A_log, Bm, Cm, chunk)
    return ssd_scan_cuda(xh, dt, A_log, Bm, Cm, chunk)


def ssd_scan_cuda(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
    ts = (xh, dt, A_log, Bm, Cm)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_scan kernel needs CUDA tensors, got "
                         + ", ".join(str(t.device) for t in ts))
    if xh.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ssd_scan kernel: unsupported dtype {xh.dtype}")
    if Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise ValueError(f"ssd_scan kernel: B/C dtype {Bm.dtype}/{Cm.dtype} "
                         f"!= x dtype {xh.dtype}")
    B, T, H, P = xh.shape
    G, N = Bm.shape[-2:]
    if (dt.shape != (B, T, H) or A_log.shape != (H,)
            or Bm.shape != (B, T, G, N) or Cm.shape != Bm.shape
            or H % G):
        raise ValueError(f"ssd_scan kernel: shapes x {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    Q = min(chunk, T)
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    _lib()
    smem = _FNS["smem"](Q, P, N)
    if smem < 0 or smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan kernel: chunk {Q}, P {P}, N {N} outside "
                         "its tiles (Q <= 128, N <= 128 a multiple of 8, "
                         "P <= 64 a multiple of 4) or its shared memory")
    xh, Bm, Cm = (_aligned(t) for t in (xh, Bm, Cm))
    dt = dt.float().contiguous()
    A_log = A_log.float().contiguous()
    err = _fn(xh.dtype)(xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                        state.data_ptr(), B, T, H, P, N, G, Q,
                        build.stream_ptr(xh.device))
    build.check(err, "ssd_scan")
    launches += 1
    return y, state
