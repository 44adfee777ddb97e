"""Router logits + RMSNorm mean square in one pass (paper Alg. 1 ll. 4-7).

Kernel: ``csrc/router_stats.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``router_stats_pallas`` in the JAX package's
``kernels/fused_router_rmsnorm.py``.  One kernel under one rule, which
``plan`` applies to bf16 and fp32 x alike: blocks of 1, 2 or 4 rows an
iteration, the most that still give two blocks an SM, persistent past
that (prefill's 2048 rows: 4 a block; decode's 4 rows: a block of 4
warps a row).  A row is added in one order, set by D alone (the order of
the kernel's first version), so its results do not depend on the rows a
block or on the other rows of the call.  See the source for the design and the
bound.  The plain version is ``ref.router_stats_ref``.

``router_stats`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts launches.  The kernel allocates nothing and
keeps no state between calls.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref

launches = 0
_FNS = {}

# What csrc/router_stats.cu instantiates.  plan() chooses among it; the C
# entries refuse any other plan.
ORDER_WARPS = 8           # a row's 256 order threads, 8 warps of them
ROWS_WARPS = 16           # warps of a block, at most
ROWS_GRID_CAP = 264       # persistent past two 16-warp blocks an SM (132)
_ESIZE = {torch.bfloat16: 2, torch.float32: 4}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one router pass runs (``plan``).

    ``grid``: blocks, at most ``ROWS_GRID_CAP`` blocks of 16 warps'
    worth, each walking its iterations.  ``threads``: threads a block,
    8 / vec warps for each of its rows.  ``rows``: rows a block takes an
    iteration (1, 2 or 4, at most 16 warps).  ``vec``: elements of x a
    lane loads at once and order threads it holds (2; 1 where D is odd or
    x's address is not aligned to 2 elements).  ``smem``: dynamic shared
    memory bytes a block (the order warps' sums, 96 a row)."""
    grid: int
    threads: int
    rows: int
    vec: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vec_width(D: int, dtype: torch.dtype, x_ptr: int = 0) -> int:
    """2 where D is even and x's address aligned to 2 elements, else 1."""
    return 2 if D % 2 == 0 and x_ptr % (2 * _ESIZE[dtype]) == 0 else 1


def plan(T: int, D: int, dtype: torch.dtype, x_ptr: int = 0) -> Plan:
    """The grid, threads, rows a block, vector width and shared memory of
    a router pass over x [T, D] of ``dtype`` at address ``x_ptr``.  Pure:
    the one place these choices are made.

    The most rows a block (4, 2, 1 at vec 2; 2, 1 at vec 1) that still
    give 264 blocks, two an SM (T 2048: 4 rows, 264 blocks of 16 warps; T
    453 and T 4: 1 row, a block of 4 warps a row); grid = the iterations,
    at most 264 blocks of 16 warps' worth.  Nothing the wrapper takes is
    refused: an odd D or a misaligned view takes vec 1."""
    if dtype not in _ESIZE:
        raise ValueError(f"router_stats kernel: unsupported dtype {dtype}")
    if T < 0 or D < 0:
        raise ValueError(f"router_stats kernel: T {T}, D {D}")
    vec = vec_width(D, dtype, x_ptr)
    warps_a_row = ORDER_WARPS // vec
    rows = ROWS_WARPS // warps_a_row
    while rows > 1 and _cdiv(T, rows) < ROWS_GRID_CAP:
        rows //= 2
    cap = ROWS_GRID_CAP * ROWS_WARPS // (rows * warps_a_row)
    return Plan(min(_cdiv(T, rows), cap), 32 * warps_a_row * rows, rows, vec,
                rows * ORDER_WARPS * 12)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("router_stats")
        fn = lib.router_stats_bf16 if dtype == torch.bfloat16 \
            else lib.router_stats_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
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
    """The CUDA kernel alone (raises for anything it does not take), on
    the plan ``plan`` makes."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"router_stats kernel needs CUDA tensors, got "
                         f"{x.device} / {w.device}")
    if x.dtype not in _ESIZE:
        raise ValueError(f"router_stats kernel: unsupported dtype {x.dtype}")
    T, D = x.shape
    if w.shape != (D, 2):
        raise ValueError(f"router weight {tuple(w.shape)} != ({D}, 2)")
    x = x.contiguous()
    return run_plan(plan(T, D, x.dtype, x.data_ptr()), x, w)


def run_plan(p: Plan, x: torch.Tensor, w: torch.Tensor):
    """One launch of plan ``p`` on checked CUDA inputs (x contiguous); the
    C entry refuses the call if the plan disagrees with what it
    instantiates."""
    global launches
    T, D = x.shape
    w = w.float().contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    logits = torch.empty((T, 2), dtype=torch.float32, device=x.device)
    mean_sq = torch.empty((T,), dtype=torch.float32, device=x.device)
    err = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), logits.data_ptr(),
                       mean_sq.data_ptr(), T, D, p.grid, p.threads, p.rows,
                       p.vec, p.smem, build.stream_ptr(x.device))
    build.check(err, "router_stats")
    launches += 1
    return logits, mean_sq
