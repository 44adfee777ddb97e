"""Mamba-2 SSD chunk scan: y and the final state from a zero state.

Kernel: ``csrc/ssd_scan.cu`` (CUDA C++, sm_90a), the port of the TPU kernel
``ssd_scan_pallas`` in the JAX package's ``kernels/ssd_scan.py``; it also
writes the final state (the TPU kernel leaves it to the jnp scan).  Two
routes, which ``plan`` picks by dtype and shape alone: bf16 x, B and C take
the tensor-core route (``"tc"``: one block per (batch, head, slice of PB
columns of P), every product on mma.sync with the fp32 operand split into
three bf16 terms, exact to fp32; the main path), fp32 inputs the SIMT
kernel (``"simt"``: one block per (batch, head), the CPU ≡ CUDA parity
route).  See the source for the designs and the bound.  The plain version
is ``ref.ssd_scan_ref``; ``ref.ssd_scan_split`` rounds the operands as the
tensor-core route does.

``ssd_scan`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts calls, ``launches_tc`` and ``launches_simt``
the route each took.  The kernels allocate nothing and keep no state
between calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_tc = 0
launches_simt = 0
_FNS = {}
_ROUTES = {"simt": 0, "tc": 1}

# What csrc/ssd_scan.cu instantiates.  plan() chooses among it; the C
# entries refuse any other plan.
TC_THREADS = 256         # 8 warps: a 16-row stripe of the chunk and of N each
TC_STAGES = 2            # B and the x slice of the next chunk load meanwhile
TC_MAX_Q = 128           # chunk rows (padded to a multiple of 16)
TC_MAX_N = 128           # state width, a multiple of 16
TC_PB_WIDE = 64          # P columns a block takes where 64 divides P (one
#                          block a SM: its accumulators want up to 255
#                          registers a thread)
TC_PB_NARROW = 8         # elsewhere (built for two a SM, 128 registers)
BLOCK_SMEM = 232448      # a block's dynamic shared memory, at most
SIMT_THREADS = 256
SIMT_MAX_Q, SIMT_MAX_N, SIMT_MAX_P = 128, 128, 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one SSD scan runs (``plan``).

    ``pb``: P columns a block takes (P on the SIMT kernel).  ``grid``:
    (B·H, P/pb).  ``threads``: threads a block.  ``stages``: load stages
    (2 on the tensor-core route, 1 on the SIMT kernel).  ``smem``: dynamic
    shared memory bytes a block."""
    route: str            # "tc" or "simt"
    pb: int
    grid: Tuple[int, int]
    threads: int
    stages: int
    smem: int


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _x_pitch(pb: int) -> int:
    """bf16 per staged x (and state) row: an odd number of 16-byte groups."""
    return pb + 16 if (pb // 8) % 2 else pb + 8


def tc_smem(Q: int, N: int, pb: int) -> int:
    """Dynamic shared memory of a tensor-core block (``tc::Smem``): two
    stages of B [Qp][N+8] and of the x slice [Qp][pitch] in bf16, the state
    split into three bf16 tiles [N][pitch], four fp32 rows of Qp (cum,
    dt, exp(cum), exp(cum_Q − cum)·dt) and four fp32 partial state stripes
    [16][PB+8] (one per warp pair); Qp = Q padded to 16."""
    Qp, xp = _pad16(Q), _x_pitch(pb)
    return (TC_STAGES * Qp * (N + 8) * 2 + TC_STAGES * Qp * xp * 2
            + 3 * N * xp * 2 + 4 * Qp * 4 + 4 * 16 * (pb + 8) * 4)


def simt_smem(Q: int, P: int, N: int) -> int:
    """Dynamic shared memory of a SIMT block (``simt::Layout``): B [Q][N+1],
    C [Q][N+4], dt·x [Q][P], the state [N][P], 32 score rows [Q+4] and
    three rows of Q, each rounded up to 4 floats."""
    def a4(n):
        return -(-n // 4) * 4
    floats = (a4(Q * (N + 1)) + a4(Q * (N + 4)) + a4(Q * P) + a4(N * P)
              + a4(32 * (Q + 4)) + 3 * a4(Q))
    return 4 * floats


def plan(B: int, T: int, H: int, P: int, N: int, G: int, chunk: int,
         dtype: torch.dtype) -> Plan:
    """The route, P split, grid, threads, stages and shared memory of an SSD
    scan of x [B, T, H, P] with B/C [B, T, G, N] in ``dtype`` and chunks of
    Q = min(chunk, T).  Pure: the one place these choices are made.

    bf16 with N a multiple of 16 (16 <= N <= 128), Q <= 128 and P a
    multiple of 8 -> the tensor-core route, PB 64 where 64 divides P (all
    of mamba2-2.7b's P: every slice computes the scores and loads B and C
    again, so the widest slice is the fastest at its shapes, B 1 included)
    and 8 elsewhere.  Any other shape, and fp32, -> the SIMT kernel, which
    takes Q <= 128, N <= 128 a multiple of 8 and P <= 64 a multiple of 4.
    So bf16 takes the SIMT kernel exactly where N is a multiple of 8 but
    not of 16, or P a multiple of 4 but not of 8; anything else raises."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ssd_scan kernel: unsupported dtype {dtype}")
    Q = min(chunk, T)
    if B < 0 or Q < 1 or H < 1 or G < 1 or H % G:
        raise ValueError(f"ssd_scan kernel: B {B}, T {T}, chunk {chunk}, "
                         f"H {H}, G {G}")
    if (dtype == torch.bfloat16 and N % 16 == 0 and 16 <= N <= TC_MAX_N
            and Q <= TC_MAX_Q and P % 8 == 0):
        pb = TC_PB_WIDE if P % TC_PB_WIDE == 0 else TC_PB_NARROW
        return Plan("tc", pb, (B * H, P // pb), TC_THREADS, TC_STAGES,
                    tc_smem(Q, N, pb))
    if (Q > SIMT_MAX_Q or N < 8 or N > SIMT_MAX_N or N % 8 or P < 4
            or P > SIMT_MAX_P or P % 4):
        raise ValueError(f"ssd_scan kernel: chunk {Q}, P {P}, N {N} outside "
                         "its tiles (Q <= 128, N <= 128 a multiple of 8, "
                         "P <= 64 a multiple of 4)")
    return Plan("simt", P, (B * H, 1), SIMT_THREADS, 1, simt_smem(Q, P, N))


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("ssd_scan")
        fn = lib.ssd_scan_bf16 if dtype == torch.bfloat16 \
            else lib.ssd_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load 16 bytes at a
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
    """The CUDA kernels alone (raises for anything they do not take), on
    the route ``plan`` picks."""
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
    return run_plan(plan(B, T, H, P, N, G, chunk, xh.dtype), xh, dt, A_log,
                    Bm, Cm, chunk)


def run_plan(p: Plan, xh: torch.Tensor, dt: torch.Tensor,
             A_log: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             chunk: int):
    """One launch of plan ``p`` on checked CUDA inputs; the C entry refuses
    the call if the plan disagrees with what it instantiates."""
    global launches, launches_tc, launches_simt
    B, T, H, P = xh.shape
    G, N = Bm.shape[-2:]
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    xh, Bm, Cm = (_aligned(t) for t in (xh, Bm, Cm))
    dt = dt.float().contiguous()
    A_log = A_log.float().contiguous()
    err = _fn(xh.dtype)(xh.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
                        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                        state.data_ptr(), B, T, H, P, N, G, min(chunk, T),
                        _ROUTES[p.route], p.pb, p.grid[0], p.grid[1],
                        p.threads, p.stages, p.smem,
                        build.stream_ptr(xh.device))
    build.check(err, f"ssd_scan ({p.route})")
    launches += 1
    if p.route == "tc":
        launches_tc += 1
    else:
        launches_simt += 1
    return y, state
