"""Online-softmax GQA attention with absolute-position masking (paper Alg. 2).

Kernel: ``csrc/flash_attention.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``flash_attention_packed`` in the JAX package's
``kernels/flash_attention.py``.  The reference packs the G query heads of a
KV group into rows (``ops._pack_heads``) and copies q, k and v into that
layout; the kernels read q [B, Tq, Hq, dh] and k/v [B, Tk, Hkv, dh] in place
through their strides (the decode cache is never copied), the positions
q_pos [B, Tq] and kv_len [B] (or None = Tk) in place too, and write
[B, Tq, Hq, dh].  Three routes, which ``plan`` picks by dtype and the packed
rows R = G·Tq alone: bf16 with R > ``SPLITKV_MAX_R`` runs the tensor-core
tile (wgmma over a TMA ring; prefill), bf16 with R <= ``SPLITKV_MAX_R`` the
cluster split-KV walk (decode, 16-row prefills), fp32 the SIMT kernel (the
parity instrument).  See the source for the designs, their bounds and
where the bf16 routes round.  The plain version packs q, k, v and the
positions and runs ``ref.flash_attention_packed_ref``.

``flash_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts calls, ``launches_wgmma``, ``launches_splitkv``
and ``launches_simt`` the route each took.  The kernels allocate nothing and
keep no state between calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

launches = 0
launches_wgmma = 0
launches_splitkv = 0
launches_simt = 0
_FNS = {}
_HEAD_DIMS = (32, 64, 80, 128, 256)
_ROUTES = {"simt": 0, "wgmma": 1, "splitkv": 2}

# The tiles csrc/flash_attention.cu instantiates.  plan() chooses among
# them; the C entries refuse any other.
SPLITKV_MAX_R = 16       # bf16 packed rows up to this take the split-KV walk
WG_ROWS, WG_KEYS = 128, 128   # tensor-core tile: rows x keys per K/V tile
WG_KEYS_256 = 64         # dh 256: keys per K/V tile, and one Q buffer
WG_STAGES = 2
WG_MAX_BLOCKS = 132      # persistent tile blocks: one per SM of an H100
SKV_ROWS, SKV_KEYS = 16, 64   # split-KV block: mma rows x keys per tile
SKV_STAGES = 2
SKV_MAX_SPLITS = 8       # blocks per (b, kv-head) cluster
SKV_MIN_KEYS = 64        # keys a split takes at least
SKV_BLOCKS = 256         # split-KV blocks wanted: about two per SM
SKV_SPLIT_STEP = 16      # keys per split, a multiple of this (one warp)
SIMT_ROWS, SIMT_KEYS = 16, 32
SIMT_STATIC_MAX = 48 * 1024   # past this the SIMT tile is dynamic smem
SMEM_MAX = 227 * 1024    # dynamic shared memory a block may opt in to


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one flash-attention call runs (``plan``).

    ``tile_r`` x ``tile_k``: packed rows x keys per K/V tile of a block
    (of a work item on the tile, whose persistent blocks each walk items
    of one (b, kv-head) and 128 rows).  ``splits``, ``kc``: on the
    split-KV route each (b, kv-head) is one cluster of ``splits`` blocks,
    block s walking keys [s·kc, (s+1)·kc) (1 and 0 on the other routes).
    ``grid``: (persistent blocks, 1) on the tile, (splits, b·kv-heads) on
    the split-KV walk, (row tiles, b·kv-heads) on the SIMT kernel.
    ``smem``: dynamic shared memory bytes per block (the SIMT kernel's
    tile is static below ``SIMT_STATIC_MAX``: 0)."""
    route: str            # "wgmma", "splitkv" or "simt"
    tile_r: int
    tile_k: int
    splits: int
    kc: int
    grid: Tuple[int, int]
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(BH: int, R: int, Tk: int, dh: int, dtype: torch.dtype) -> Plan:
    """The route, tiles, split, grid and shared memory of attention over
    BH = B·Hkv (batch, kv-head) problems of R = G·Tq packed rows and Tk
    keys of width dh in ``dtype``: fp32 -> the SIMT kernel; bf16 -> the
    split-KV walk for R <= SPLITKV_MAX_R, else the tensor-core tile.  Pure:
    the one place these choices are made."""
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if dtype == torch.float32:
        # K (rows padded by one float), V, Q and the rows' positions
        tile = (SIMT_KEYS * (2 * dh + 1) + SIMT_ROWS * dh) * 4 + SIMT_ROWS * 4
        return Plan("simt", SIMT_ROWS, SIMT_KEYS, 1, 0,
                    (_cdiv(R, SIMT_ROWS), BH),
                    tile if tile > SIMT_STATIC_MAX else 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel: {dtype} must be bfloat16 "
                         "or float32")
    if R <= SPLITKV_MAX_R:
        want = max(1, min(SKV_MAX_SPLITS, _cdiv(Tk, SKV_MIN_KEYS),
                          _cdiv(SKV_BLOCKS, BH)))
        kc = max(SKV_SPLIT_STEP, _cdiv(_cdiv(Tk, want), SKV_SPLIT_STEP)
                 * SKV_SPLIT_STEP)
        splits = max(1, _cdiv(Tk, kc))
        # Q rows and the ring, rows padded by 8 bf16
        smem = (SKV_ROWS + SKV_STAGES * 2 * SKV_KEYS) * (dh + 8) * 2
        return Plan("splitkv", SKV_ROWS, SKV_KEYS, splits, kc, (splits, BH),
                    smem)
    dhp = _cdiv(dh, 64) * 64      # whole 128-byte rows (dh 80: 128)
    # at dh 256 (O in 128 registers a thread) tiles of 64 keys and one Q
    # buffer, so the block fits SMEM_MAX
    keys, qbufs = (WG_KEYS_256, 1) if dh > 128 else (WG_KEYS, 2)
    # the Q buffers, the ring of K and V tiles, 10 barriers, 1 KB alignment
    smem = (qbufs * WG_ROWS * dhp * 2 + WG_STAGES * 2 * keys * dhp * 2
            + 10 * 8 + 1024)
    items = BH * _cdiv(R, WG_ROWS)
    return Plan("wgmma", WG_ROWS, keys, 1, 0,
                (min(items, WG_MAX_BLOCKS), 1), smem)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 \
            else lib.flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def pack_qkv(q, k, v):
    """[B,Tq,Hq,dh], [B,Tk,Hkv,dh] -> q [B·Hkv, G·Tq, dh] (rows (g, t)),
    k/v [B·Hkv, Tk, dh]: the reference's packed layout (copies)."""
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qp = (q.reshape(B, Tq, Hkv, G, dh).permute(0, 2, 3, 1, 4)
          .reshape(B * Hkv, G * Tq, dh))
    kp = k.permute(0, 2, 1, 3).reshape(B * Hkv, Tk, dh)
    vp = v.permute(0, 2, 1, 3).reshape(B * Hkv, Tk, dh)
    return qp, kp, vp


def pack_positions(q_positions, kv_valid_len, B: int, Hkv: int, G: int,
                   Tk: int):
    """q_positions [B, Tq] -> int32 [B·Hkv, G·Tq]; kv_valid_len [B] (or None
    = Tk) -> int32 [B·Hkv]."""
    Tq = q_positions.shape[1]
    pos = (q_positions.to(torch.int32)[:, None, None, :]
           .expand(B, Hkv, G, Tq).reshape(B * Hkv, G * Tq))
    if kv_valid_len is None:
        kv_len = torch.full((B * Hkv,), Tk, dtype=torch.int32,
                            device=q_positions.device)
    else:
        kv_len = (kv_valid_len.to(torch.int32)[:, None].expand(B, Hkv)
                  .reshape(B * Hkv))
    return pos, kv_len


def flash_attention(q, k, v, q_positions, kv_valid_len=None, *,
                    causal: bool = True, window: int = 0, scale: float):
    """q [B,Tq,Hq,dh]; k/v [B,Tk,Hkv,dh]; q_positions int [B, Tq] (-1 =
    pad); kv_valid_len int [B] or None (= Tk) -> [B,Tq,Hq,dh]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_positions, kv_valid_len,
                                     causal=causal, window=window,
                                     scale=scale)
    return flash_attention_cuda(q, k, v, q_positions, kv_valid_len,
                                causal=causal, window=window, scale=scale)


def flash_attention_plain(q, k, v, q_positions, kv_valid_len=None, *,
                          causal=True, window=0, scale: float):
    """The plain version: pack, ``ref.flash_attention_packed_ref``, unpack."""
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    pos, kv_len = pack_positions(q_positions, kv_valid_len, B, Hkv,
                                 Hq // Hkv, Tk)
    out = ref.flash_attention_packed_ref(
        *pack_qkv(q, k, v), pos, kv_len, causal=causal, window=window,
        scale=scale)
    return (out.reshape(B, Hkv, Hq // Hkv, Tq, dh).permute(0, 3, 1, 2, 4)
            .reshape(B, Tq, Hq, dh))


def _strides(t: torch.Tensor, n: int):
    """The first n element strides of t, a size-1 dimension's replaced by
    the extent of the dimension inside it (the kernels and the tensor maps
    take any stride there; torch may report an arbitrary one)."""
    out = []
    for i in range(n):
        s = t.stride(i)
        if t.shape[i] == 1:
            s = t.stride(i + 1) * t.shape[i + 1]
        out.append(s)
    return out


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows for the bf16 routes: aligned base, strides in whole
    16-byte chunks, unit stride along dh."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in _strides(t, 3)))


def flash_attention_cuda(q, k, v, q_positions, kv_valid_len=None, *,
                         causal=True, window=0, scale: float):
    """The CUDA kernels alone (raises for anything they do not take), on the
    route ``plan`` picks."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors, got "
                         f"{q.device} / {k.device} / {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype} must share bfloat16 or float32")
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if dh not in _HEAD_DIMS or Hq % Hkv or v.shape != k.shape \
            or k.shape[0] != B or k.shape[3] != dh or Tk < 1:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if tuple(q_positions.shape) != (B, Tq) or (
            kv_valid_len is not None and tuple(kv_valid_len.shape) != (B,)):
        kl = None if kv_valid_len is None else tuple(kv_valid_len.shape)
        raise ValueError("flash_attention kernel: q_positions/kv_valid_len "
                         f"shapes {tuple(q_positions.shape)} {kl}")
    G = Hq // Hkv
    return run_plan(plan(B * Hkv, G * Tq, Tk, dh, q.dtype), q, k, v,
                    q_positions, kv_valid_len, causal=causal, window=window,
                    scale=scale)


def run_plan(p: Plan, q, k, v, q_positions, kv_valid_len, *, causal, window,
             scale):
    """One launch of plan ``p`` on checked CUDA inputs; the C entry refuses
    the call if the plan disagrees with the tiles it instantiates."""
    global launches, launches_wgmma, launches_splitkv, launches_simt
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    ok = _aligned if bf16 else (lambda t: t.stride(-1) == 1)
    q, k, v = (t if ok(t) else t.contiguous() for t in (q, k, v))
    pos = q_positions.to(device=q.device, dtype=torch.int32)
    kvl = None if kv_valid_len is None else kv_valid_len.to(
        device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Tq, Hq, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 14)(
        *_strides(q, 3), *_strides(k, 3), *_strides(v, 3), *_strides(out, 3),
        pos.stride(0), pos.stride(1))
    err = _fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        None if kvl is None else kvl.data_ptr(), out.data_ptr(), B, Hkv,
        Hq // Hkv, Tq, Tk, dh, ctypes.addressof(strides), int(causal),
        int(window), float(scale), _ROUTES[p.route], p.tile_r, p.tile_k,
        p.splits, p.kc, p.grid[0], p.grid[1], p.smem,
        build.stream_ptr(q.device))
    build.check(err, f"flash_attention ({p.route})")
    launches += 1
    if p.route == "wgmma":
        launches_wgmma += 1
    elif p.route == "splitkv":
        launches_splitkv += 1
    else:
        launches_simt += 1
    return out
