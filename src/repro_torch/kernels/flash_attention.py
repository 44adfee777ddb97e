"""Online-softmax GQA attention with absolute-position masking (paper Alg. 2).

Kernel: ``csrc/flash_attention.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``flash_attention_packed`` in the JAX package's
``kernels/flash_attention.py``.  The reference packs the G query heads of a
KV group into rows (``ops._pack_heads``) and copies q, k and v into that
layout; the kernel reads q [B, Tq, Hq, dh] and k/v [B, Tk, Hkv, dh] in place
through their strides (the decode cache is never copied) and writes
[B, Tq, Hq, dh].  Only the positions are packed: ``pack_positions``.  See
the source for the design and bound.  The plain version packs q, k and v and
runs ``ref.flash_attention_packed_ref``.

``flash_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; any other device, or a failed build or launch,
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
_FNS = {}
_HEAD_DIMS = (32, 64, 128)


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 \
            else lib.flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
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


def flash_attention(q, k, v, q_pos, kv_len, *, causal: bool = True,
                    window: int = 0, scale: float):
    """q [B,Tq,Hq,dh]; k/v [B,Tk,Hkv,dh]; q_pos int32 [B·Hkv, G·Tq]
    (-1 = pad); kv_len int32 [B·Hkv] -> [B,Tq,Hq,dh]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_len, causal=causal,
                                     window=window, scale=scale)
    return flash_attention_cuda(q, k, v, q_pos, kv_len, causal=causal,
                                window=window, scale=scale)


def flash_attention_plain(q, k, v, q_pos, kv_len, *, causal=True, window=0,
                          scale: float):
    """The plain version: pack, ``ref.flash_attention_packed_ref``, unpack."""
    B, Tq, Hq, dh = q.shape
    Hkv = k.shape[2]
    out = ref.flash_attention_packed_ref(
        *pack_qkv(q, k, v), q_pos, kv_len, causal=causal, window=window,
        scale=scale)
    return (out.reshape(B, Hkv, Hq // Hkv, Tq, dh).permute(0, 3, 1, 2, 4)
            .reshape(B, Tq, Hq, dh))


def flash_attention_cuda(q, k, v, q_pos, kv_len, *, causal=True, window=0,
                         scale: float):
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
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
            or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    G = Hq // Hkv
    if q_pos.shape != (B * Hkv, G * Tq) or kv_len.shape != (B * Hkv,):
        raise ValueError("flash_attention kernel: q_pos/kv_len shapes "
                         f"{tuple(q_pos.shape)} {tuple(kv_len.shape)}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    if k.stride(-1) != 1:
        k = k.contiguous()
    if v.stride(-1) != 1:
        v = v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, Tq, Hq, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2))
    err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       q_pos.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                       B, Hkv, G, Tq, Tk, dh, ctypes.addressof(strides),
                       int(causal), int(window), float(scale),
                       build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    launches += 1
    return out
