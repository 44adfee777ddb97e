"""Paged decode attention over the §4.4 store-once entry stream.

Kernel: ``csrc/paged_attention.cu`` (CUDA C++, sm_90a), the port of the TPU
kernel ``paged_attention_packed`` in the JAX package's
``kernels/paged_attention.py`` together with the fold of the in-flight
token in its ``ops.paged_decode_attention``.  The TPU kernel walks every
page of a slot's chain at every layer and masks entry by entry; this one
reads the slot's ``eff_pos`` row in full and loads K/V only for the entries
it admits (see the source for the design and bound).  Its output is the
folded, normalized attention, as the reference's ``ops`` function returns.
The plain version is ``ref.paged_attention_ref`` (a dense gather of the
chain, the whole pool dequantized first).

``paged_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; any other device, or a failed build or
launch, raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
_FNS = {}
_HEAD_DIMS = (32, 64, 128)
_PAYLOAD = {None: 0, "int8": 1, "int4": 2}


def _fn(dtype: torch.dtype):
    if dtype not in _FNS:
        lib = build.load("paged_attention")
        fn = lib.paged_attention_bf16 if dtype == torch.bfloat16 \
            else lib.paged_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return _FNS[dtype]


def paged_attention(q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
                    q_positions, *, scale: float, k_scales=None,
                    v_scales=None, kv_dtype=None):
    """q [B,1,Hq,dh]; k/v pages [P,ps,Hkv,dhp]; block_table [B,J];
    eff_pos [B,J·ps]; k/v_tok [B,1,Hkv,dh]; q_positions [B,1]
    -> [B,1,Hq,dh] in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(
            q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
            q_positions=q_positions, softmax_scale=scale, k_scales=k_scales,
            v_scales=v_scales, kv_dtype=kv_dtype)
    return paged_attention_cuda(
        q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
        q_positions, scale=scale, k_scales=k_scales, v_scales=v_scales,
        kv_dtype=kv_dtype)


def paged_attention_cuda(q, k_pages, v_pages, block_table, eff_pos, k_tok,
                         v_tok, q_positions, *, scale: float, k_scales=None,
                         v_scales=None, kv_dtype=None):
    """The CUDA kernel alone (raises for anything it does not take)."""
    global launches
    tensors = [q, k_pages, v_pages, block_table, eff_pos, k_tok, v_tok,
               q_positions]
    if kv_dtype is not None:
        tensors += [k_scales, v_scales]
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise ValueError("paged_attention kernel needs CUDA tensors, got "
                         + ", ".join(str(getattr(t, "device", None))
                                     for t in tensors))
    if kv_dtype not in _PAYLOAD:
        raise ValueError(f"paged_attention kernel: kv_dtype {kv_dtype!r}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"paged_attention kernel: q {q.dtype} must be "
                         "bfloat16 or float32")
    B, one, Hq, dh = q.shape
    P, ps, Hkv, dhp = k_pages.shape
    J = block_table.shape[1]
    want_dhp = dh // 2 if kv_dtype == "int4" else dh
    want_page = q.dtype if kv_dtype is None else torch.int8
    if (one != 1 or dh not in _HEAD_DIMS or Hkv == 0 or Hq % Hkv
            or dhp != want_dhp or v_pages.shape != k_pages.shape
            or k_pages.dtype != want_page or v_pages.dtype != want_page
            or block_table.shape != (B, J) or eff_pos.shape != (B, J * ps)
            or k_tok.shape != (B, 1, Hkv, dh) or v_tok.shape != k_tok.shape
            or q_positions.shape != (B, 1)):
        raise ValueError(
            f"paged_attention kernel: shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)} {k_pages.dtype} block_table "
            f"{tuple(block_table.shape)} eff_pos {tuple(eff_pos.shape)} "
            f"k_tok {tuple(k_tok.shape)} q_positions "
            f"{tuple(q_positions.shape)} (kv_dtype {kv_dtype})")
    if kv_dtype is not None and (k_scales.shape != (P, ps, Hkv)
                                 or v_scales.shape != (P, ps, Hkv)):
        raise ValueError("paged_attention kernel: scales must be "
                         f"[{P}, {ps}, {Hkv}]")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention kernel: pages must be contiguous")
    q = q.contiguous()
    k_tok = k_tok.to(q.dtype).contiguous()
    v_tok = v_tok.to(q.dtype).contiguous()
    block_table = block_table.to(torch.int32).contiguous()
    eff_pos = eff_pos.to(torch.int32).contiguous()
    q_pos = q_positions.to(torch.int32).reshape(B).contiguous()
    ks = vs = None
    if kv_dtype is not None:
        ks = k_scales.to(torch.float32).contiguous()
        vs = v_scales.to(torch.float32).contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel: pages must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    err = _fn(q.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), block_table.data_ptr(),
        eff_pos.data_ptr(), k_tok.data_ptr(), v_tok.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), B, P, ps, Hkv, Hq // Hkv, J, dh,
        _PAYLOAD[kv_dtype], float(scale), build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    launches += 1
    return out
