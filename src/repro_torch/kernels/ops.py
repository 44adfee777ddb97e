"""Public wrappers around the port's kernels (counterpart of the JAX
package's ``kernels/ops.py``).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
kernel's plain version, a CUDA tensor takes the kernel, which raises if its
build or launch fails.  There is no fallback and no switch.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import fused_router_rmsnorm as frr
from repro_torch.kernels import int4_matmul as im
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss


# Launch counters: (module, attribute) of each, by kernel name; the fused
# linear (dense and int4), the int4 matmul, flash and paged attention and
# the SSD scan also by the route each call took (``fl.plan``,
# ``fl.plan_int4``, ``fa.plan``, ``pa.plan``, ``ss.plan``).
_COUNTERS = {
    "router_stats": (frr, "launches"), "fused_linear": (fl, "launches"),
    "fused_linear_wgmma": (fl, "launches_wgmma"),
    "fused_linear_splitk": (fl, "launches_splitk"),
    "fused_linear_simt": (fl, "launches_simt"),
    "fused_linear_int4": (fl, "launches_int4"),
    "fused_linear_int4_tc": (fl, "launches_int4_tc"),
    "fused_linear_int4_stream": (fl, "launches_int4_stream"),
    "int4_matmul": (im, "launches"), "int4_matmul_tc": (im, "launches_tc"),
    "int4_matmul_stream": (im, "launches_stream"),
    "flash_attention": (fa, "launches"),
    "flash_attention_wgmma": (fa, "launches_wgmma"),
    "flash_attention_splitkv": (fa, "launches_splitkv"),
    "flash_attention_simt": (fa, "launches_simt"),
    "paged_attention": (pa, "launches"),
    "paged_attention_split": (pa, "launches_split"),
    "paged_attention_simt": (pa, "launches_simt"),
    "ssd_scan": (ss, "launches"), "ssd_scan_tc": (ss, "launches_tc"),
    "ssd_scan_simt": (ss, "launches_simt")}


def kernel_launches() -> dict:
    """Launch counts of every kernel wrapper, by counter name."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _COUNTERS.items()}


def set_kernel_launches(counts: dict) -> None:
    """Set every counter named in ``counts``."""
    for k, n in counts.items():
        mod, attr = _COUNTERS[k]
        setattr(mod, attr, n)


# The device kernels that one counted launch runs, by the kernel's name in a
# trace (``csrc/*.cu``): a CUDA graph's replay runs them without passing
# through the wrappers, so a traced replay is held against these.  The int4
# fused linear and the int4 matmul share one C entry, so their routes run
# the same kernels.
DEVICE_KERNELS = {
    "router_pass": ("router_stats",),
    "fused_linear_tc": ("fused_linear_wgmma",),
    "splitk_stream": ("fused_linear_splitk",),
    "splitk_epilogue": ("fused_linear_splitk",),
    "fused_linear_kernel": ("fused_linear_simt",),
    "bfp_prepass": ("fused_linear_int4_tc", "int4_matmul_tc"),
    "int4_tc": ("fused_linear_int4_tc", "int4_matmul_tc"),
    "int4_stream": ("fused_linear_int4_stream", "int4_matmul_stream"),
    "flash_wgmma": ("flash_attention_wgmma",),
    "flash_splitkv": ("flash_attention_splitkv",),
    "flash_simt": ("flash_attention_simt",),
    "paged_split": ("paged_attention_split",),
    "paged_simt": ("paged_attention_simt",),
    "ssd_scan_tc": ("ssd_scan_tc",),
    "ssd_scan_kernel": ("ssd_scan_simt",)}


_KERNEL_NAME = re.compile(r"([A-Za-z_]\w*)(?:[<(]|$)")


def device_kernel(name: str) -> Optional[str]:
    """The ``DEVICE_KERNELS`` key of a traced kernel's name (``void
    (anonymous namespace)::splitk_stream<4>(float const*, ...)`` →
    ``splitk_stream``), or None for a kernel that is not the port's."""
    m = _KERNEL_NAME.search(name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m and m.group(1) in DEVICE_KERNELS else None


def device_kernel_launches(counts: dict) -> dict:
    """{device kernel: launches} that route counts ``counts`` run."""
    return {kern: sum(counts.get(c, 0) for c in routes)
            for kern, routes in DEVICE_KERNELS.items()}


def reset_kernel_launches() -> None:
    set_kernel_launches(dict.fromkeys(_COUNTERS, 0))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _pack_heads(q, k, v, q_positions, kv_valid_len):
    """The reference's packed layout: q [B·Hkv, G·Tq, dh], k/v
    [B·Hkv, Tk, dh], positions [B·Hkv, G·Tq], kv_len [B·Hkv, 1], meta."""
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qp, kp, vp = fa.pack_qkv(q, k, v)
    pos, kv_len = fa.pack_positions(q_positions, kv_valid_len, B, Hkv, G, Tk)
    return qp, kp, vp, pos, kv_len[:, None], (B, Tq, Hq, Hkv, G, dh)


def flash_attention(q, k, v, *, q_positions, causal: bool = True,
                    window: int = 0, kv_valid_len=None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Tq,Hq,dh]; k/v: [B,Tk,Hkv,dh] -> [B,Tq,Hq,dh]."""
    dh = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    return fa.flash_attention(q, k, v, q_positions, kv_valid_len,
                              causal=causal, window=window, scale=scale)


def decode_attention(q, k, v, *, q_positions, window: int = 0,
                     kv_valid_len=None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q [B,1,Hq,dh] against a [B,Tk,Hkv,dh] cache."""
    return flash_attention(q, k, v, q_positions=q_positions, causal=True,
                           window=window, kv_valid_len=kv_valid_len,
                           softmax_scale=softmax_scale)


def paged_decode_attention(q, k_pages, v_pages, block_table, eff_pos,
                           k_tok, v_tok, *, q_positions,
                           softmax_scale: Optional[float] = None,
                           k_scales=None, v_scales=None, kv_dtype=None
                           ) -> torch.Tensor:
    """Single-token decode against the paged KV store, the in-flight
    token's (k_tok, v_tok) folded in.

    q: [B, 1, Hq, dh]; k/v pages: [P, ps, Hkv, dh] (int8 codes when
    ``kv_dtype`` is set, dh/2 wide for int4, with ``k_scales``/``v_scales``
    [P, ps, Hkv]); block_table: [B, J]; eff_pos: [B, J·ps];
    k_tok/v_tok: [B, 1, Hkv, dh] (full precision); q_positions: [B, 1]."""
    dh = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    return pa.paged_attention(q, k_pages, v_pages, block_table, eff_pos,
                              k_tok, v_tok, q_positions, scale=scale,
                              k_scales=k_scales, v_scales=v_scales,
                              kv_dtype=kv_dtype)


# ---------------------------------------------------------------------------
# Fused router + RMSNorm statistics, fused linear pipeline
# ---------------------------------------------------------------------------

def fused_router_rmsnorm_stats(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor):
    """x: [B, T, D] -> (router logits [B, T, 2] f32, mean_sq [B, T] f32)."""
    B, T, D = x.shape
    logits, ms = frr.router_stats(x.reshape(B * T, D), w)
    return logits.reshape(B, T, 2) + b, ms.reshape(B, T)


def fused_linear(params, x: torch.Tensor, *, mean_sq=None, gamma=None,
                 eps: float = 1e-5, glu: bool = False, act=None,
                 residual=None, gate_mul=None, emit_sq: bool = False):
    """Fused linear pipeline over a linear param dict: {"w"} (dense) or
    {"w_int", "scale"} (int4 codes, per-group scales: the BFP kernel).

    x: [..., K]; ``mean_sq`` [...] + ``gamma`` [K] fuse the RMSNorm
    elementwise phase; ``glu``/``act`` apply the GLU epilogue over a widened
    [gate|up] weight; ``gate_mul`` [...] and ``residual`` [..., F] fuse the
    routed-residual write; with ``emit_sq`` the second return is Σy² per row
    (f32).  Returns (out [..., F], Σy² [...] or None)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if "w_int" in params:
        weight = dict(w_codes=params["w_int"], scale=params["scale"])
    else:
        weight = dict(w=params["w"])
    out, sq = fl.fused_linear(
        x.reshape(-1, K), **weight,
        mean_sq=None if mean_sq is None else mean_sq.reshape(-1),
        gamma=gamma, eps=eps, glu=glu, act=act,
        residual=None if residual is None
        else residual.reshape(-1, residual.shape[-1]),
        gate_mul=None if gate_mul is None else gate_mul.reshape(-1),
        emit_sq=emit_sq)
    out = out.reshape(*lead, out.shape[-1])
    return out, (None if sq is None else sq.reshape(*lead))


# ---------------------------------------------------------------------------
# int4 matmul (BFP accumulation)
# ---------------------------------------------------------------------------

def int4_matmul(x: torch.Tensor, w_codes: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: [..., K] × int4 codes [Kw, N] -> [..., N] in x's dtype.  Kw >= K
    covers group-padded codes (zero rows); x is zero-padded to match."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    Kw, N = w_codes.shape
    x2 = x.reshape(-1, K)
    if Kw != K:
        x2 = F.pad(x2, (0, Kw - K))
    return im.int4_matmul(x2, w_codes, scale).reshape(*lead, N)


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk scan
# ---------------------------------------------------------------------------

def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """Chunked SSD from a zero state.  xh [B, T, H, P]; dt [B, T, H] f32
    (softplus'd, gate-masked); A_log [H]; Bm/Cm [B, T, G, N] per group ->
    (y [B, T, H, P] f32, final state [B, H, P, N] f32)."""
    return ss.ssd_scan(xh, dt, A_log, Bm, Cm, chunk)
