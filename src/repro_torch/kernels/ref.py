"""Plain PyTorch versions of the port's kernels (mirrors of the JAX package's
``kernels/ref.py`` oracles).

The kernel wrappers take these for CPU tensors; ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  They repeat the kernels' arithmetic in
fp32 and are no yardstick of speed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


GELU_C = math.sqrt(2.0 / math.pi)


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh approximation, in y's dtype (fp32 in
    the epilogue): ``y · 0.5 · (1 + tanh(√(2/π) · (y + 0.044715 · y³)))``."""
    return y * (0.5 * (1.0 + torch.tanh(GELU_C * (y + 0.044715
                                                  * (y * y * y)))))


def act(y: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """Epilogue activation (the JAX package's ``fused_linear._act``): SiLU
    (SwiGLU) or GELU's tanh approximation (GeGLU and the non-GLU GELU)."""
    if name is None:
        return y
    if name == "silu":
        return F.silu(y)
    if name == "gelu":
        return gelu_tanh(y)
    raise ValueError(f"unsupported epilogue activation {name!r}")


# ---------------------------------------------------------------------------
# int4 weights: BFP fixed-point product (paper §4.2)
# ---------------------------------------------------------------------------

MBITS = 7          # int8 mantissa: values in [-128, 127], scale 2^7


def bfp_quantize_rows(x: torch.Tensor):
    """x: [..., G] fp32 -> (mant int8 [..., G], 2^e fp32 [..., 1]): one
    shared exponent e = ceil(log2 amax) per row of the group (0 where the
    group is all zero) and int8 mantissas rounded half to even."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    e = torch.ceil(torch.log2(torch.clamp(amax, min=1e-30)))
    e = torch.where(amax == 0, torch.zeros_like(e), e)
    pe = torch.exp2(e)
    mant = torch.clamp(torch.round(x * (2.0 ** MBITS) / pe), -128, 127)
    return mant.to(torch.int8), pe


def bfp_matmul_f32(xf: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor,
                   split_groups: Optional[int] = None) -> torch.Tensor:
    """fp32-in/fp32-out BFP product: per (row, K-group) a shared exponent
    and int8 mantissas, exact integer products with the int4 codes, one
    reconstruction ``· 2^(e-7) · scale`` per group.  ``w_codes`` [Kw, N] may
    be group-padded (Kw >= K); xf [M, K] is zero-padded to match.  The
    integer sums run as fp32 matmuls, exact because |Σ| <= G·128·8 < 2^24
    (in TF32 too: mantissas and codes fit its 10 bits).

    The group terms are summed in ascending order (the tensor-core tile's
    order); with ``split_groups`` = s, the groups are summed in runs of s
    (each from zero, ascending) and the runs added in ascending order, the
    order of the split-K stream whose plan splits K every s groups."""
    M, K = xf.shape
    Kw, N = w_codes.shape
    C = scale.shape[0]
    G = Kw // C
    if Kw != K:
        xf = F.pad(xf, (0, Kw - K))
    mant, pe = bfp_quantize_rows(xf.reshape(M, C, G))
    mant, step = mant.float(), pe[..., 0] * (2.0 ** -MBITS)   # [M, C]
    wg = w_codes.reshape(C, G, N).float()
    run = C if split_groups is None else split_groups
    y = torch.zeros((M, N), dtype=torch.float32, device=xf.device)
    for c0 in range(0, C, run):
        part = torch.zeros_like(y)
        for c in range(c0, min(C, c0 + run)):
            part = part + ((mant[:, c] @ wg[c]) * step[:, c, None]
                           * scale[c].float())
        y = part if split_groups is None else y + part
    return y


def bfp_operand(xf: torch.Tensor, G: int, C: int, Gq: int):
    """The tensor-core tile's BFP operand of xf [M, K <= G·C] (fp32, the
    prologue applied): mantissas int8 [M, C·Gq], each group's G values
    followed by Gq - G zeros, and the steps 2^(e-7) fp32 [C, M]."""
    M, K = xf.shape
    xf = F.pad(xf, (0, G * C - K))
    mant, pe = bfp_quantize_rows(xf.reshape(M, C, G))
    mant = F.pad(mant, (0, Gq - G)).reshape(M, C * Gq)
    return mant, (pe[..., 0] * (2.0 ** -MBITS)).t().contiguous()


def int4_matmul_ref(x: torch.Tensor, w_codes: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Exact-dequant fp32 product (the accuracy target, not the kernels'
    function): x [M, K] @ dequantized codes [Kw >= K, N] -> x's dtype."""
    Kw, N = w_codes.shape
    C = scale.shape[0]
    w = (w_codes.float().reshape(C, Kw // C, N)
         * scale[:, None, :].float()).reshape(Kw, N)
    return (x.float() @ w[:x.shape[1]]).to(x.dtype)


def bfp_matmul_ref(x: torch.Tensor, w_codes: torch.Tensor,
                   scale: torch.Tensor,
                   split_groups: Optional[int] = None) -> torch.Tensor:
    """The int4 matmul kernel's plain version: the BFP product in x's
    dtype (``split_groups``: as in ``bfp_matmul_f32``)."""
    return bfp_matmul_f32(x.float(), w_codes, scale,
                          split_groups).to(x.dtype)


def router_stats_ref(x: torch.Tensor, w: torch.Tensor):
    """x: [T, D]; w: [D, 2] -> (logits f32 [T, 2], mean_sq f32 [T])."""
    xf = x.float()
    return xf @ w.float(), (xf * xf).mean(dim=-1)


def rms_prologue(x: torch.Tensor, mean_sq: torch.Tensor, gamma: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The RMSNorm elementwise phase from injected mean(x²), in fp32:
    ``x · (1 / sqrt(mean_sq + eps)) · gamma``, the expression the CUDA
    kernels use (IEEE sqrt and division on both sides, so an int4 kernel's
    BFP mantissas equal its plain version's)."""
    r = torch.reciprocal(torch.sqrt(mean_sq.float() + eps))
    return x.float() * r[:, None] * gamma.float()


def fused_linear_ref(x, w=None, *, w_codes=None, scale=None, mean_sq=None,
                     gamma=None, eps: float = 1e-5, glu: bool = False,
                     act_name=None, residual=None, gate_mul=None,
                     emit_sq: bool = False,
                     split_groups: Optional[int] = None):
    """The fused linear pipeline: RMSNorm prologue from the injected
    ``mean_sq``, the matmul (exact fp32 for a dense ``w``, the BFP product
    ``bfp_matmul_f32`` for int4 ``w_codes``/``scale``, its groups summed in
    runs of ``split_groups`` when given), GLU / activation,
    gate multiplier, residual add, Σy² of the written rows (fp32,
    pre-cast).  x: [M, K]; w or w_codes: [K' >= K, N] -> (out [M, F] in
    x's dtype, Σy² [M] f32 or None)."""
    xf = x.float()
    if mean_sq is not None:
        xf = rms_prologue(xf, mean_sq, gamma, eps)
    if w_codes is not None:
        y = bfp_matmul_f32(xf, w_codes, scale, split_groups)
    else:
        y = xf @ w.float()
    if glu:
        f = y.shape[-1] // 2
        y = act(y[:, :f], act_name) * y[:, f:]
    else:
        y = act(y, act_name)
    if gate_mul is not None:
        y = y * gate_mul.float()[:, None]
    if residual is not None:
        y = y + residual.float()
    sq = (y * y).sum(dim=-1) if emit_sq else None
    return y.to(x.dtype), sq


def flash_attention_packed_ref(q, k, v, q_pos, kv_len, *, causal: bool = True,
                               window: int = 0, scale: float):
    """Packed-layout attention: q [BH, R, dh]; k/v [BH, Tk, dh];
    q_pos int [BH, R] (-1 = pad); kv_len int [BH].  Rows with no valid key
    come out as zeros."""
    Tk = k.shape[1]
    s = torch.einsum("brd,bkd->brk", q.float() * scale, k.float())
    kv_pos = torch.arange(Tk, device=q.device)
    qp = q_pos[:, :, None]
    mask = kv_pos[None, None, :] < kv_len[:, None, None]
    if causal:
        mask = mask & (kv_pos[None, None, :] <= qp)
    if window:
        mask = mask & (kv_pos[None, None, :] > qp - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("brk,bkd->brd", p, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, q_positions, causal: bool = True,
                        window: int = 0, kv_valid_len=None,
                        softmax_scale: Optional[float] = None):
    """Dense GQA attention oracle.  q: [B,Tq,Hq,dh]; k/v: [B,Tk,Hkv,dh]."""
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Tq, Hkv, G, dh).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    kv_pos = torch.arange(Tk, device=q.device)
    qp = q_positions[:, :, None]
    mask = torch.ones((B, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, None, :] <= qp)
    if window:
        mask = mask & (kv_pos[None, None, :] > qp - window)
    if kv_valid_len is not None:
        mask = mask & (kv_pos[None, None, :] < kv_valid_len[:, None, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, :, None], p,
                    torch.zeros_like(p))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, Hq, dh).to(q.dtype)


def _dequant_pages_ref(pages: torch.Tensor, scales: torch.Tensor,
                       kv_dtype: str) -> torch.Tensor:
    """Exact dequant of int8/int4 page payloads (mirrors
    ``kvcache.paged.dequantize_entries`` without importing it).  In int4,
    byte d holds dim d (low nibble) and dim d + dh/2 (high nibble)."""
    if kv_dtype == "int4":
        c = pages.to(torch.int32)
        pages = torch.cat([((c & 0x0F) ^ 8) - 8,
                           (((c >> 4) & 0x0F) ^ 8) - 8], dim=-1)
    return pages.float() * scales[..., None].float()


def paged_attention_ref(q, k_pages, v_pages, block_table, eff_pos, k_tok,
                        v_tok, *, q_positions,
                        softmax_scale: Optional[float] = None,
                        k_scales=None, v_scales=None, kv_dtype=None):
    """Paged decode attention: a dense gather of each slot's page chain plus
    the in-flight token, masked by effective position.

    q: [B, 1, Hq, dh]; k/v pages: [P, ps, Hkv, dh] (int8 codes, dh/2 wide
    for int4, with ``k_scales``/``v_scales`` [P, ps, Hkv] when
    ``kv_dtype`` is set: the whole pool is dequantized up front);
    block_table: [B, J]; eff_pos: [B, J·ps] (MASKED = int32 max);
    k_tok/v_tok: [B, 1, Hkv, dh]; q_positions: [B, 1] -> [B, 1, Hq, dh]."""
    B, _, Hq, dh = q.shape
    Hkv = k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    G = Hq // Hkv
    if kv_dtype is not None:
        k_pages = _dequant_pages_ref(k_pages, k_scales, kv_dtype)
        v_pages = _dequant_pages_ref(v_pages, v_scales, kv_dtype)

    def chain(pages):
        flat = pages[block_table.reshape(-1).long()]      # [B·J, ps, Hkv, dh]
        return flat.reshape(B, -1, Hkv, dh)

    k = torch.cat([chain(k_pages), k_tok.to(k_pages.dtype)], 1)
    v = torch.cat([chain(v_pages), v_tok.to(v_pages.dtype)], 1)
    qp = q_positions.to(torch.int32)
    pos = torch.cat([eff_pos.to(torch.int32), qp], dim=1)   # [B, E+1]
    qg = q.reshape(B, 1, Hkv, G, dh).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    mask = pos[:, None, :] <= qp[..., None]                 # [B, 1, E+1]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, :, None], p,
                    torch.zeros_like(p))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, 1, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk scan
# ---------------------------------------------------------------------------

def ssd_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """Chunked SSD from a zero state, in fp32 (the JAX package's
    ``models/ssm.py::ssd_scan``).

    xh [B, T, H, P]; dt [B, T, H] (softplus'd, gate-masked: a token with
    dt = 0 decays nothing and adds nothing); A_log [H]; Bm/Cm [B, T, G, N]
    per group, head h reading group h // (H / G).  T is zero-padded to a
    multiple of Q = min(chunk, T).  Returns (y [B, T, H, P] fp32, the
    final state [B, H, P, N] fp32)."""
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[-2:]
    Q = min(chunk, T)
    pad = (-T) % Q
    grp = torch.arange(H, device=xh.device) // (H // G)
    x, d = xh.float(), dt.float()
    bh, ch = Bm.float()[:, :, grp], Cm.float()[:, :, grp]     # [B, T, H, N]
    if pad:
        x, d, bh, ch = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                        for a in (x, d, bh, ch))
    nc = (T + pad) // Q
    x, d, bh, ch = (a.reshape(Bsz, nc, Q, *a.shape[2:])
                    for a in (x, d, bh, ch))
    cum = torch.cumsum(d * -torch.exp(A_log.float()), dim=2)  # [B,nc,Q,H]
    idx = torch.arange(Q, device=xh.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]    # [1,Qi,Qj,1]
    state = xh.new_zeros((Bsz, H, P, N), dtype=torch.float32)
    ys = []
    for c in range(nc):
        cq = cum[:, c]
        dtx = x[:, c] * d[:, c, ..., None]                     # [B,Q,H,P]
        # exp only where j <= i: exp(cum_i - cum_j) overflows above it
        seg = torch.exp(torch.where(tri, cq[:, :, None] - cq[:, None],
                                    float("-inf")))
        scores = torch.einsum("bihn,bjhn->bijh", ch[:, c], bh[:, c]) * seg
        y = torch.einsum("bijh,bjhp->bihp", scores, dtx)
        y = y + torch.einsum("bihn,bhpn->bihp", ch[:, c],
                             state) * torch.exp(cq)[..., None]
        w = torch.exp(cq[:, -1:] - cq)                         # [B,Q,H]
        s_local = torch.einsum("bjhn,bjhp->bhpn", bh[:, c] * w[..., None],
                               dtx)
        state = state * torch.exp(cq[:, -1])[:, :, None, None] + s_local
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, P)[:, :T]
    return y, state


def split_bf16(a: torch.Tensor):
    """fp32 ``a`` as three bf16 terms, each rounded to nearest even: hi =
    bf16(a), mid = bf16(a − hi), lo = bf16(a − hi − mid) (``split_bf16`` of
    ``csrc/warp_mma.cuh``).  They hold all 24 bits of a's significand, so
    hi + mid + lo, summed in fp32, is a bit for bit wherever lo's last bit
    lies within bf16's range (|a| >= 2^-110); below, off by at most
    2^-134."""
    a = a.float()
    hi = a.to(torch.bfloat16)
    r = a - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def ssd_scan_split(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """``ssd_scan_ref`` with the operands rounded as the tensor-core route
    of ``csrc/ssd_scan.cu`` rounds them: x, B and C taken as bf16; the
    scores C·Bᵀ in fp32; W = scores · (exp(cum_i − cum_j) · dt_j) (0 above
    the diagonal), the carried state S and Bᵀ · (exp(cum_Q − cum_j) · dt_j)
    each split into three bf16 terms (``split_bf16``), and each product
    taken term by term against its exact bf16 operand and summed in fp32.
    Same arguments and returns as ``ssd_scan_ref``."""
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[-2:]
    Q = min(chunk, T)
    pad = (-T) % Q
    grp = torch.arange(H, device=xh.device) // (H // G)

    def exact(t):
        return t.to(torch.bfloat16).float()

    def terms(t):
        return [s.float() for s in split_bf16(t)]

    x, d = exact(xh), dt.float()
    bh, ch = exact(Bm)[:, :, grp], exact(Cm)[:, :, grp]       # [B, T, H, N]
    if pad:
        x, d, bh, ch = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                        for a in (x, d, bh, ch))
    nc = (T + pad) // Q
    x, d, bh, ch = (a.reshape(Bsz, nc, Q, *a.shape[2:])
                    for a in (x, d, bh, ch))
    cum = torch.cumsum(d * -torch.exp(A_log.float()), dim=2)  # [B,nc,Q,H]
    idx = torch.arange(Q, device=xh.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]    # [1,Qi,Qj,1]
    state = xh.new_zeros((Bsz, H, P, N), dtype=torch.float32)
    ys = []
    for c in range(nc):
        cq, dc, xc = cum[:, c], d[:, c], x[:, c]
        scores = torch.einsum("bihn,bjhn->bijh", ch[:, c], bh[:, c])
        seg = torch.exp(torch.where(tri, cq[:, :, None] - cq[:, None],
                                    float("-inf")))
        w = torch.where(tri, scores * (seg * dc[:, None]),
                        torch.zeros_like(scores))
        y = sum(torch.einsum("bijh,bjhp->bihp", t, xc) for t in terms(w))
        y = y + sum(torch.einsum("bihn,bhpn->bihp", ch[:, c], t)
                    for t in terms(state)) * torch.exp(cq)[..., None]
        f = torch.exp(cq[:, -1:] - cq) * dc                    # [B,Q,H]
        bt = bh[:, c] * f[..., None]
        s_local = sum(torch.einsum("bjhn,bjhp->bhpn", t, xc)
                      for t in terms(bt))
        state = state * torch.exp(cq[:, -1])[:, :, None, None] + s_local
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, P)[:, :T]
    return y, state
