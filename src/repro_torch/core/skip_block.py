"""Skip-aware submodule composition, masked mode: router → fused norm ×
submodule → gate/residual epilogue (paper Fig. 1 / Alg. 1).

Counterpart of the JAX package's ``core/skip_block.py`` on its fused path
(``use_kernels=True, fuse_linear=True``): the router and the norm's
reduction share one pass over x (the router-stats kernel) where no Σy²
carry exists yet; every later block takes its norm statistics from the
previous block's fused epilogue (``stats['res_sq']``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_reuse, routing
from repro_torch.kernels import ops as kops
from repro_torch.kvcache import history
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm as ssm_mod
from repro_torch.models.layers import Params

Stats = Dict[str, torch.Tensor]


def _router_and_stats(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      routed: bool,
                      carried_sq: Optional[torch.Tensor] = None):
    """(router logits or None, mean(x²)).  With ``carried_sq`` the norm
    reduction is free and only the router product touches x."""
    if carried_sq is not None:
        logits = routing.router_logits(p["router"], x) if routed else None
        return logits, carried_sq
    if routed:
        return kops.fused_router_rmsnorm_stats(x, p["router"]["w"],
                                               p["router"]["b"])
    return None, layers.norm_stats(x)


def _gate(logits, shape, routed: bool, device):
    if not routed:
        ones = torch.ones(shape, dtype=torch.float32, device=device)
        return ones, ones
    return routing.gate_from_logits(logits)


def _routed_stats(p_keep, gate, routed: bool, cfg: ModelConfig,
                  device) -> Stats:
    if routed:
        return routing.router_stats(p_keep, gate, cfg)
    return {"keep_frac": torch.ones((), device=device),
            "router_loss": torch.zeros((), device=device)}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def routed_attention(p: Params, x: torch.Tensor,
                     view: Optional[kv_reuse.KVPair],
                     positions: torch.Tensor, cfg: ModelConfig, *,
                     window: int = 0,
                     carried_sq: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, kv_reuse.KVPair, Stats]:
    """x: [B, T, D].  Returns (x + routed_attn(x), new KV view, stats with
    ``attn_gate`` [B, T] and the Σy²/D carry ``res_sq``)."""
    B, T, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_attention
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, T), routed, x.device)
    inner = p["inner"]
    q, k, v = attn_mod.project_qkv(inner, x, positions, cfg, norm=p["norm"],
                                   stats=nstats)
    if routed and cfg.skip.kv_reuse:
        view = kv_reuse.merge_view(view, k, v, gate)
    else:
        view = kv_reuse.init_view(k, v)
    o = attn_mod.attention_core(q, view[0], view[1], q_positions=positions,
                                cfg=cfg, window=window)
    x, sq = attn_mod.output_proj_fused(inner, o, cfg, residual=x,
                                       gate_mul=gate if routed else None,
                                       emit_sq=True)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["attn_gate"] = gate
    stats["res_sq"] = sq / D
    return x, view, stats


def routed_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               carried_sq: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Stats]:
    """Dense GLU MLP on the fused pipeline, masked routing."""
    B, T, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_mlp
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, T), routed, x.device)
    x, sq = layers.mlp_apply_fused(p["inner"], x, cfg, norm=p["norm"],
                                   stats=nstats, residual=x,
                                   gate_mul=gate if routed else None,
                                   emit_sq=True)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["res_sq"] = sq / D
    return x, stats


def routed_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               carried_sq: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple, Stats]:
    """Mamba block with masked-contribution routing: a skipped token's dt
    is zeroed inside the SSD scan, so it neither updates the state nor
    produces output.  Consumes (but does not emit) the Σy²/D carry.
    Returns (x + ssm(x), ((conv_x, conv_bc), ssm_state), stats with
    ``ssm_gate`` [B, T])."""
    B, T, _ = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_ssm
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, T), routed, x.device)
    xn = layers.norm_apply(p["norm"], x, cfg, stats=nstats)
    y, states = ssm_mod.ssm_apply(p["inner"], xn, cfg,
                                  gate_mask=gate if routed else None)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["ssm_gate"] = gate
    return x + y, states, stats


# ---------------------------------------------------------------------------
# Decode (one new token per sequence, per-layer dense KV cache) and
# chunked prefill (C new tokens per sequence on the same cache)
# ---------------------------------------------------------------------------

def _decode_output_epilogue(inner: Params, o: torch.Tensor, x: torch.Tensor,
                            gate: torch.Tensor, routed: bool,
                            cfg: ModelConfig, stats: Stats) -> torch.Tensor:
    """(o·Wo)·gate + x in one kernel; the Σy²/D carry goes to
    ``stats['res_sq']``.  x: [B, 1, D]; gate: [B]."""
    x, sq = attn_mod.output_proj_fused(
        inner, o, cfg, residual=x,
        gate_mul=gate[:, None] if routed else None, emit_sq=True)
    stats["res_sq"] = sq / x.shape[-1]
    return x


def _row_update(cache: torch.Tensor, new: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """Write one entry per batch row at its own time index, in place.
    cache: [B, Tmax, ...]; new: [B, 1, ...]; t: [B]."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, t.long()] = new[:, 0].to(cache.dtype)
    return cache


def _rows_update(cache: torch.Tensor, new: torch.Tensor,
                 t0: torch.Tensor) -> torch.Tensor:
    """Write C consecutive entries per batch row at [t0, t0 + C) of its
    time axis, in place.  cache: [B, Tcap, ...]; new: [B, C, ...]; t0:
    [B]."""
    B, C = new.shape[:2]
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = t0.long()[:, None] + torch.arange(C, device=cache.device)[None]
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def routed_attention_chunk(p: Params, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           t0: torch.Tensor,
                           kv_prev: Optional[kv_reuse.KVPair],
                           positions: torch.Tensor, cfg: ModelConfig, *,
                           carried_sq: Optional[torch.Tensor] = None):
    """One chunk of resumable prefill: C tokens at offsets [t0, t0 + C).
    x: [B, C, D]; k/v_cache: [B, Tcap, Hkv, dh], time-major, holding this
    layer's view of positions [0, t0) and updated IN PLACE at the chunk's
    rows; t0: [B] int32; kv_prev: the previous layer's merged view of the
    chunk's tokens; positions: [B, C].  Attention runs over the cached
    prefix and the chunk under kv_valid_len = t0 + C (causal masking keeps
    a right-padded final chunk's pads out of every real token).  Returns
    (x, k_cache, v_cache, the chunk's merged view, stats with
    ``attn_gate`` [B, C] and the Σy²/D carry ``res_sq``)."""
    B, C, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_attention
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, C), routed, x.device)
    inner = p["inner"]
    q, k_new, v_new = attn_mod.project_qkv(inner, x, positions, cfg,
                                           norm=p["norm"], stats=nstats)
    if routed and cfg.skip.kv_reuse:
        k_t, v_t = kv_reuse.merge_view(kv_prev, k_new, v_new, gate)
    else:
        k_t, v_t = kv_reuse.init_view(k_new, v_new)
    _rows_update(k_cache, k_t, t0)
    _rows_update(v_cache, v_t, t0)
    o = attn_mod.attention_core(q, k_cache, v_cache, q_positions=positions,
                                cfg=cfg, kv_valid_len=t0 + C)
    x, sq = attn_mod.output_proj_fused(inner, o, cfg, residual=x,
                                       gate_mul=gate if routed else None,
                                       emit_sq=True)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["attn_gate"] = gate
    stats["res_sq"] = sq / D
    return x, k_cache, v_cache, (k_t, v_t), stats


def routed_attention_decode(p: Params, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            t: torch.Tensor,
                            kv_prev: Optional[kv_reuse.KVPair],
                            positions: torch.Tensor, cfg: ModelConfig, *,
                            window: int = 0,
                            carried_sq: Optional[torch.Tensor] = None):
    """One decode step.  x: [B, 1, D]; k/v_cache: [B, Tmax, Hkv, dh],
    updated IN PLACE at row t (the JAX engine donates its cache; here the
    write is the same buffer); t: [B] int32.  Returns (x, k_cache, v_cache,
    the carried single-token view, stats)."""
    B = x.shape[0]
    routed = cfg.skip.enabled and cfg.skip.route_attention
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits[:, 0] if logits is not None else None, (B,),
                         routed, x.device)
    inner = p["inner"]
    q, k_new, v_new = attn_mod.project_qkv(inner, x, positions, cfg,
                                           norm=p["norm"], stats=nstats)
    if routed and cfg.skip.kv_reuse:
        k_t, v_t = kv_reuse.merge_token_view(kv_prev, k_new, v_new, gate)
    else:
        k_t, v_t = k_new, v_new
    _row_update(k_cache, k_t, t)
    _row_update(v_cache, v_t, t)
    o = attn_mod.attention_core(q, k_cache, v_cache, q_positions=positions,
                                cfg=cfg, window=window, kv_valid_len=t + 1)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    x = _decode_output_epilogue(inner, o, x, gate, routed, cfg, stats)
    stats["attn_gate"] = gate
    return x, k_cache, v_cache, (k_t, v_t), stats


def routed_mlp_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      carried_sq: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Stats]:
    """Decode-time MLP routing is the masked path with T = 1."""
    B, _, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_mlp
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits[:, 0] if logits is not None else None, (B,),
                         routed, x.device)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    x, sq = layers.mlp_apply_fused(p["inner"], x, cfg, norm=p["norm"],
                                   stats=nstats, residual=x,
                                   gate_mul=gate[:, None] if routed else None,
                                   emit_sq=True)
    stats["res_sq"] = sq / D
    return x, stats


def routed_ssm_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      conv_state, ssm_state,
                      carried_sq: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Tuple, Stats]:
    """One decode token through a routed Mamba block.  x: [B, 1, D].
    Returns (x + ssm_step(x), new states, stats with ``ssm_gate`` [B])."""
    B = x.shape[0]
    routed = cfg.skip.enabled and cfg.skip.route_ssm
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits[:, 0] if logits is not None else None, (B,),
                         routed, x.device)
    xn = layers.norm_apply(p["norm"], x, cfg, stats=nstats)
    y, states = ssm_mod.ssm_step(p["inner"], xn, cfg, conv_state, ssm_state,
                                 gate_mask=gate if routed else None)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["ssm_gate"] = gate
    return x + y, states, stats


def routed_attention_decode_paged(p: Params, x: torch.Tensor,
                                  kv_prev: Optional[kv_reuse.KVPair],
                                  positions: torch.Tensor, cfg: ModelConfig,
                                  *, paged: Dict, layer: int,
                                  carried_sq: Optional[torch.Tensor] = None):
    """One decode step against the paged entry stream (paper §4.4).

    Past tokens' KV lives in the shared store-once stream; ``paged`` holds
    the step's gathered metadata view (``pos``/``l0``/``l1``/``in_fill``)
    and the store's pages, block table and scales.  This layer selects its
    valid entries by effective position (``kvcache/history.py``).  The
    current token's view ``(k_t, v_t)`` rides along explicitly — it is
    committed to the stream only at the end of the step — and is returned
    for the caller's commit buffer.  ``layer``: this layer's index over the
    attention stack; ``positions`` [B, 1] the token's positions.  Returns
    (x, (k_t, v_t), stats)."""
    B = x.shape[0]
    routed = cfg.skip.enabled and cfg.skip.route_attention
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits[:, 0] if logits is not None else None, (B,),
                         routed, x.device)
    inner = p["inner"]
    q, k_new, v_new = attn_mod.project_qkv(inner, x, positions, cfg,
                                           norm=p["norm"], stats=nstats)
    if routed and cfg.skip.kv_reuse:
        k_t, v_t = kv_reuse.merge_token_view(kv_prev, k_new, v_new, gate)
    else:
        k_t, v_t = k_new, v_new
    eff_pos = history.effective_positions(
        paged["pos"], paged["l0"], paged["l1"], paged["in_fill"], layer)
    # a quantized store carries scale pages; the payload's head dim says
    # int8 (full) or nibble-packed int4 (halved)
    kv_dtype = None
    if "k_scales" in paged:
        kv_dtype = ("int8" if paged["k_pages"].shape[-1] == q.shape[-1]
                    else "int4")
    o = kops.paged_decode_attention(
        q, paged["k_pages"], paged["v_pages"], paged["block_table"],
        eff_pos, k_t, v_t, q_positions=positions,
        k_scales=paged.get("k_scales"), v_scales=paged.get("v_scales"),
        kv_dtype=kv_dtype)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    x = _decode_output_epilogue(inner, o, x, gate, routed, cfg, stats)
    stats["attn_gate"] = gate
    return x, (k_t, v_t), stats
