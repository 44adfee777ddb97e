"""Skip-aware submodule composition: router → (gather) → fused norm ×
submodule → gate/residual epilogue → (scatter) (paper Fig. 1 / Alg. 1).

Counterpart of the JAX package's ``core/skip_block.py`` on its fused path
(``use_kernels=True, fuse_linear=True``): the router and the norm's
reduction share one pass over x (the router-stats kernel) where no Σy²
carry exists yet; every later block takes its norm statistics from the
previous block's fused epilogue (``stats['res_sq']``).

Masked mode runs every row and multiplies a skipped row's output by its 0
gate.  Gather mode (``cfg.skip.mode == "gather"``, prefill only) runs a
routed submodule on the C = ``routing.capacity(T, keep_prob)`` rows of
highest score ``logits[1] − logits[0]`` and writes them back in place of
their input rows, as the reference does: a selected row whose gate is 0
still writes its KV and gives y·0 + x, a kept row outside the top C is
not run, ``attn_gate`` stays the logit gate, and an unselected row keeps
its carried Σx²/D.  One structural difference: where the reference's
first attention layer (no KV view yet) projects q from the C gathered
rows and k, v from all T rows through column slices of ``wqkv``, the port
runs the one widened qkv projection over all T rows and gathers q's C
rows from it (every row's product is the same either way; a sliced
weight would be copied whole on every call, since the kernels take a
contiguous weight).

A LayerNorm stack (stablelm-3b) takes the reference's unfused branch of
every function here (``layers.fuse_norm_linear`` false): the plain router
product and the two-pass (μ, σ²) pair (no router-stats kernel, and no Σy²
carry: ``stats['res_sq']`` is None), the norm applied to x, the composed
projections (``linear_apply``: ``x @ w``, or the int4 matmul kernel for a
quantized leaf) and ``x + y·gate`` (gather mode: ``x +
scatter_tokens(y·gate)``).  An MoE FFN (``layers.mlp_fusable`` false)
takes the same unfused branch inside a fused RMSNorm stack, as in the
reference: its router and norm statistics come from the attention block's
Σy² carry, then the norm on those statistics, ``moe.moe_apply`` and
``x + y·gate``; it emits no carry (the next attention block launches the
router-stats kernel itself), and its ``moe_lb_loss`` / ``moe_drop_frac``
join the block's stats.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_reuse, routing
from repro_torch.kernels import ops as kops
from repro_torch.kvcache import history
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.layers import Params

Stats = Dict[str, torch.Tensor]


def _router_and_stats(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      routed: bool,
                      carried_sq: Optional[torch.Tensor] = None):
    """(router logits or None, the norm's statistics: mean(x²), or (μ, σ²)
    for LayerNorm).  With ``carried_sq`` the RMS reduction is free and only
    the router product touches x; LayerNorm takes the plain router product
    and ``layers.norm_stats`` and ignores any carry, as the reference."""
    if not layers.fuse_norm_linear(cfg):
        logits = routing.router_logits(p["router"], x) if routed else None
        return logits, layers.norm_stats(x, cfg)
    if carried_sq is not None:
        logits = routing.router_logits(p["router"], x) if routed else None
        return logits, carried_sq
    if routed:
        return kops.fused_router_rmsnorm_stats(x, p["router"]["w"],
                                               p["router"]["b"])
    return None, layers.norm_stats(x)


def _gather_stats(nstats, idx: torch.Tensor):
    """The rows ``idx`` [B, C] of mean(x²) [B, T], or of both halves of a
    LayerNorm's (μ, σ²)."""
    if isinstance(nstats, tuple):
        return tuple(torch.gather(s, 1, idx) for s in nstats)
    return torch.gather(nstats, 1, idx)


def _gated(y: torch.Tensor, gate: torch.Tensor, routed: bool
           ) -> torch.Tensor:
    """y·gate, the composed epilogue of the unfused path (the gate cast to
    y's dtype, as the reference); gate [B, T] or [B, 1]."""
    return y * gate.to(y.dtype)[..., None] if routed else y


def _gate(logits, shape, routed: bool, device):
    if not routed:
        ones = torch.ones(shape, dtype=torch.float32, device=device)
        return ones, ones
    return routing.gate_from_logits(logits)


def _select(logits: torch.Tensor, T: int, cfg: ModelConfig) -> torch.Tensor:
    """Gather mode's rows: idx [B, C] of the top-C router scores
    ``logits[1] − logits[0]`` (not the gate), ascending."""
    return routing.select_topc(logits[..., 1] - logits[..., 0],
                               routing.capacity(T, cfg.skip.keep_prob))


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
    ``attn_gate`` [B, T] and the Σy²/D carry ``res_sq``, None on the
    unfused path).  In gather mode
    the view's rows of the unselected tokens are the previous layer's."""
    B, T, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_attention
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, T), routed, x.device)
    inner = p["inner"]
    if routed and cfg.skip.mode == "gather":
        idx = _select(logits, T, cfg)
        xg = routing.gather_tokens(x, idx)
        pos_g = torch.gather(positions, 1, idx)
        if view is None or not cfg.skip.kv_reuse:
            # dense KV: the view's base case, or no reuse ("PartialSkip")
            q, k, v = attn_mod.project_qkv(inner, x, positions, cfg,
                                           norm=p["norm"], stats=nstats)
            q = routing.gather_tokens(q, idx)
            view = kv_reuse.init_view(k, v)
        else:
            q, kg, vg = attn_mod.project_qkv(
                inner, xg, pos_g, cfg, norm=p["norm"],
                stats=_gather_stats(nstats, idx))
            view = kv_reuse.merge_view_gathered(view, kg, vg, idx, T)
        o = attn_mod.attention_core(q, view[0], view[1], q_positions=pos_g,
                                    cfg=cfg, window=window)
        gate_g = torch.gather(gate, 1, idx)
        if layers.fuse_norm_linear(cfg):
            yg, sq_g = attn_mod.output_proj_fused(
                inner, o, cfg, residual=xg, gate_mul=gate_g, emit_sq=True)
            x = routing.scatter_set_tokens(x, idx, yg)
            res_sq = routing.scatter_set_tokens(nstats, idx, sq_g / D)
        else:
            y = _gated(attn_mod.output_proj(inner, o, cfg), gate_g, True)
            x = x + routing.scatter_tokens(y, idx, T)
            res_sq = None
    else:
        q, k, v = attn_mod.project_qkv(inner, x, positions, cfg,
                                       norm=p["norm"], stats=nstats)
        if routed and cfg.skip.kv_reuse:
            view = kv_reuse.merge_view(view, k, v, gate)
        else:
            view = kv_reuse.init_view(k, v)
        o = attn_mod.attention_core(q, view[0], view[1],
                                    q_positions=positions, cfg=cfg,
                                    window=window)
        x, res_sq = _attn_out(inner, o, x, gate, routed, cfg)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["attn_gate"] = gate
    stats["res_sq"] = res_sq
    return x, view, stats


def _fuse_mlp(p: Params, cfg: ModelConfig) -> bool:
    """Whether the FFN runs the fused pipeline: an RMS stack and a dense
    MLP (the reference's ``fuse_norm_linear(cfg) and mlp_fusable``)."""
    return layers.fuse_norm_linear(cfg) and layers.mlp_fusable(p["inner"])


def _ffn_inner(inner: Params, xn: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Stats]:
    """The unfused FFN on a normalised x: (y, aux) of the dense
    ``mlp_apply`` (no aux), or of the MoE block."""
    if layers.mlp_fusable(inner):
        return layers.mlp_apply(inner, xn, cfg), {}
    return moe_mod.moe_apply(inner, xn, cfg)


def routed_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               carried_sq: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Stats]:
    """Dense GLU MLP or MoE, fused (``stats['res_sq']`` the Σy²/D carry)
    or unfused (None), masked or gather routing.  In gather mode an MoE
    block dispatches the B·C gathered rows."""
    B, T, D = x.shape
    routed = cfg.skip.enabled and cfg.skip.route_mlp
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits, (B, T), routed, x.device)
    aux: Stats = {}
    if routed and cfg.skip.mode == "gather":
        idx = _select(logits, T, cfg)
        xg = routing.gather_tokens(x, idx)
        sg, gate_g = _gather_stats(nstats, idx), torch.gather(gate, 1, idx)
        if _fuse_mlp(p, cfg):
            yg, sq_g = layers.mlp_apply_fused(
                p["inner"], xg, cfg, norm=p["norm"], stats=sg, residual=xg,
                gate_mul=gate_g, emit_sq=True)
            x = routing.scatter_set_tokens(x, idx, yg)
            res_sq = routing.scatter_set_tokens(nstats, idx, sq_g / D)
        else:
            y, aux = _ffn_inner(p["inner"], layers.norm_apply(
                p["norm"], xg, cfg, stats=sg), cfg)
            x = x + routing.scatter_tokens(_gated(y, gate_g, True), idx, T)
            res_sq = None
    else:
        x, res_sq, aux = _mlp_out(p, x, nstats, gate, routed, cfg)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats.update(aux)
    stats["res_sq"] = res_sq
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

def _attn_out(inner: Params, o: torch.Tensor, x: torch.Tensor,
              gate: torch.Tensor, routed: bool, cfg: ModelConfig):
    """The o-projection and residual of every row: (o·Wo)·gate + x in one
    kernel with the Σy²/D carry (fused), or o·Wo composed with x + y·gate
    and no carry (unfused).  x: [B, T, D]; gate [B, T].  Returns (x, the
    carry or None)."""
    if not layers.fuse_norm_linear(cfg):
        return x + _gated(attn_mod.output_proj(inner, o, cfg), gate,
                          routed), None
    x, sq = attn_mod.output_proj_fused(inner, o, cfg, residual=x,
                                       gate_mul=gate if routed else None,
                                       emit_sq=True)
    return x, sq / x.shape[-1]


def _mlp_out(p: Params, x: torch.Tensor, nstats, gate: torch.Tensor,
             routed: bool, cfg: ModelConfig):
    """The FFN and residual of every row: the fused pipeline with the Σy²/D
    carry, or norm, the inner FFN (``mlp_apply`` or ``moe_apply``) and x +
    y·gate with no carry (unfused).  x: [B, T, D]; gate [B, T].  Returns
    (x, the carry or None, the inner FFN's aux)."""
    if not _fuse_mlp(p, cfg):
        y, aux = _ffn_inner(p["inner"], layers.norm_apply(
            p["norm"], x, cfg, stats=nstats), cfg)
        return x + _gated(y, gate, routed), None, aux
    x, sq = layers.mlp_apply_fused(p["inner"], x, cfg, norm=p["norm"],
                                   stats=nstats, residual=x,
                                   gate_mul=gate if routed else None,
                                   emit_sq=True)
    return x, sq / x.shape[-1], {}


def _decode_output_epilogue(inner: Params, o: torch.Tensor, x: torch.Tensor,
                            gate: torch.Tensor, routed: bool,
                            cfg: ModelConfig, stats: Stats) -> torch.Tensor:
    """``_attn_out`` at decode: x [B, 1, D], gate [B]; the Σy²/D carry (None
    unfused) goes to ``stats['res_sq']``."""
    x, stats["res_sq"] = _attn_out(inner, o, x, gate[:, None], routed, cfg)
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
    B, C, _ = x.shape
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
    x, res_sq = _attn_out(inner, o, x, gate, routed, cfg)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    stats["attn_gate"] = gate
    stats["res_sq"] = res_sq
    return x, k_cache, v_cache, (k_t, v_t), stats


def routed_attention_decode(p: Params, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            t: torch.Tensor,
                            kv_prev: Optional[kv_reuse.KVPair],
                            positions: torch.Tensor, cfg: ModelConfig, *,
                            window: int = 0, ring: int = 0,
                            carried_sq: Optional[torch.Tensor] = None):
    """One decode step.  x: [B, 1, D]; k/v_cache: [B, Tmax, Hkv, dh],
    updated IN PLACE at row t (the JAX engine donates its cache; here the
    write is the same buffer); t: [B] int32.  Returns (x, k_cache,
    v_cache, the carried single-token view, stats).

    With ``ring`` = W the cache is a LOCAL layer's sliding-window ring [B,
    W, Hkv, dh] (the reference's ``_ring_attention_decode``): the token's
    merged view (the KV-reuse merge first, as in the reference) is written
    at slot t mod W, then the flash kernel attends the ring with
    kv_valid_len = min(t + 1, W), causal, no window and no key positions.
    Why that is the reference's function: the reference attends through
    ``chunked_attention`` with each slot's position from
    ``ring_positions`` (an empty slot's mapped past t), so a slot counts
    iff it is written and its position is ≤ t.  After the write at slot
    t mod W, the written slots are exactly [0, min(t + 1, W)) and every
    one of them holds a position in (t − W, t].  Attention is a softmax
    over a set of keys, so the order of the slots does not matter: the
    kernel's mask by slot index (< kv_valid_len, and ≤ t, which every
    such slot is) picks the same set.  So the ring is never reordered
    into time order (that would copy the whole ring a step a layer)."""
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
    if ring:
        row, kv_len = torch.remainder(t, ring), torch.clamp(t + 1, max=ring)
    else:
        row, kv_len = t, t + 1
    _row_update(k_cache, k_t, row)
    _row_update(v_cache, v_t, row)
    o = attn_mod.attention_core(q, k_cache, v_cache, q_positions=positions,
                                cfg=cfg, window=window, kv_valid_len=kv_len)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    x = _decode_output_epilogue(inner, o, x, gate, routed, cfg, stats)
    stats["attn_gate"] = gate
    return x, k_cache, v_cache, (k_t, v_t), stats


def routed_mlp_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      carried_sq: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Stats]:
    """Decode-time FFN routing is the masked path with T = 1 (an MoE block
    dispatches the step's B rows)."""
    B = x.shape[0]
    routed = cfg.skip.enabled and cfg.skip.route_mlp
    logits, nstats = _router_and_stats(p, x, cfg, routed, carried_sq)
    gate, p_keep = _gate(logits[:, 0] if logits is not None else None, (B,),
                         routed, x.device)
    stats = _routed_stats(p_keep, gate, routed, cfg, x.device)
    x, res_sq, aux = _mlp_out(p, x, nstats, gate[:, None], routed, cfg)
    stats.update(aux)
    stats["res_sq"] = res_sq
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
