"""Layer stack: a Python loop over per-layer blocks (the reference's
``lax.scan`` over ``stack.stages``): attention stacks of global (ATTN) and
sliding-window (LOCAL) layers, or attention-free Mamba-2 stacks.

Counterpart of ``stage_forward`` / ``stage_decode`` /
``stage_prefill_chunk`` / ``stage_decode_paged`` / ``stage_verify_paged``
in the JAX package's ``models/transformer.py``.  An attention block is
{"mixer": routed attention, "ffn": routed GLU MLP}; the KV view and the
Σy²/D carry thread from block to block exactly as they thread through the
reference's stages.
An MoE FFN (``cfg.is_moe_layer``) takes the unfused branch and emits no
Σy²/D carry, so the next attention block launches the router-stats kernel
itself; its ``moe_lb_loss`` is summed into the stats with ``n_moe``, as
the reference's stage stats do.
A LayerNorm stack's blocks run the unfused path and carry no Σy²/D (None
from block to block, and as the stack's final carry).
A Mamba block is {"mixer": routed SSM}; it consumes the Σy²/D carry but
emits none, and its cache entry is {"conv_x", "conv_bc", "ssm"}.

Caches, as the reference keeps them: a global layer's dense view [B, Tmax,
Hkv, dh]; a LOCAL layer's ring [B, W, Hkv, dh] (W = ``cfg.window_size``),
position p at slot p mod W, once the prompt is longer than W
(``_ring_from_linear``), else its linear view grown like a global layer's.
Decode writes a ring where the cache is exactly W long (the ``ring``
of ``skip_block.routed_attention_decode``, the reference's
``_ring_attention_decode``) and otherwise attends the linear view under
the window.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL, MAMBA, ModelConfig
from repro_torch.core import routing, skip_block
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.layers import Params


def is_ssm_stack(cfg: ModelConfig) -> bool:
    """True for an attention-free Mamba stack."""
    return all(k == MAMBA for k in cfg.layer_pattern)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs stacks that are either attention (global and
    sliding-window LOCAL layers) with GLU MLPs or top-k MoE FFNs (qk-norm
    optional; RMSNorm on the fused pipeline, LayerNorm on the unfused one;
    an MoE FFN on the unfused branch), or all Mamba-2 with no MLP, in
    masked or gather routing.  Each refusal names the
    ROADMAP queue 1 item that will port it."""
    if is_ssm_stack(cfg):
        if cfg.d_ff:
            raise NotImplementedError("Mamba blocks with an MLP are not "
                                      "ported yet (ROADMAP queue 1 item "
                                      "13.5)")
    elif any(cfg.block_kind(i) not in (ATTN, LOCAL)
             for i in range(cfg.num_layers)):
        raise NotImplementedError("hybrid attention / Mamba stacks are not "
                                  "ported yet (ROADMAP queue 1 item 13.5)")
    elif not cfg.d_ff:
        raise NotImplementedError("blocks without an MLP are not ported "
                                  "(ROADMAP queue 1 item 13)")
    if cfg.frontend != "token":
        raise NotImplementedError("only token frontends are ported (ROADMAP "
                                  "queue 1 item 13.6)")
    if cfg.kv_cache_layout != "bthd":
        raise NotImplementedError("the port's decode cache is bthd only "
                                  "(bhtd: ROADMAP queue 1 item 13.7)")


def is_gather(cfg: ModelConfig) -> bool:
    """Gather-mode routing: prefill runs each routed submodule on the
    top-capacity tokens only (decode steps are masked in either mode)."""
    return cfg.skip.enabled and cfg.skip.mode == "gather"


def block_init(gen, cfg: ModelConfig, device, layer: int) -> Params:
    """Layer ``layer``'s parameters, keyed as the reference's ``pos{k}``
    leaves: an MoE FFN (``moe.moe_init``) where ``cfg.is_moe_layer``."""
    def routed(inner):
        return {"router": routing.router_init(gen, cfg, device),
                "norm": layers.norm_init(cfg.d_model, cfg, device),
                "inner": inner}
    if is_ssm_stack(cfg):
        return {"mixer": routed(ssm_mod.ssm_init(gen, cfg, device))}
    mixer = routed(attn_mod.attention_init(gen, cfg, device))
    ffn = (moe_mod.moe_init(gen, cfg, device) if cfg.is_moe_layer(layer)
           else layers.mlp_init(gen, cfg, device))
    return {"mixer": mixer, "ffn": routed(ffn)}


def _zero_stats(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"router_loss": z, "keep_frac_sum": z, "n_routed": z,
            "moe_lb_loss": z, "n_moe": z}


def _acc_stats(acc: Dict, s: Dict, routed_kind: bool) -> Dict:
    acc = dict(acc)
    acc["router_loss"] = acc["router_loss"] + s["router_loss"]
    if routed_kind:
        acc["keep_frac_sum"] = acc["keep_frac_sum"] + s["keep_frac"]
        acc["n_routed"] = acc["n_routed"] + 1.0
    if "moe_lb_loss" in s:
        acc["moe_lb_loss"] = acc["moe_lb_loss"] + s["moe_lb_loss"]
        acc["n_moe"] = acc["n_moe"] + 1.0
    return acc


def stack_forward(blocks: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict, List[Dict],
                             Optional[torch.Tensor]]:
    """Prefill over every block, in masked or gather mode (a Mamba stack
    runs masked in either, as the reference's ``routed_ssm`` does).
    Returns (x, stats with ``attn_gate`` [L, B, T] (``ssm_gate`` for a
    Mamba stack), per-layer cache [{"k", "v"}] (or [{"conv_x", "conv_bc",
    "ssm"}]), the final Σy²/D carry, None after a Mamba block)."""
    if is_ssm_stack(cfg):
        return _ssm_forward(blocks, x, cfg)
    stats = _zero_stats(x.device)
    cache: List[Dict] = []
    gates: List[torch.Tensor] = []
    view, sq = None, None
    T, W = x.shape[1], cfg.window_size
    for i, bp in enumerate(blocks):
        local = cfg.block_kind(i) == LOCAL
        # the KV view threads through LOCAL and global layers alike, as in
        # the reference; a LOCAL layer attends under its window
        x, view, s = skip_block.routed_attention(
            bp["mixer"], x, view, positions, cfg,
            window=W if local else 0, carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        if local and W and T > W:
            cache.append({"k": _ring_from_linear(view[0], W),
                          "v": _ring_from_linear(view[1], W)})
        else:
            cache.append({"k": view[0], "v": view[1]})
        x, s = skip_block.routed_mlp(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, stats, cache, sq


def stack_decode(blocks: List[Params], cache: List[Dict], x: torch.Tensor,
                 t: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, List[Dict], Dict,
                            Optional[torch.Tensor]]:
    """One token per sequence over every block; the caches are updated in
    place.  Returns (x, cache, stats with ``attn_gate`` [L, B] (``ssm_gate``
    for a Mamba stack), the final Σy²/D carry)."""
    if is_ssm_stack(cfg):
        return _ssm_decode(blocks, cache, x, cfg)
    stats = _zero_stats(x.device)
    gates: List[torch.Tensor] = []
    kv_prev, sq = None, None
    W = cfg.window_size
    for i, (bp, ce) in enumerate(zip(blocks, cache)):
        local = cfg.block_kind(i) == LOCAL
        # a LOCAL layer whose cache is exactly W long is a ring; any other
        # (max_len < W, or a prompt ≤ W grown past W) attends its linear
        # view under the window, as a global layer attends with none
        ring = W if local and ce["k"].shape[1] == W else 0
        x, ce["k"], ce["v"], kv_prev, s = skip_block.routed_attention_decode(
            bp["mixer"], x, ce["k"], ce["v"], t, kv_prev, positions, cfg,
            window=W if local and not ring else 0, ring=ring, carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        x, s = skip_block.routed_mlp_decode(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, cache, stats, sq


def _ring_from_linear(kv: torch.Tensor, W: int) -> torch.Tensor:
    """[B, T, H, d] -> ring buffer [B, W, H, d]: slot s holds the latest
    position ≡ s (mod W) (the reference's ``_ring_from_linear``)."""
    T = kv.shape[1]
    if T <= W:
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, W - T))
    tail = kv[:, T - W:]                                # positions T-W..T-1
    return torch.roll(tail, (T - W) % W, dims=1)


def ring_positions(t: torch.Tensor, W: int) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing position
    t: slot s holds p = t - ((t - s) mod W); p < 0 is an empty slot (the
    reference's ``ring_positions``).  t: scalar or [...] -> [..., W]."""
    t = torch.as_tensor(t)
    s = torch.arange(W, device=t.device)
    return t[..., None] - torch.remainder(t[..., None] - s, W)


def stack_prefill_chunk(blocks: List[Params], cache: List[Dict],
                        x: torch.Tensor, t0: torch.Tensor,
                        positions: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, List[Dict], Dict,
                                   torch.Tensor]:
    """One prefill chunk of C tokens over every block (counterpart of
    ``stage_prefill_chunk`` over all stages).  ``cache`` holds each
    layer's time-major {"k", "v"} view of the prefix [0, t0); the chunk's
    merged views are written at [t0, t0 + C) in place.  The KV view and
    the Σy²/D carry thread from block to block over the chunk's tokens
    only.  Returns (x, cache, stats with ``attn_gate`` [L, B, C], the
    final Σy²/D carry)."""
    x, stats, sq, _ = _chunk_layers(blocks, cache, x, t0, positions, cfg)
    return x, cache, stats, sq


def stack_verify_paged(blocks: List[Params], stage: List[Dict],
                       x: torch.Tensor, t0: torch.Tensor,
                       positions: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor],
                                  Dict, torch.Tensor]:
    """A speculative verify window of C tokens over every block against
    the paged store (counterpart of ``stage_verify_paged`` over all
    stages), read-only: ``stage`` is the staging cache that
    ``kvcache.paged.views_from_pages_batch`` restored from the committed
    entry prefix (per layer {"k", "v"} [B, cap, Hkv, dh], positions [0,
    t0) per slot), and the window runs through the chunk path over it,
    its rows written at [t0, t0 + C) of the staging cache, never the
    store.  Returns (x, each layer's window views (k, v) [L, B, C, Hkv,
    dh] for ``model.commit_verified``, stats with ``attn_gate`` [L, B,
    C], the final Σy²/D carry)."""
    x, stats, sq, views = _chunk_layers(blocks, stage, x, t0, positions,
                                        cfg, collect=True)
    k_win = torch.stack([k for k, _ in views])
    v_win = torch.stack([v for _, v in views])
    return x, (k_win, v_win), stats, sq


def _chunk_layers(blocks: List[Params], cache: List[Dict], x: torch.Tensor,
                  t0: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, collect: bool = False):
    """The chunk pass shared by chunked prefill and the verify window:
    (x, stats, Σy²/D carry, and with ``collect`` each layer's merged
    window view (k, v) [B, C, Hkv, dh], else None)."""
    if is_gather(cfg):
        raise ValueError(f"{cfg.name}: gather-mode capacity depends on the "
                         "prefill extent, so a chunk or verify window "
                         "cannot resume it — chunked prefill and "
                         "speculative verify need masked-mode routing")
    stats = _zero_stats(x.device)
    gates: List[torch.Tensor] = []
    views: Optional[List] = [] if collect else None
    kv_prev, sq = None, None
    for i, (bp, ce) in enumerate(zip(blocks, cache)):
        if cfg.block_kind(i) != ATTN:
            raise ValueError("chunked prefill requires an all-global-attn "
                             f"stack; layer {i} is {cfg.block_kind(i)!r}")
        x, ce["k"], ce["v"], kv_prev, s = skip_block.routed_attention_chunk(
            bp["mixer"], x, ce["k"], ce["v"], t0, kv_prev, positions, cfg,
            carried_sq=sq)
        if collect:
            views.append(kv_prev)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        x, s = skip_block.routed_mlp(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, stats, sq, views


def _ssm_forward(blocks: List[Params], x: torch.Tensor, cfg: ModelConfig):
    """Prefill of a Mamba stack (the reference's MAMBA branch of
    ``stage_forward``): no block emits the Σy² carry, so each router pass
    also takes the norm's reduction.  The per-layer gates go to
    ``stats['ssm_gate']`` [L, B, T] (the reference logs none)."""
    stats = _zero_stats(x.device)
    cache: List[Dict] = []
    gates: List[torch.Tensor] = []
    for bp in blocks:
        x, ((cx, cbc), st), s = skip_block.routed_ssm(bp["mixer"], x, cfg)
        gates.append(s.pop("ssm_gate"))
        stats = _acc_stats(stats, s, cfg.skip.route_ssm)
        cache.append({"conv_x": cx, "conv_bc": cbc, "ssm": st})
    stats["ssm_gate"] = torch.stack(gates)
    return x, stats, cache, None


def _ssm_decode(blocks: List[Params], cache: List[Dict], x: torch.Tensor,
                cfg: ModelConfig):
    """One token per sequence through a Mamba stack; each layer's entry of
    ``cache`` is replaced by its new conv histories and state."""
    stats = _zero_stats(x.device)
    gates: List[torch.Tensor] = []
    for bp, ce in zip(blocks, cache):
        x, ((cx, cbc), st), s = skip_block.routed_ssm_decode(
            bp["mixer"], x, cfg, conv_state=(ce["conv_x"], ce["conv_bc"]),
            ssm_state=ce["ssm"])
        gates.append(s.pop("ssm_gate"))
        stats = _acc_stats(stats, s, cfg.skip.route_ssm)
        ce["conv_x"], ce["conv_bc"], ce["ssm"] = cx, cbc, st
    stats["ssm_gate"] = torch.stack(gates)
    return x, cache, stats, None


def stack_decode_paged(blocks: List[Params], x: torch.Tensor,
                       positions: torch.Tensor, cfg: ModelConfig,
                       paged: Dict
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor],
                                  Dict, Optional[torch.Tensor]]:
    """One token per sequence over every block against the paged KV store
    (counterpart of ``stage_decode_paged`` over all stages).  Reads resolve
    through the shared entry stream in ``paged``; writes are collected into
    per-layer token views the caller commits once per step.  Returns (x,
    the commit buffers (k, v) [L, B, Hkv, dh], stats with ``attn_gate``
    [L, B], the final Σy²/D carry)."""
    stats = _zero_stats(x.device)
    gates: List[torch.Tensor] = []
    k_toks: List[torch.Tensor] = []
    v_toks: List[torch.Tensor] = []
    kv_prev, sq = None, None
    for layer, bp in enumerate(blocks):
        x, kv_prev, s = skip_block.routed_attention_decode_paged(
            bp["mixer"], x, kv_prev, positions, cfg,
            paged=paged, layer=layer, carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s.pop("attn_gate"))
        k_toks.append(kv_prev[0][:, 0])
        v_toks.append(kv_prev[1][:, 0])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        x, s = skip_block.routed_mlp_decode(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, (torch.stack(k_toks), torch.stack(v_toks)), stats, sq
