"""Layer stack: a Python loop over per-layer blocks (the reference's
``lax.scan`` over ``stack.stages``): all-global-attention stacks, or
attention-free Mamba-2 stacks.

Counterpart of ``stage_forward`` / ``stage_decode`` /
``stage_prefill_chunk`` in the JAX package's ``models/transformer.py``.  An attention block is {"mixer": routed
attention, "ffn": routed GLU MLP}; the KV view and the Σy²/D carry thread
from block to block exactly as they thread through the reference's stages.
A Mamba block is {"mixer": routed SSM}; it consumes the Σy²/D carry but
emits none, and its cache entry is {"conv_x", "conv_bc", "ssm"}.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, MAMBA, ModelConfig
from repro_torch.core import routing, skip_block
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm as ssm_mod
from repro_torch.models.layers import Params


def is_ssm_stack(cfg: ModelConfig) -> bool:
    """True for an attention-free Mamba stack."""
    return all(k == MAMBA for k in cfg.layer_pattern)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs dense RMSNorm stacks that are either all global
    attention with GLU MLPs, or all Mamba-2 with no MLP."""
    if is_ssm_stack(cfg):
        if cfg.d_ff:
            raise NotImplementedError("Mamba blocks with an MLP are not "
                                      "ported yet")
    elif any(cfg.block_kind(i) != ATTN for i in range(cfg.num_layers)):
        raise NotImplementedError("only all-global-attention or all-Mamba "
                                  "stacks are ported")
    elif not cfg.d_ff:
        raise NotImplementedError("blocks without an MLP are not ported")
    if cfg.num_experts or cfg.moe_every:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.frontend != "token":
        raise NotImplementedError("only token frontends are ported")
    if cfg.skip.mode != "masked":
        raise NotImplementedError("gather-mode routing is not ported yet")
    if cfg.kv_cache_layout != "bthd":
        raise NotImplementedError("the port's decode cache is bthd only")


def block_init(gen, cfg: ModelConfig, device) -> Params:
    """One layer's parameters, keyed as the reference's ``pos{k}`` leaves."""
    def routed(inner):
        return {"router": routing.router_init(gen, cfg, device),
                "norm": layers.norm_init(cfg.d_model, cfg, device),
                "inner": inner}
    if is_ssm_stack(cfg):
        return {"mixer": routed(ssm_mod.ssm_init(gen, cfg, device))}
    return {"mixer": routed(attn_mod.attention_init(gen, cfg, device)),
            "ffn": routed(layers.mlp_init(gen, cfg, device))}


def _zero_stats(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"router_loss": z, "keep_frac_sum": z, "n_routed": z}


def _acc_stats(acc: Dict, s: Dict, routed_kind: bool) -> Dict:
    acc = dict(acc)
    acc["router_loss"] = acc["router_loss"] + s["router_loss"]
    if routed_kind:
        acc["keep_frac_sum"] = acc["keep_frac_sum"] + s["keep_frac"]
        acc["n_routed"] = acc["n_routed"] + 1.0
    return acc


def stack_forward(blocks: List[Params], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict, List[Dict],
                             Optional[torch.Tensor]]:
    """Prefill over every block.  Returns (x, stats with ``attn_gate``
    [L, B, T] (``ssm_gate`` for a Mamba stack), per-layer cache [{"k",
    "v"}] (or [{"conv_x", "conv_bc", "ssm"}]), the final Σy²/D carry, None
    after a Mamba block)."""
    if is_ssm_stack(cfg):
        return _ssm_forward(blocks, x, cfg)
    stats = _zero_stats(x.device)
    cache: List[Dict] = []
    gates: List[torch.Tensor] = []
    view, sq = None, None
    for bp in blocks:
        x, view, s = skip_block.routed_attention(
            bp["mixer"], x, view, positions, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
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
    for bp, ce in zip(blocks, cache):
        x, ce["k"], ce["v"], kv_prev, s = skip_block.routed_attention_decode(
            bp["mixer"], x, ce["k"], ce["v"], t, kv_prev, positions, cfg,
            carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        x, s = skip_block.routed_mlp_decode(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, cache, stats, sq


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
    stats = _zero_stats(x.device)
    gates: List[torch.Tensor] = []
    kv_prev, sq = None, None
    for i, (bp, ce) in enumerate(zip(blocks, cache)):
        if cfg.block_kind(i) != ATTN:
            raise ValueError("chunked prefill requires an all-global-attn "
                             f"stack; layer {i} is {cfg.block_kind(i)!r}")
        x, ce["k"], ce["v"], kv_prev, s = skip_block.routed_attention_chunk(
            bp["mixer"], x, ce["k"], ce["v"], t0, kv_prev, positions, cfg,
            carried_sq=sq)
        sq = s.pop("res_sq")
        gates.append(s["attn_gate"])
        stats = _acc_stats(stats, s, cfg.skip.route_attention)
        x, s = skip_block.routed_mlp(bp["ffn"], x, cfg, carried_sq=sq)
        sq = s.pop("res_sq")
        stats = _acc_stats(stats, s, cfg.skip.route_mlp)
    stats["attn_gate"] = torch.stack(gates)
    return x, cache, stats, sq


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
