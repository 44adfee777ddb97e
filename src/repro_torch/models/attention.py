"""Attention: the widened qkv projection with the fused norm prologue, RoPE,
the fused o-projection epilogue, and the dispatch to the attention kernel.

Counterpart of the JAX package's ``models/attention.py`` (qk-norm and the
chunked jnp attention are not ported: the port always runs the kernel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.layers import Params


def attention_init(gen, cfg: ModelConfig, device) -> Params:
    if cfg.qk_norm:
        raise NotImplementedError("qk-norm is not ported yet")
    d, ai, ki = cfg.d_model, cfg.attn_inner_dim, cfg.kv_inner_dim
    return {"wqkv": layers.linear_init(gen, d, ai + 2 * ki, cfg, device),
            "wo": layers.linear_init(gen, ai, d, cfg, device)}


def _finish_q(q: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    B, T = q.shape[:2]
    q = q.reshape(B, T, cfg.num_heads, cfg.resolved_head_dim)
    return layers.apply_rope(q, positions, cfg)


def _finish_kv(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig):
    B, T = k.shape[:2]
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    return layers.apply_rope(k, positions, cfg), v


def project_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, norm: Params, stats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] un-normalised; ``stats`` = mean(x²).  One fused kernel
    computes q | k | v; K is stored post-RoPE."""
    ai, ki = cfg.attn_inner_dim, cfg.kv_inner_dim
    qkv, _ = layers.linear_fused(params["wqkv"], x, cfg, norm=norm,
                                 stats=stats)
    q = _finish_q(qkv[..., :ai], positions, cfg)
    k, v = _finish_kv(qkv[..., ai:ai + ki], qkv[..., ai + ki:], positions, cfg)
    return q, k, v


def output_proj_fused(params: Params, o: torch.Tensor, cfg: ModelConfig, *,
                      residual: torch.Tensor,
                      gate_mul: Optional[torch.Tensor] = None,
                      emit_sq: bool = False):
    """y = (o·Wo)·gate + residual in one kernel, optionally emitting Σy² of
    the written residual stream.  Returns (residual stream, Σy² or None)."""
    B, T = o.shape[:2]
    return layers.linear_fused(
        params["wo"], o.reshape(B, T, cfg.attn_inner_dim), cfg,
        residual=residual, gate_mul=gate_mul, emit_sq=emit_sq)


def attention_core(q, k, v, *, q_positions, cfg: ModelConfig,
                   causal: bool = True, window: int = 0,
                   kv_valid_len=None) -> torch.Tensor:
    """q: [B, Tq, Hq, dh]; k/v: [B, Tk, Hkv, dh] -> [B, Tq, Hq, dh]."""
    if q.shape[1] == 1:
        return kops.decode_attention(q, k, v, q_positions=q_positions,
                                     window=window, kv_valid_len=kv_valid_len)
    return kops.flash_attention(q, k, v, q_positions=q_positions,
                                causal=causal, window=window,
                                kv_valid_len=kv_valid_len)
