"""Attention: the widened qkv projection (with the fused norm prologue, or
composed after the norm), RoPE, the o-projection (fused with its
gate/residual epilogue, or composed), and the dispatch to the attention
kernel.

Counterpart of the JAX package's ``models/attention.py`` (the chunked jnp
attention is not ported: the port always runs the kernel).  With
``cfg.qk_norm`` (qwen3) q and k are RMS-normalised per head before RoPE,
in plain PyTorch as the reference does it in jnp outside any kernel;
every prefill, decode, chunk, verify and paged path projects through
``project_qkv``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.layers import Params


def attention_init(gen, cfg: ModelConfig, device) -> Params:
    d, ai, ki = cfg.d_model, cfg.attn_inner_dim, cfg.kv_inner_dim
    p = {"wqkv": layers.linear_init(gen, d, ai + 2 * ki, cfg, device),
         "wo": layers.linear_init(gen, ai, d, cfg, device)}
    if cfg.qk_norm:
        dh = cfg.resolved_head_dim
        p["qnorm"] = layers.rms_head_norm_init(dh, cfg, device)
        p["knorm"] = layers.rms_head_norm_init(dh, cfg, device)
    return p


def _finish_q(params: Params, q: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    B, T = q.shape[:2]
    q = q.reshape(B, T, cfg.num_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = layers.rms_head_norm(params["qnorm"], q, cfg.norm_eps)
    return layers.apply_rope(q, positions, cfg)


def _finish_kv(params: Params, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig):
    B, T = k.shape[:2]
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        k = layers.rms_head_norm(params["knorm"], k, cfg.norm_eps)
    return layers.apply_rope(k, positions, cfg), v


def project_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, norm: Optional[Params] = None,
                stats=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> q [B, T, Hq, dh], k/v [B, T, Hkv, dh]; K is stored
    post-RoPE (and post qk-norm).

    Fused (``layers.fuse_norm_linear``): x is un-normalised, ``stats`` =
    mean(x²), and one fused kernel computes q | k | v.  Unfused (a
    LayerNorm stack): x is normalised first on ``stats`` = (μ, σ²) (or is
    already normalised where ``norm`` is None), then one ``linear_apply``
    over the whole widened ``wqkv`` computes q | k | v, split afterwards.
    The reference's unfused path takes three products over column slices
    of ``wqkv`` (``project_q``, ``project_kv``); every output column is
    the same dot product either way, and one product over the whole leaf
    needs no strided view of int4 codes (which the int4 kernel does not
    take) and no copy of a slice per call."""
    ai, ki = cfg.attn_inner_dim, cfg.kv_inner_dim
    if layers.fuse_norm_linear(cfg):
        qkv, _ = layers.linear_fused(params["wqkv"], x, cfg, norm=norm,
                                     stats=stats)
    else:
        if norm is not None:
            x = layers.norm_apply(norm, x, cfg, stats=stats)
        qkv = layers.linear_apply(params["wqkv"], x)
    q = _finish_q(params, qkv[..., :ai], positions, cfg)
    k, v = _finish_kv(params, qkv[..., ai:ai + ki], qkv[..., ai + ki:],
                      positions, cfg)
    return q, k, v


def output_proj(params: Params, o: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The composed o-projection of the unfused path: o·Wo, no epilogue."""
    B, T = o.shape[:2]
    return layers.linear_apply(params["wo"],
                               o.reshape(B, T, cfg.attn_inner_dim))


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
