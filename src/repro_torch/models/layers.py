"""Shared layers of the port: embedding, RMSNorm with injected statistics,
RoPE, and the linear projections (dense or int4-quantized) of the fused
pipeline.

Counterpart of the JAX package's ``models/layers.py``.  Layers are plain
functions on tensors; parameters are nested dicts of tensors named after the
reference's pytree paths.  The port always runs the reference's
``use_kernels=True, fuse_linear=True`` structure, so only the fused
projections exist here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

Params = Dict[str, torch.Tensor]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


# ---------------------------------------------------------------------------
# Init helpers (same shapes and distributions as the reference; the numbers
# differ, since a torch.Generator is not JAX's threefry)
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """Truncated normal on ±2σ, times ``scale``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, cfg: ModelConfig, device,
                scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": trunc_normal(gen, (in_dim, out_dim), scale,
                              torch_dtype(cfg), device)}


def norm_init(dim: int, cfg: ModelConfig, device) -> Params:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError("the port runs RMSNorm stacks only")
    return {"gamma": torch.ones((dim,), dtype=torch_dtype(cfg),
                                device=device)}


def mlp_init(gen, cfg: ModelConfig, device) -> Params:
    if cfg.mlp_act != "swiglu":
        raise NotImplementedError("the port runs SwiGLU MLPs only")
    return {"gu": linear_init(gen, cfg.d_model, 2 * cfg.d_ff, cfg, device),
            "down": linear_init(gen, cfg.d_ff, cfg.d_model, cfg, device)}


def embedding_init(gen, cfg: ModelConfig, device) -> Params:
    return {"table": trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                  torch_dtype(cfg), device)}


# ---------------------------------------------------------------------------
# Linear projections
# ---------------------------------------------------------------------------

def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """A linear outside the fused pipeline (the lm head).  A quantized leaf
    ({"w_int", "scale"}: int4 codes, per-group scales) runs the int4 BFP
    kernel; a dense one stays a plain matmul, as the reference leaves it
    to XLA."""
    if "w_int" in params:
        return kops.int4_matmul(x, params["w_int"], params["scale"])
    return x @ params["w"]


def linear_fused(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 norm: Optional[Params] = None,
                 stats: Optional[torch.Tensor] = None,
                 glu: bool = False, act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None,
                 gate_mul: Optional[torch.Tensor] = None,
                 emit_sq: bool = False):
    """One fused-pipeline matmul: x is un-normalised and ``stats`` is the
    injected mean(x²); the norm's elementwise phase runs inside the kernel."""
    return kops.fused_linear(
        params, x,
        mean_sq=None if norm is None else stats,
        gamma=None if norm is None else norm["gamma"],
        eps=cfg.norm_eps, glu=glu, act=act, residual=residual,
        gate_mul=gate_mul, emit_sq=emit_sq)


def mlp_apply_fused(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    norm: Params, stats: torch.Tensor,
                    residual: Optional[torch.Tensor] = None,
                    gate_mul: Optional[torch.Tensor] = None,
                    emit_sq: bool = False):
    """Norm-prologue × widened [gate|up] × GLU, then the down projection with
    the gate/residual/Σy² epilogue.  Returns (out, Σy² or None)."""
    h, _ = linear_fused(params["gu"], x, cfg, norm=norm, stats=stats,
                        glu=True, act="silu")
    return linear_fused(params["down"], h, cfg, residual=residual,
                        gate_mul=gate_mul, emit_sq=emit_sq)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
               stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm with fp32 statistics; ``stats`` injects a precomputed
    mean(x²) (the decoupled-reduction path of Alg. 1)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True) if stats is None \
        else stats[..., None]
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    return (y * params["gamma"].float()).to(x.dtype)


def rms_head_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS over the last axis with its own statistics (the Mamba block's
    gated output norm)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * params["gamma"].float()).to(x.dtype)


def norm_stats(x: torch.Tensor) -> torch.Tensor:
    """The RMSNorm reduction alone: mean(x²) in fp32."""
    xf = x.float()
    return (xf * xf).mean(dim=-1)


# ---------------------------------------------------------------------------
# Rotary position embeddings (plain RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rotary_pct: float, theta: float,
               device=None) -> torch.Tensor:
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)                       # [rot_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T]."""
    if cfg.pos_embedding != "rope":
        raise NotImplementedError(f"{cfg.pos_embedding} positions are not "
                                  "ported yet")
    d = x.shape[-1]
    inv = rope_freqs(d, cfg.rotary_pct, cfg.rope_theta, x.device)
    half = inv.shape[0]
    freqs = positions.float()[..., None] * inv          # [B, T, R/2]
    cos = torch.cos(freqs)[..., None, :]
    sin = torch.sin(freqs)[..., None, :]
    rot = 2 * half
    xf1 = x[..., :half].float()
    xf2 = x[..., half:rot].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                    dim=-1).to(x.dtype)
    if rot < d:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, head_params: Optional[Params], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """The lm head: ``linear_apply`` (the int4 kernel for a quantized head,
    else a plain matmul), or the tied embedding's transpose."""
    if cfg.tie_embeddings:
        return x @ params["table"].T
    return linear_apply(head_params, x)
