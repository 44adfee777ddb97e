"""Shared layers of the port: embedding, RMSNorm and LayerNorm with injected
statistics, RoPE, the linear projections (dense or int4-quantized) of the
fused pipeline and the composed (unfused) ones.

Counterpart of the JAX package's ``models/layers.py``.  Layers are plain
functions on tensors; parameters are nested dicts of tensors named after the
reference's pytree paths.  The port runs the reference's ``use_kernels=True,
fuse_linear=True`` structure, so ``fuse_norm_linear`` is true exactly where
the norm is RMS: a LayerNorm stack (stablelm-3b) takes the reference's
unfused path, the norm applied to x on its own (μ, σ²) pair, then
``linear_apply`` (``x @ w``, or the int4 matmul kernel for a quantized leaf)
and the composed ``mlp_apply``.
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
    return t.mul_(scale).to(dtype)


def linear_init(gen, in_dim: int, out_dim: int, cfg: ModelConfig, device,
                scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": trunc_normal(gen, (in_dim, out_dim), scale,
                              torch_dtype(cfg), device)}


def norm_init(dim: int, cfg: ModelConfig, device) -> Params:
    """gamma = ones and, for LayerNorm, beta = zeros, in the model's dtype."""
    p = {"gamma": torch.ones((dim,), dtype=torch_dtype(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["beta"] = torch.zeros((dim,), dtype=torch_dtype(cfg), device=device)
    return p


GLU_ACTS = ("swiglu", "geglu")


def fuse_norm_linear(cfg: ModelConfig) -> bool:
    """True where the fused norm-prologue pipeline runs: the norm is RMS
    (the carried reduction is a single Σx²; LayerNorm's (μ, σ²) pair stays
    on the unfused path), as the reference's ``fuse_norm_linear`` with
    ``use_kernels`` and ``fuse_linear`` on."""
    return cfg.norm_type == "rmsnorm"


def mlp_fusable(params: Params) -> bool:
    """Whether the fused pipeline runs this FFN (the reference's
    ``mlp_fusable``): a dense MLP, whose [gate|up] leaf the port always
    keeps merged (``gu``).  An MoE block (expert router ``gate``, 3-D
    expert leaves) keeps its scatter dispatch on the unfused branch."""
    return "gu" in params


def mlp_init(gen, cfg: ModelConfig, device) -> Params:
    if cfg.mlp_act not in GLU_ACTS:
        raise NotImplementedError(
            f"the port runs GLU MLPs only ({', '.join(GLU_ACTS)}); "
            f"{cfg.mlp_act!r} (the up/down layout) is not ported yet "
            "(ROADMAP queue 1 item 13.6)")
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


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The unfused GLU MLP on an already-normalised x: one product over the
    merged [gate | up] leaf, act(gate)·up in the model's dtype, the down
    product (the reference's ``mlp_apply`` on the ``gu`` layout)."""
    gu = linear_apply(params["gu"], x)
    F = gu.shape[-1] // 2
    g, up = gu[..., :F], gu[..., F:]
    if cfg.mlp_act == "swiglu":
        h = torch.nn.functional.silu(g)
    else:
        h = torch.nn.functional.gelu(g, approximate="tanh")
    return linear_apply(params["down"], h * up)


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


def mlp_act_name(cfg: ModelConfig) -> Optional[str]:
    """The epilogue activation of the MLP's GLU (the reference's
    ``mlp_act_name``): SwiGLU → silu, GeGLU (and ``gelu_mlp``) → gelu."""
    return {"swiglu": "silu", "geglu": "gelu", "gelu_mlp": "gelu"}.get(
        cfg.mlp_act, "gelu")


def mlp_apply_fused(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    norm: Params, stats: torch.Tensor,
                    residual: Optional[torch.Tensor] = None,
                    gate_mul: Optional[torch.Tensor] = None,
                    emit_sq: bool = False):
    """Norm-prologue × widened [gate|up] × GLU (SwiGLU or GeGLU), then the
    down projection with the gate/residual/Σy² epilogue.  Returns (out,
    Σy² or None)."""
    h, _ = linear_fused(params["gu"], x, cfg, norm=norm, stats=stats,
                        glu=True, act=mlp_act_name(cfg))
    return linear_fused(params["down"], h, cfg, residual=residual,
                        gate_mul=gate_mul, emit_sq=emit_sq)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
               stats=None) -> torch.Tensor:
    """RMSNorm or LayerNorm with fp32 statistics; ``stats`` injects
    precomputed ones (the decoupled-reduction path of Alg. 1): mean(x²)
    for RMSNorm, the pair (μ, σ²) for LayerNorm."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        ms = (xf * xf).mean(dim=-1, keepdim=True) if stats is None \
            else stats[..., None]
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        return (y * params["gamma"].float()).to(x.dtype)
    if stats is None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
    else:
        mu, var = stats[0][..., None], stats[1][..., None]
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["gamma"].float() + params["beta"].float()
    return y.to(x.dtype)


def rms_head_norm_init(dim: int, cfg: ModelConfig, device) -> Params:
    """gamma = ones, in the model's dtype (qk-norm's per-head scale)."""
    return {"gamma": torch.ones((dim,), dtype=torch_dtype(cfg),
                                device=device)}


def rms_head_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS over the last axis with its own statistics: qk-norm over each
    head's dims, and the Mamba block's gated output norm."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * params["gamma"].float()).to(x.dtype)


def norm_stats(x: torch.Tensor, cfg: Optional[ModelConfig] = None):
    """The norm's reduction alone, in fp32: mean(x²) for RMSNorm (also
    where ``cfg`` is None), the pair (μ, σ²) for LayerNorm.  The variance
    is the two-pass mean((x − μ)²), as the reference takes it: the
    one-pass E[x²] − μ² cancels for large-offset rows."""
    xf = x.float()
    if cfg is None or cfg.norm_type == "rmsnorm":
        return (xf * xf).mean(dim=-1)
    mu = xf.mean(dim=-1)
    return mu, (xf - mu[..., None]).square().mean(dim=-1)


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
