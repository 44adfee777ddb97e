"""SkipGPT routing, inference branch (paper §2.1): a per-submodule linear
router ``r = W_θᵀ x ∈ ℝ²`` decides per token whether the submodule runs.

Counterpart of the JAX package's ``core/routing.py``; training-time Gumbel
gates and gather mode are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, trunc_normal


def router_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Bias [0, 1] warm-starts toward keeping (logit_keep − logit_skip = 1)."""
    return {"w": trunc_normal(gen, (cfg.d_model, 2), 0.02, torch.float32,
                              device),
            "b": torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)}


def router_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., D] -> logits [..., 2] in fp32."""
    return x.float() @ params["w"] + params["b"]


def gate_from_logits(logits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference gate: (gate 0/1 f32 [...], p_keep [...]).  The decision is
    a strict ``>``, as in the reference."""
    p_keep = torch.softmax(logits, dim=-1)[..., 1]
    gate = (logits[..., 1] > logits[..., 0]).float()
    return gate, p_keep


def neutral_router_bias(params):
    """Zero every router's warm-start bias so an untrained model really
    skips tokens; returns a new tree sharing every other leaf."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k == "router" and isinstance(v, dict):
                out[k] = dict(v, b=torch.zeros_like(v["b"]))
            else:
                out[k] = neutral_router_bias(v)
        return out
    if isinstance(params, list):
        return [neutral_router_bias(v) for v in params]
    return params


def router_stats(p_keep: torch.Tensor, gate: torch.Tensor,
                 cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Per-submodule keep fraction and the sparsity-control aux loss."""
    return {"keep_frac": gate.mean(),
            "router_loss": (p_keep.mean() - cfg.skip.keep_prob) ** 2}
