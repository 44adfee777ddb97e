"""SkipGPT routing, inference branch (paper §2.1): a per-submodule linear
router ``r = W_θᵀ x ∈ ℝ²`` decides per token whether the submodule runs.

Counterpart of the JAX package's ``core/routing.py``, with its gather
realization (top-capacity compaction: each routed submodule of a prefill
runs on the C tokens of highest router score only); training-time Gumbel
gates are not ported.
"""
from __future__ import annotations

import math
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


def capacity(T: int, keep_prob: float, multiple: int = 8) -> int:
    """Static per-sequence execution capacity of gather mode: ⌈T·keep⌉
    rounded up to ``multiple``, at most T and at least min(T, multiple)."""
    c = int(math.ceil(T * keep_prob))
    c = min(T, -(-c // multiple) * multiple)
    return max(c, min(T, multiple))


def select_topc(score: torch.Tensor, cap: int) -> torch.Tensor:
    """score: [B, T] -> idx [B, C] int64 of the top-C tokens, sorted
    ascending so the gathered rows keep temporal order.  Among equal
    scores the lower index wins, as ``jax.lax.top_k`` breaks ties (a
    stable descending sort; ``torch.topk`` promises no order for ties)."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[:, :cap], dim=-1).values


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, T, ...], idx: [B, C] -> [B, C, ...]."""
    return torch.gather(x, 1, _expand_idx(idx, x))


def scatter_tokens(y: torch.Tensor, idx: torch.Tensor, T: int
                   ) -> torch.Tensor:
    """y: [B, C, ...] -> [B, T, ...] with zeros at unselected positions."""
    out = y.new_zeros((y.shape[0], T) + tuple(y.shape[2:]))
    return out.scatter(1, _expand_idx(idx, y), y)


def scatter_set_tokens(x: torch.Tensor, idx: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """A copy of x [B, T, ...] with rows ``idx`` [B, C] replaced by u [B, C,
    ...]; x itself is left untouched (the reference's ``.at[].set``)."""
    return x.scatter(1, _expand_idx(idx, u), u.to(x.dtype))


def _expand_idx(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """idx [B, C] broadcast over ``like``'s trailing dims."""
    idx = idx.reshape(idx.shape + (1,) * (like.dim() - 2))
    return idx.expand(idx.shape[:2] + tuple(like.shape[2:]))


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


# Logit units of skip bias per unit of keep dropped by the draft lever
# below: the decision is ``logits[1] > logits[0]``, so raising the skip
# bias by a few logits flips most marginal keep decisions; 4.0 saturates
# well past trained decision margins.
DRAFT_BIAS_SCALE = 4.0


def draft_router_bias(params, draft_keep: float):
    """The self-speculative draft model: a view of ``params`` whose router
    skip biases are raised by ``DRAFT_BIAS_SCALE * (1 - draft_keep)``, so
    the routed forward skips more.  Every other leaf is the same tensor
    (no copy); ``draft_keep = 1.0`` returns ``params`` itself, so the draft
    forward is the verifier's."""
    shift = DRAFT_BIAS_SCALE * (1.0 - float(draft_keep))
    if shift == 0.0:
        return params

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == "router" and isinstance(v, dict):
                    b = v["b"]
                    out[k] = dict(v, b=b + torch.tensor(
                        [shift, 0.0], dtype=b.dtype, device=b.device))
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def router_stats(p_keep: torch.Tensor, gate: torch.Tensor,
                 cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Per-submodule keep fraction and the sparsity-control aux loss."""
    return {"keep_frac": gate.mean(),
            "router_loss": (p_keep.mean() - cfg.skip.keep_prob) ** 2}
