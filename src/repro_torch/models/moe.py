"""Top-k MoE with static-capacity scatter dispatch (GShard/Mixtral-style),
plus Arctic's dense-residual composition.

Counterpart of the JAX package's ``models/moe.py``.  Every expert runs
over its whole capacity buffer [C, D], as the reference's batched einsums
do: the products are ``torch.bmm`` over [E, C, D] × [E, D, F], and the
expert choice, positions, dispatch and combine are plain torch on every
device.  Nothing here reads a tensor's value on the host (no ``.item()``,
no ``nonzero``, no boolean-mask indexing): capacity is a function of the
static row count, so a decode iteration with MoE is captured in a CUDA
graph like any other.

Expert choice: the fp32 router product and softmax, the top K by a stable
descending sort (the lower expert wins a tie, as with ``lax.top_k``;
``torch.topk`` promises no order among ties), renormalised with a 1e-9
clamp.  Positions: a token-major cumsum over the one-hot of the N·K
choices; a (token, slot) pair at or past C is dropped.  Dispatch: an
``index_copy_`` into an [E·C + 1, D] buffer whose last row takes the drops;
every kept destination is unique, so the copy equals the reference's add
into zeros and needs no atomic add.  Combine: y + out[dest_j]·p_j for j =
0…K−1 in x's dtype, a dropped pair reading 0.  Arctic adds its dense MLP
(``layers.mlp_apply``: the int4 matmul for an int4 leaf) on the same x.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params


def _expert_leaf(gen, shape, scale: float, cfg: ModelConfig, device
                 ) -> torch.Tensor:
    """A 3-D [E, ·, ·] leaf drawn one expert at a time, so the fp32 draw
    never holds more than one expert's slice."""
    out = torch.empty(shape, dtype=layers.torch_dtype(cfg), device=device)
    for e in range(shape[0]):
        out[e] = layers.trunc_normal(gen, shape[1:], scale, out.dtype, device)
    return out


def moe_init(gen, cfg: ModelConfig, device) -> Params:
    """The reference's leaves and shapes: ``gate`` [D, E] (the expert
    router), ``w_up`` / ``w_gate`` (GLU only) [E, D, F], ``w_down`` [E, F,
    D], and Arctic's ``dense`` residual MLP (``layers.mlp_init``)."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p: Params = {
        "gate": layers.trunc_normal(gen, (d, E), s_in,
                                    layers.torch_dtype(cfg), device),
        "w_up": _expert_leaf(gen, (E, d, f), s_in, cfg, device),
        "w_down": _expert_leaf(gen, (E, f, d), s_out, cfg, device)}
    if cfg.mlp_act in layers.GLU_ACTS:
        p["w_gate"] = _expert_leaf(gen, (E, d, f), s_in, cfg, device)
    if cfg.dense_residual:
        p["dense"] = layers.mlp_init(gen, cfg, device)
    return p


def capacity(n_rows: int, cfg: ModelConfig) -> int:
    """Static per-expert capacity of N rows: ⌈factor·N·K/E⌉ rounded up to
    8, at least 8 (the reference's arithmetic)."""
    c = int(math.ceil(cfg.moe_capacity_factor * n_rows * cfg.top_k
                      / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def top_k_experts(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs [N, E] -> (top_p [N, K], top_e [N, K] int64), in descending
    order of probability, the lower expert first among equal ones."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.values[:, :k], order.indices[:, :k]


def _act(g: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU's silu, else the tanh GELU (``jax.nn.gelu``'s default)."""
    if cfg.mlp_act == "swiglu":
        return torch.nn.functional.silu(g)
    return torch.nn.functional.gelu(g, approximate="tanh")


def _expert_ffn(params: Params, h: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """h [E, C, D] -> [E, C, D]: each expert's GLU over its buffer."""
    up = torch.bmm(h, params["w_up"])
    if "w_gate" in params:
        mid = _act(torch.bmm(h, params["w_gate"]), cfg) * up
    else:
        mid = torch.nn.functional.gelu(up, approximate="tanh")
    return torch.bmm(mid, params["w_down"])


def _route(params: Params, xf: torch.Tensor, cfg: ModelConfig):
    """xf [N, D] -> (probs [N, E] fp32, top_p [N, K] renormalised, top_e
    [N, K]): the fp32 router product, its softmax and the top K."""
    probs = torch.softmax(xf.float() @ params["gate"].float(), dim=-1)
    top_p, top_e = top_k_experts(probs, cfg.top_k)
    return probs, top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                      min=1e-9), top_e


def positions(top_e: torch.Tensor, n_experts: int, cap: int):
    """top_e [N, K] -> (dest [N, K] rows of the [E·C + 1, D] buffer, E·C
    for a dropped pair; keep [N·K]; the one-hot [N·K, E]).  A pair's place
    in its expert is the cumsum of the choices in token-major order."""
    N, K = top_e.shape
    flat_e = top_e.reshape(-1)                 # token-major: token i's slots
    onehot = (flat_e[:, None] == torch.arange(
        n_experts, device=flat_e.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < cap
    dest = torch.where(keep, flat_e * cap + pos_in_e,
                       torch.full_like(flat_e, n_experts * cap))
    return dest.reshape(N, K), keep, onehot


def _dispatch(xf: torch.Tensor, dest: torch.Tensor, n_experts: int,
              cap: int) -> torch.Tensor:
    """xf [N, D] -> the experts' buffers [E, C, D]: each kept pair's row
    copied to its destination (unique), the drops to a spare last row."""
    buf = xf.new_zeros((n_experts * cap + 1, xf.shape[1]))
    for j in range(dest.shape[1]):
        buf.index_copy_(0, dest[:, j], xf)
    return buf[:n_experts * cap].view(n_experts, cap, xf.shape[1])


def _combine(out: torch.Tensor, dest: torch.Tensor, top_p: torch.Tensor
            ) -> torch.Tensor:
    """out [E, C, D] -> y [N, D] = Σ_j out[dest_j]·p_j in out's dtype, j
    in order, a dropped pair reading 0."""
    D = out.shape[-1]
    out = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])
    y = out.new_zeros((dest.shape[0], D))
    for j in range(dest.shape[1]):
        y = y + out.index_select(0, dest[:, j]) * top_p[:, j].to(
            out.dtype)[:, None]
    return y


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, T, D] (already normalised) -> (y [B, T, D], aux with the
    Switch load-balance loss ``moe_lb_loss`` and ``moe_drop_frac``)."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, D)
    probs, top_p, top_e = _route(params, xf, cfg)
    C = capacity(N, cfg)
    dest, keep, onehot = positions(top_e, E, C)
    out = _expert_ffn(params, _dispatch(xf, dest, E, C), cfg)
    y = _combine(out, dest, top_p)
    if "dense" in params:                                    # Arctic residual
        y = y + layers.mlp_apply(params["dense"], x, cfg).reshape(N, D)
    me = probs.mean(dim=0)                                   # mean gate prob
    ce = onehot.sum(dim=0).float() / (N * K)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y.reshape(B, T, D), aux
