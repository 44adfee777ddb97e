"""Mamba-2 / SSD (state-space duality) block: the full-sequence forward
(its chunk scan on the SSD kernel) and the single-token decode step.

Counterpart of the JAX package's ``models/ssm.py``.  Projections are kept
separate per component (z, x, B/C, dt), as in the reference.  SkipGPT
routing on SSM layers is masked-contribution: a skipped token's dt is
zeroed (no state update, no output) and its output is zeroed; it rides the
residual stream.  The port's prefill always starts from a zero state, so
``ssm_apply`` takes no initial state (the reference's chunked prefill,
which would, is not ported yet).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.layers import Params


def _dims(cfg: ModelConfig):
    return (cfg.d_inner_ssm, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads,
            cfg.ssm_headdim)


def conv_dim(cfg: ModelConfig) -> int:
    di, g, n, _, _ = _dims(cfg)
    return di + 2 * g * n


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The reference's shapes and distributions: ``A_log = log(linspace(1,
    16))``, ``dt_bias`` the inverse softplus of dt log-uniform in [1e-3,
    1e-1], ``D = 1`` (the numbers differ: a torch.Generator is not JAX's
    threefry)."""
    di, g, n, nh, _ = _dims(cfg)
    d, W = cfg.d_model, cfg.ssm_conv
    dt = layers.torch_dtype(cfg)
    u = torch.rand((nh,), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))        # inverse softplus
    return {
        "in_proj_z": layers.linear_init(gen, d, di, cfg, device),
        "in_proj_x": layers.linear_init(gen, d, di, cfg, device),
        "in_proj_bc": layers.linear_init(gen, d, 2 * g * n, cfg, device),
        "in_proj_dt": layers.linear_init(gen, d, nh, cfg, device),
        "conv_x_w": layers.trunc_normal(gen, (W, di), 1.0 / math.sqrt(W), dt,
                                        device),
        "conv_x_b": torch.zeros((di,), dtype=dt, device=device),
        "conv_bc_w": layers.trunc_normal(gen, (W, 2 * g * n),
                                         1.0 / math.sqrt(W), dt, device),
        "conv_bc_b": torch.zeros((2 * g * n,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "dt_bias": dt_bias.float(),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm": {"gamma": torch.ones((di,), dtype=dt, device=device)},
        "out_proj": layers.linear_init(gen, di, d, cfg, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d from a zero history.  x: [B, T, C]; w: [W, C]."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + T, :] * w[i] for i in range(W))
    return F.silu(out + b)


def _hist(raw: torch.Tensor, W: int) -> torch.Tensor:
    """The last W-1 pre-activation conv inputs (zero-padded on the left)."""
    if raw.shape[1] < W - 1:
        raw = F.pad(raw, (0, 0, W - 1 - raw.shape[1], 0))
    return raw[:, raw.shape[1] - (W - 1):, :]


def _split_bc(bc: torch.Tensor, cfg: ModelConfig):
    """[..., 2GN] -> (B, C) [..., G, N] per group."""
    _, g, n, _, _ = _dims(cfg)
    Bc, Cc = bc.split(g * n, dim=-1)
    return (Bc.reshape(*bc.shape[:-1], g, n),
            Cc.reshape(*bc.shape[:-1], g, n))


def _output(params: Params, y: torch.Tensor, z: torch.Tensor,
            x_dtype: torch.dtype, cfg: ModelConfig) -> torch.Tensor:
    """Gated RMS head norm and the output projection.  y: [..., di] fp32."""
    y = y.to(x_dtype) * F.silu(z)
    y = layers.rms_head_norm(params["norm"], y, cfg.norm_eps)
    return layers.linear_apply(params["out_proj"], y)


def ssm_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              gate_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Tuple]:
    """Full-sequence forward from a zero state.  x: [B, T, D]; gate_mask:
    [B, T] 0/1 keep mask.  Returns (out, ((conv_x_hist [B, W-1, di],
    conv_bc_hist [B, W-1, 2GN]), ssm_state [B, H, P, N] fp32))."""
    di, g, n, nh, p = _dims(cfg)
    B, T, _ = x.shape
    z = layers.linear_apply(params["in_proj_z"], x)
    xin = layers.linear_apply(params["in_proj_x"], x)
    bc = layers.linear_apply(params["in_proj_bc"], x)
    dt = layers.linear_apply(params["in_proj_dt"], x)

    W = cfg.ssm_conv
    conv_state = (_hist(xin, W), _hist(bc, W))
    xin = _causal_conv(xin, params["conv_x_w"], params["conv_x_b"])
    bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"])

    dt = F.softplus(dt.float() + params["dt_bias"])               # [B,T,H]
    if gate_mask is not None:
        dt = dt * gate_mask.float()[..., None]

    xh = xin.reshape(B, T, nh, p)
    Bm, Cm = _split_bc(bc, cfg)
    y, state = kops.ssd_scan(xh, dt, params["A_log"], Bm, Cm, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    if gate_mask is not None:
        y = y * gate_mask.float()[..., None, None]
    out = _output(params, y.reshape(B, T, di), z, x.dtype, cfg)
    return out, (conv_state, state)


def ssm_step(params: Params, x: torch.Tensor, cfg: ModelConfig,
             conv_state: Tuple[torch.Tensor, torch.Tensor],
             ssm_state: torch.Tensor,
             gate_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Tuple]:
    """Single-token decode (plain torch, as the reference's jnp step).
    x: [B, 1, D]; conv_state: (x_hist [B, W-1, di], bc_hist [B, W-1, 2GN])
    pre-activation inputs; ssm_state: [B, H, P, N] fp32; gate_mask: [B].
    Returns (out [B, 1, D], (new conv_state, new ssm_state))."""
    di, g, n, nh, p = _dims(cfg)
    B = x.shape[0]
    z = layers.linear_apply(params["in_proj_z"], x)
    xin = layers.linear_apply(params["in_proj_x"], x)
    bc = layers.linear_apply(params["in_proj_bc"], x)
    dt = layers.linear_apply(params["in_proj_dt"], x)

    def step_conv(raw, cs, w, b):
        window = torch.cat([cs, raw], dim=1)                      # [B, W, C]
        out = F.silu(torch.einsum("bwc,wc->bc", window, w) + b)
        return out, window[:, 1:, :]

    xin, cs_x = step_conv(xin, conv_state[0], params["conv_x_w"],
                          params["conv_x_b"])
    bc, cs_bc = step_conv(bc, conv_state[1], params["conv_bc_w"],
                          params["conv_bc_b"])

    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]          # [B, H]
    if gate_mask is not None:
        dt = dt * gate_mask.float()[:, None]
    dA = torch.exp(dt * -torch.exp(params["A_log"]))                # [B, H]

    xh = xin.reshape(B, nh, p).float()
    grp = torch.arange(nh, device=x.device) // (nh // g)
    Bm, Cm = (m.float()[:, grp] for m in _split_bc(bc, cfg))      # [B,H,N]
    upd = torch.einsum("bhp,bhn->bhpn", xh * dt[..., None], Bm)
    new_state = ssm_state * dA[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Cm, new_state)
    y = y + params["D"][None, :, None] * xh
    if gate_mask is not None:
        y = y * gate_mask.float()[:, None, None]
    out = _output(params, y.reshape(B, 1, di), z, x.dtype, cfg)
    return out, ((cs_x, cs_bc), new_state)
