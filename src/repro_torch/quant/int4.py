"""Symmetric int4 weight quantization (paper §5.1) with power-of-2
("BFP-friendly") per-group scales (paper §4.2.2).

Counterpart of the JAX package's ``quant/int4.py``, written so that codes
and scales equal the reference's bit for bit: fp32 arithmetic, the same
``ceil(log2(·))`` exponent formula and half-to-even rounding
(``torch.round``, like ``jnp.round``).  Codes are int8 in [-8, 7], one per
byte; power-of-2 scales let the int4 kernels accumulate int8×int4 products
in fixed point and rebuild floating point once per group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

INT4_MIN, INT4_MAX = -8, 7


def quantize_rtn(w: torch.Tensor, group_size: int = 128,
                 pow2_scales: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: [K, N] -> (codes int8 in [-8, 7] of shape [ceil(K/G)·G, N],
    scales fp32 [ceil(K/G), N]), G = min(group_size, K).

    When K is not a group multiple the last group is zero-padded: padding
    never raises a group's amax and its zero codes add nothing, so the
    matmuls zero-pad the activation's K to match."""
    K, N = w.shape
    G = min(group_size, K)
    Kp = -(-K // G) * G
    wf = w.float()
    if Kp != K:
        wf = torch.cat([wf, wf.new_zeros((Kp - K, N))])
    wg = wf.reshape(Kp // G, G, N)
    amax = wg.abs().amax(dim=1)                          # [K/G, N]
    scale = amax / INT4_MAX
    if pow2_scales:
        # smallest power of 2 >= scale (the exact BFP exponent domain)
        scale = torch.exp2(torch.ceil(torch.log2(
            torch.clamp(scale, min=1e-12))))
    scale = torch.where(amax == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(wg / scale[:, None, :]),
                        INT4_MIN, INT4_MAX)
    return codes.reshape(Kp, N).to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               k: int = 0) -> torch.Tensor:
    """codes: [Kw, N] (possibly group-padded) -> [k or Kw, N] fp32."""
    Kw, N = codes.shape
    G = Kw // scale.shape[0]
    w = (codes.float().reshape(Kw // G, G, N)
         * scale[:, None, :].float()).reshape(Kw, N)
    return w[:k] if k else w


def quantize_params(params, group_size: int = 128, pow2_scales: bool = True,
                    min_size: int = 1 << 16):
    """Replace every 2-D linear weight leaf named ``w`` of at least
    ``min_size`` elements with {"w_int", "scale"}; the routers, norms and
    the embedding table stay as they are.  The reference's rule, applied to
    the port's tree: its per-layer ``blocks`` hold 2-D leaves in every
    layer, so all layers and the lm head are quantized (the reference's
    scan-stacked ``stages`` leaves are 3-D and stay dense there).  Returns
    a new tree; unquantized leaves are shared."""
    def walk(tree):
        if isinstance(tree, dict):
            out: Dict = {}
            for k, v in tree.items():
                if (k == "w" and isinstance(v, torch.Tensor) and v.ndim == 2
                        and v.numel() >= min_size):
                    out["w_int"], out["scale"] = quantize_rtn(
                        v, group_size, pow2_scales)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def int4_linears(params) -> bool:
    """Whether the blocks' linears hold int4 codes (``quantize_params``
    treats every block alike, so the first block's mixer says)."""
    inner = params["blocks"][0]["mixer"]["inner"]
    return any(isinstance(v, dict) and "w_int" in v for v in inner.values())


def int4_head(params) -> bool:
    """Whether the lm head is an int4 linear (a tied head, gemma3-12b's,
    is the embedding's transpose: a plain matmul, as the reference's)."""
    return "w_int" in params.get("lm_head", {})
