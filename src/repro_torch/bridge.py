"""Parameter bridge between the JAX package's pytree and the port.

The reference keeps ``embed.table``, ``stack.stage0.pos{k}`` (one stage,
unrolled), ``stack.stages.pos{k}`` (the other stages, every leaf stacked
[S-1, ...] for ``lax.scan``), ``final_norm`` and ``lm_head``.  The port
keeps one list ``blocks`` with a dict per layer: layer ``s·stage_len + k``
is stage s's ``pos{k}`` (stage 0 from ``stage0``, stage s ≥ 1 from slice
s-1 of ``stages``).  Every leaf is carried bit for bit and never
re-quantized: dense ``w`` leaves and the quantized linears' int8 ``w_int``
codes with their fp32 ``scale`` rows alike, in a mixed tree too (the
reference's ``quantize_params`` quantizes the 2-D ``stage0`` and
``lm_head`` leaves and leaves the stacked ``stages`` dense).

The bridge takes and gives plain numpy arrays (``np.asarray`` of each JAX
leaf); it imports nothing of JAX.  bfloat16 leaves arrive as numpy arrays
whose dtype is named "bfloat16" and are carried through their 16-bit
patterns; ``to_reference`` returns them as uint16 bit patterns.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.paged import pool_leaf


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """Bit-exact numpy -> torch, bfloat16 included."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bfloat16 comes back as its uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def from_reference(ref_params: Dict, cfg: ModelConfig, device="cpu") -> Dict:
    """Reference pytree (numpy leaves) -> the port's nested params."""
    stack = ref_params["stack"]
    S, k_len = cfg.num_stages, cfg.stage_len
    blocks = []
    for s in range(S):
        for k in range(k_len):
            if s == 0:
                src = stack["stage0"][f"pos{k}"]
            else:
                src = _map(stack["stages"][f"pos{k}"],
                           lambda a, i=s - 1: a[i])
            blocks.append(_map(src, lambda a: tensor_from_numpy(a, device)))
    out = {"embed": _map(ref_params["embed"],
                         lambda a: tensor_from_numpy(a, device)),
           "blocks": blocks,
           "final_norm": _map(ref_params["final_norm"],
                              lambda a: tensor_from_numpy(a, device))}
    if "lm_head" in ref_params:
        out["lm_head"] = _map(ref_params["lm_head"],
                              lambda a: tensor_from_numpy(a, device))
    return out


def to_reference(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's params -> the reference pytree layout (numpy leaves,
    ``stages`` leaves re-stacked)."""
    S, k_len = cfg.num_stages, cfg.stage_len
    blocks = [_map(b, tensor_to_numpy) for b in params["blocks"]]
    stack = {"stage0": {f"pos{k}": blocks[k] for k in range(k_len)}}
    if S > 1:
        def stacked(k):
            per = [blocks[s * k_len + k] for s in range(1, S)]
            return _stack(per)
        stack["stages"] = {f"pos{k}": stacked(k) for k in range(k_len)}
    out = {"embed": _map(params["embed"], tensor_to_numpy), "stack": stack,
           "final_norm": _map(params["final_norm"], tensor_to_numpy)}
    if "lm_head" in params:
        out["lm_head"] = _map(params["lm_head"], tensor_to_numpy)
    return out


def store_from_numpy(store: Dict[str, np.ndarray], device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    """A paged KV store dict (numpy leaves, e.g. ``np.asarray`` of each leaf
    of the JAX package's ``kvcache.paged`` store) -> the port's store, bit
    for bit, each pool leaf allocated with the drop row the port's scatters
    need (``kvcache.paged.pool_leaf``)."""
    out = {}
    for name, a in store.items():
        t = tensor_from_numpy(a, device)
        leaf = pool_leaf(t.shape, t.dtype, device)
        leaf.copy_(t)
        out[name] = leaf
    return out


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
