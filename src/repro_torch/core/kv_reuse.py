"""Cross-layer KV reuse (paper §2.1 Eq. 2 and §4.4): a token that skips
attention at layer l inherits its K/V from the last layer where it ran,
realised as the dense select ``view_l = where(gate_l, kv_new_l, view_{l-1})``.

Counterpart of the JAX package's ``core/kv_reuse.py``, masked and gather
mode.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import routing

KVPair = Tuple[torch.Tensor, torch.Tensor]   # (k, v): [B, T, Hkv, dh]


def init_view(k_new: torch.Tensor, v_new: torch.Tensor) -> KVPair:
    """Base case: at the first attention layer the view is the fresh KV."""
    return k_new, v_new


def merge_view(view: Optional[KVPair], k_new: torch.Tensor,
               v_new: torch.Tensor, gate: torch.Tensor) -> KVPair:
    """Dense select realising Eq. 2.  gate: [B, T] (1 = executed)."""
    if view is None:
        return init_view(k_new, v_new)
    g = gate.bool()[:, :, None, None]
    return torch.where(g, k_new, view[0]), torch.where(g, v_new, view[1])


def merge_view_gathered(view: Optional[KVPair], k_new: torch.Tensor,
                        v_new: torch.Tensor, idx: torch.Tensor, T: int
                        ) -> KVPair:
    """Gather-mode variant: KV was computed for the compacted tokens only
    (k_new/v_new [B, C, Hkv, dh]); a copy of the view with those rows
    written at their positions ``idx`` [B, C].  The base case needs every
    token's KV (the first attention layer runs dense KV)."""
    if view is None:
        assert k_new.shape[1] == T, "first attention layer must be dense"
        return k_new, v_new
    return (routing.scatter_set_tokens(view[0], idx, k_new),
            routing.scatter_set_tokens(view[1], idx, v_new))


def merge_token_view(kv_prev: Optional[KVPair], k_new: torch.Tensor,
                     v_new: torch.Tensor, gate: torch.Tensor) -> KVPair:
    """Decode-time single-token view.  k_new/v_new: [B, 1, Hkv, dh];
    gate: [B]."""
    if kv_prev is None:
        return k_new, v_new
    g = gate.bool()[:, None, None, None]
    return torch.where(g, k_new, kv_prev[0]), torch.where(g, v_new, kv_prev[1])


def storage_saved_fraction(gates: torch.Tensor) -> torch.Tensor:
    """Fraction of per-layer KV slots the compact store avoids writing.
    gates: [L, B, T] (layer 0 counts as dense — the view base case)."""
    L, B, T = gates.shape
    stored = gates[1:].sum() + B * T
    return 1.0 - stored / (L * B * T)
