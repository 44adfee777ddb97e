"""Cross-layer history-buffer indirection + hit accounting (paper §4.4.2).

Counterpart of the JAX package's ``kvcache/history.py``.  The paged store
(``paged.py``) keeps ONE physical entry per (token, executed-layer) pair.
Each entry's metadata is its token position ``pos`` and validity interval
``[l0, l1)`` over the attention-layer index: ``l0`` is the layer that wrote
it, ``l1`` the token's next execution (or ``nA``: still current).
Attention at layer ``a`` turns metadata into *effective positions*: a valid
entry keeps its token position (the causal mask admits it), an invalid one
becomes ``MASKED_POS``.  Exactly one entry per token is valid at any layer,
so masked attention over the entry stream equals dense attention over
per-layer caches.

The device functions take torch tensors; the host-side accounting
(``host_fresh_mask``, ``fresh_counts``, ``HistoryAccounting``) is numpy, as
in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

# Sentinel "position" for invalid entries: the causal mask (kv_pos <= q_pos)
# can never admit it.
MASKED_POS = int(np.iinfo(np.int32).max)


def fresh_mask(gates: torch.Tensor, reuse: bool) -> torch.Tensor:
    """[nA, ...] execution gates -> bool mask of layers that write a fresh
    entry.  The first attention layer is the dense base (always fresh);
    with reuse disabled every layer writes."""
    g = gates != 0
    if not reuse:
        return torch.ones_like(g)
    g = g.clone()
    g[0] = True
    return g


def next_fresh_layer(fresh: torch.Tensor) -> torch.Tensor:
    """For each (layer a, ...) the index of the next fresh layer > a, or
    ``nA`` when none: each written entry's ``l1``.  An exclusive suffix
    minimum over layers (flip, cummin, flip, shift by one)."""
    nA = fresh.shape[0]
    lead = torch.arange(nA, dtype=torch.int32, device=fresh.device).reshape(
        (nA,) + (1,) * (fresh.ndim - 1))
    idxs = torch.where(fresh, lead, torch.full_like(lead, nA))
    suffix = torch.flip(torch.cummin(torch.flip(idxs, (0,)), dim=0).values,
                        (0,))
    return torch.cat([suffix[1:], torch.full_like(idxs[:1], nA)], dim=0)


def effective_positions(pos: torch.Tensor, l0: torch.Tensor,
                        l1: torch.Tensor, in_fill: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """Entry metadata -> per-layer effective KV positions.

    pos/l0/l1/in_fill: [S, E] gathered entry metadata (logical order);
    ``layer``: attention-layer index.  Valid entries keep their token
    position; everything else becomes MASKED_POS."""
    valid = in_fill & (l0 <= layer) & (layer < l1)
    return torch.where(valid, pos, torch.full_like(pos, MASKED_POS)).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Host-side hit accounting (numpy)
# ---------------------------------------------------------------------------

def host_fresh_mask(gates: np.ndarray, reuse: bool) -> np.ndarray:
    """Numpy mirror of :func:`fresh_mask`: [nA, ...] gate log -> bool mask
    of (layer, token) entries the compact store physically writes."""
    g = np.asarray(gates, np.float32) > 0.5
    if not reuse:
        return np.ones_like(g)
    g[0] = True
    return g


def fresh_counts(gates: np.ndarray, valid_len: int, reuse: bool
                 ) -> np.ndarray:
    """[nA, T] prompt gate log -> per-layer fresh-entry counts over the
    first ``valid_len`` tokens (shared by ``HistoryAccounting`` and
    ``paged.prefill_entry_count``)."""
    return host_fresh_mask(gates, reuse)[:, :valid_len].sum(
        axis=1).astype(np.int64)


class HistoryAccounting:
    """Per-layer history-buffer hit rates, fed from the live gate log.

    At each decode step, attention at layer ``a`` reads one entry per
    context token; the read *hits* the history buffer when that token's
    current entry was written at a layer < a.  ``_fresh`` tracks, per slot
    and layer, how many context tokens are fresh at that layer, so
    hits = context − fresh without replaying old gates."""

    def __init__(self, n_layers: int, max_slots: int, reuse: bool = True):
        self.nA = n_layers
        self.reuse = reuse
        self._fresh = np.zeros((max_slots, n_layers), np.int64)
        self._ctx = np.zeros((max_slots,), np.int64)
        self.hits = np.zeros((n_layers,), np.int64)
        self.reads = np.zeros((n_layers,), np.int64)

    def on_prefill(self, slot: int, gates: np.ndarray, valid_len: int
                   ) -> None:
        """gates: [nA, T] prompt execution gates (may include padding).
        Accounting starts at decode, the regime the buffer targets."""
        self._fresh[slot] = fresh_counts(gates, valid_len, self.reuse)
        self._ctx[slot] = valid_len

    def on_decode_step(self, slot: int, gates_col: np.ndarray) -> None:
        """gates_col: [nA] this step's gates for ``slot``.  Reads happen
        against the pre-step context; then the new token's entries join."""
        self.reads += self._ctx[slot]
        self.hits += self._ctx[slot] - self._fresh[slot]
        self._fresh[slot] += host_fresh_mask(gates_col[:, None],
                                             self.reuse)[:, 0]
        self._ctx[slot] += 1

    def on_release(self, slot: int) -> None:
        self._fresh[slot] = 0
        self._ctx[slot] = 0

    @property
    def per_layer_hit_rate(self) -> List[float]:
        return [float(h / r) if r else 0.0
                for h, r in zip(self.hits, self.reads)]

    @property
    def hit_rate(self) -> float:
        r = int(self.reads.sum())
        return float(self.hits.sum() / r) if r else 0.0
