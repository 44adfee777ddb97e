"""Paged KV-cache with a proactive pruned-token history buffer (paper §4.4).

Counterpart of the JAX package's ``kvcache/paged.py``.  The unit of storage
is one *(token, layer)* KV entry, stored only at the attention layers where
the token executed (layer 0 is the dense base): one physical entry serves
every layer in its validity interval, so a sequence stores about
``T·(1 + keep·(L−1))`` entries instead of ``T·L``.  Entries append
token-major into fixed-size pages drawn from a global free list
(``PageAllocator``, host side, numpy); per-slot *block tables* map logical
entry index → physical page.  Each entry carries ``(pos, l0, l1)`` and
attention masks by validity (``history.py``).

The device-side store is a dict of torch tensors.  Unlike the JAX
package's functional updates, ``pack_prefill`` and ``commit_decode`` write
into the store IN PLACE (the reference donates it to each jitted step; the
pool is the largest buffer of a paged run).  Each pool leaf is a view of a
buffer with one more row, the *drop row*: a scatter target the reference
drops (``mode="drop"``: inactive slots, non-fresh layers) lands there
instead, so a commit needs no host sync to filter its targets.  Build
stores with ``init_store`` (or ``bridge.store_from_numpy``), which
allocate that row.

The prefix cache's device helpers (``copy_page_masked``,
``views_from_pages``, ``chunk_cache_from_views``) are plain tensor code
(the reference computes them in jnp, outside any Pallas kernel); the
copy-on-write writes the store in place too, so a CUDA graph captured on
the store's addresses stays valid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kvcache import history
from repro_torch.serve.errors import PageExhausted

Store = Dict[str, torch.Tensor]

# Quantized page payloads: per-entry-per-head power-of-two scales.  "int4"
# packs two codes per byte along the head dim: byte d holds dims d (low
# nibble) and d + dh//2 (high nibble).
KV_DTYPES = (None, "int8", "int4")
_QMAX = {"int8": 127.0, "int4": 7.0}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def can_page(cfg: ModelConfig) -> bool:
    """Paged mode covers stacks whose every mixer is global attention with
    masked-mode routing (gather-mode gates would not describe entry
    freshness)."""
    all_global = all(k == ATTN for k in cfg.layer_pattern)
    gather = cfg.skip.enabled and cfg.skip.mode == "gather"
    return all_global and not gather


def reuse_enabled(cfg: ModelConfig) -> bool:
    """True when entry freshness follows the routing gates (layer 0 dense +
    executed layers).  Otherwise every layer writes (dense storage)."""
    return (cfg.skip.enabled and cfg.skip.kv_reuse
            and cfg.skip.route_attention)


def num_attention_layers(cfg: ModelConfig) -> int:
    return len(cfg.attention_layers)


# ---------------------------------------------------------------------------
# Host-side allocator (numpy, as in the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PageStats:
    pages_total: int = 0
    pages_in_use: int = 0
    pages_peak: int = 0
    entries_appended: int = 0        # live compact-store writes
    entries_dense: int = 0           # what per-layer dense stores would write


class PageAllocator:
    """Free-list page allocator + per-slot block tables (host side).

    ``slot_entry_capacity`` bounds one slot's entry count (worst case:
    ``max_len × n_attn_layers``), fixing the block-table width.  Pages are
    allocated on demand as a slot's fill crosses page boundaries and
    returned to the free list on eviction.

    Refcounts: a page is referenced by every slot chain it appears in plus
    every pin (``ref_pages``/``deref_pages``); it returns to the free list
    only when its refcount drops to zero, so ``release``/``trim`` never
    reclaim a page someone else still reads."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 slot_entry_capacity: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.pages_per_slot = -(-slot_entry_capacity // page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._chains: Dict[int, List[int]] = {s: [] for s in range(max_slots)}
        self.block_table = np.zeros((max_slots, self.pages_per_slot),
                                    np.int32)
        self.fill = np.zeros((max_slots,), np.int32)
        self.refcount = np.zeros((num_pages,), np.int32)
        self.stats = PageStats(pages_total=num_pages)

    # -- queries ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def capacity(self, slot: int) -> int:
        """Entry capacity currently backed by allocated pages."""
        return len(self._chains[slot]) * self.page_size

    def pages_for(self, n_entries: int) -> int:
        return -(-n_entries // self.page_size)

    def chain(self, slot: int) -> Tuple[int, ...]:
        """``slot``'s current page chain, in stream order (a copy)."""
        return tuple(self._chains[slot])

    def max_chain_pages(self) -> int:
        """Longest allocated page chain: the live width of the walk."""
        return max((len(c) for c in self._chains.values()), default=0)

    def can_reserve(self, slot: int, n_entries: int) -> bool:
        """Would ``ensure(slot, n_entries)`` succeed right now?"""
        if n_entries > self.pages_per_slot * self.page_size:
            return False
        short = self.pages_for(n_entries) - len(self._chains[slot])
        return short <= self.free_pages

    # -- mutation -----------------------------------------------------------
    def ensure(self, slot: int, n_entries: int) -> bool:
        """Grow ``slot``'s chain until it can hold ``n_entries`` entries.
        Returns False (no partial allocation) if the free list is short."""
        if not self.can_reserve(slot, n_entries):
            return False
        chain = self._chains[slot]
        while len(chain) * self.page_size < n_entries:
            page = self._free.pop()
            self.refcount[page] = 1
            self.block_table[slot, len(chain)] = page
            chain.append(page)
        in_use = self.num_pages - len(self._free)
        self.stats.pages_in_use = in_use
        self.stats.pages_peak = max(self.stats.pages_peak, in_use)
        return True

    def _drop_ref(self, page: int) -> bool:
        """Drop one reference; free the page iff that was the last one."""
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise AssertionError(f"page {page}: refcount underflow")
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False

    def alias_into(self, slot: int, pages: Sequence[int]) -> None:
        """Extend ``slot``'s *empty* chain with shared (fully filled) pages,
        one new reference each."""
        chain = self._chains[slot]
        if chain or self.fill[slot]:
            raise AssertionError(f"slot {slot}: alias_into needs an empty "
                                 "chain")
        for page in pages:
            if self.refcount[page] <= 0:
                raise AssertionError(f"page {page}: aliasing an "
                                     "unreferenced page")
            self.refcount[page] += 1
            self.block_table[slot, len(chain)] = page
            chain.append(page)

    def seed_fill(self, slot: int, n_entries: int) -> None:
        """Adopt ``n_entries`` already-materialized entries as ``slot``'s
        starting fill (not counted in ``entries_appended``)."""
        if n_entries > self.capacity(slot):
            raise AssertionError((n_entries, slot))
        self.fill[slot] = n_entries

    def ref_pages(self, pages: Sequence[int]) -> None:
        """Pin pages (one more reference each)."""
        for page in pages:
            if self.refcount[page] <= 0:
                raise AssertionError(f"page {page}: pinning an "
                                     "unreferenced page")
            self.refcount[page] += 1

    def deref_pages(self, pages: Sequence[int]) -> int:
        """Drop pins; frees pages nobody else holds.  Returns the number of
        pages returned to the free list."""
        freed = sum(1 for page in pages if self._drop_ref(page))
        self.stats.pages_in_use = self.num_pages - len(self._free)
        return freed

    def append(self, slot: int, n_entries: int, dense_entries: int) -> None:
        """Record ``n_entries`` committed writes (capacity must already be
        ensured).  ``dense_entries`` is the per-layer-dense baseline count
        for the same tokens."""
        self.fill[slot] += n_entries
        if self.fill[slot] > self.capacity(slot):
            raise PageExhausted(
                f"slot {slot}: fill {self.fill[slot]} exceeds page capacity "
                f"{self.capacity(slot)} — ensure() not called proactively",
                slot=slot, free_pages=self.free_pages,
                pages_total=self.num_pages)
        self.stats.entries_appended += n_entries
        self.stats.entries_dense += dense_entries

    def hide_pages(self, n: int = 0) -> List[int]:
        """Pop ``n`` pages (0 = all) off the free list; hand them back with
        :meth:`unhide_pages`, which restores the exact free-list order."""
        n = len(self._free) if n <= 0 else min(n, len(self._free))
        hidden = [self._free.pop() for _ in range(n)]
        self.stats.pages_in_use = self.num_pages - len(self._free)
        return hidden

    def unhide_pages(self, pages: List[int]) -> None:
        self._free.extend(reversed(pages))
        self.stats.pages_in_use = self.num_pages - len(self._free)

    def release(self, slot: int) -> int:
        """Evict: drop ``slot``'s reference on every page of its chain.
        Returns the number of pages detached from the chain."""
        chain = self._chains[slot]
        n = len(chain)
        for page in reversed(chain):
            self._drop_ref(page)
        chain.clear()
        self.block_table[slot] = 0
        self.fill[slot] = 0
        self.stats.pages_in_use = self.num_pages - len(self._free)
        return n

    def trim(self, slot: int) -> int:
        """Return the tail pages reserved beyond what the committed fill
        uses.  Returns the number of pages detached."""
        chain = self._chains[slot]
        keep = self.pages_for(int(self.fill[slot]))
        tail = chain[keep:]
        if not tail:
            return 0
        del chain[keep:]
        for page in reversed(tail):
            self._drop_ref(page)
        self.block_table[slot, keep:keep + len(tail)] = 0
        self.stats.pages_in_use = self.num_pages - len(self._free)
        return len(tail)

    def check_conservation(self, pinned: Optional[Dict[int, int]] = None
                           ) -> None:
        """Assert the refcount conservation invariant: every page is either
        free with refcount 0, or held with refcount equal to its chain
        memberships plus its pins (``pinned``: page -> pin count).  Raises
        AssertionError on any leak or double free."""
        pinned = pinned or {}
        expected = np.zeros((self.num_pages,), np.int64)
        for chain in self._chains.values():
            for page in chain:
                expected[page] += 1
        for page, n in pinned.items():
            expected[page] += n
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list has duplicates")
        for page in range(self.num_pages):
            if page in free:
                if not (self.refcount[page] == 0 and expected[page] == 0):
                    raise AssertionError(f"page {page}: free but "
                                         "referenced")
            elif not self.refcount[page] == expected[page] > 0:
                raise AssertionError(
                    f"page {page}: refcount {self.refcount[page]} != "
                    f"holders {expected[page]}")

    @property
    def saved_fraction(self) -> float:
        """Live compact-store saving."""
        if not self.stats.entries_dense:
            return 0.0
        return 1.0 - self.stats.entries_appended / self.stats.entries_dense


# ---------------------------------------------------------------------------
# Device-side store
# ---------------------------------------------------------------------------

def pool_leaf(shape: Sequence[int], dtype: torch.dtype, device,
              fill=0) -> torch.Tensor:
    """A [P, ps, ...] pool leaf viewing the first P·ps rows of a buffer that
    holds one more row, the drop row that ``_scatter`` writes dropped
    targets to."""
    P, ps = shape[0], shape[1]
    buf = torch.full((P * ps + 1,) + tuple(shape[2:]), fill, dtype=dtype,
                     device=device)
    return buf[:P * ps].view(tuple(shape))


def _with_drop_row(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf's flat [P·ps + 1, ...] buffer, drop row included."""
    P, ps = leaf.shape[:2]
    rest = tuple(leaf.shape[2:])
    row = int(np.prod(rest)) if rest else 1
    if not leaf.is_contiguous() or (
            leaf.untyped_storage().nbytes()
            < (leaf.storage_offset() + (P * ps + 1) * row)
            * leaf.element_size()):
        raise ValueError("store leaves must come from init_store or "
                         "bridge.store_from_numpy (a contiguous pool with "
                         "a drop row)")
    stride = tuple(leaf.stride()[1:])
    return leaf.as_strided((P * ps + 1,) + rest, stride)


def init_store(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype=None, kv_dtype: Optional[str] = None,
               device="cuda") -> Store:
    """Unified page pool shared by every slot and every attention layer, on
    ``device``.  ``kv_dtype`` selects the payload: None keeps full
    ``cfg.dtype`` rows; "int8"/"int4" store int8 codes plus one
    power-of-two scale per (entry, head) in ``k_scales``/``v_scales``."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    dt = dtype or _TORCH_DTYPES[cfg.dtype]
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    P, ps = num_pages, page_size
    if kv_dtype == "int4" and dh % 2:
        raise ValueError("int4 paged KV needs an even head_dim")
    dh_payload = dh if kv_dtype != "int4" else dh // 2
    kv_dt = dt if kv_dtype is None else torch.int8
    store = {
        "k_pages": pool_leaf((P, ps, Hkv, dh_payload), kv_dt, device),
        "v_pages": pool_leaf((P, ps, Hkv, dh_payload), kv_dt, device),
        "pos_pages": pool_leaf((P, ps), torch.int32, device,
                               history.MASKED_POS),
        "l0_pages": pool_leaf((P, ps), torch.int32, device),
        "l1_pages": pool_leaf((P, ps), torch.int32, device),
    }
    if kv_dtype is not None:
        store["k_scales"] = pool_leaf((P, ps, Hkv), torch.float32, device, 1)
        store["v_scales"] = pool_leaf((P, ps, Hkv), torch.float32, device, 1)
    return store


def infer_kv_dtype(store: Store, cfg: ModelConfig) -> Optional[str]:
    """The page payload format from the store's structure: scales + full
    head dim -> int8; scales + halved head dim -> nibble-packed int4."""
    if "k_scales" not in store:
        return None
    return ("int8" if store["k_pages"].shape[-1] == cfg.resolved_head_dim
            else "int4")


def quantize_entries(k: torch.Tensor, v: torch.Tensor, kv_dtype: str):
    """[..., Hkv, dh] KV rows -> (k_codes, v_codes, k_scale, v_scale).
    Scales are per (entry, head) powers of two."""
    qmax = _QMAX[kv_dtype]

    def quant(x):
        x = x.float()
        amax = x.abs().amax(dim=-1)                              # [..., Hkv]
        scale = torch.exp2(torch.ceil(torch.log2(
            torch.clamp(amax / qmax, min=1e-12))))
        scale = torch.where(amax > 0, scale, torch.ones_like(scale))
        codes = torch.clamp(torch.round(x / scale[..., None]),
                            -qmax, qmax).to(torch.int8)
        if kv_dtype == "int4":
            dh = codes.shape[-1]
            c = codes.to(torch.int32)
            lo = c[..., :dh // 2] & 0x0F
            hi = c[..., dh // 2:] & 0x0F
            # the nibble pair as one unsigned byte, viewed as int8 (an int8
            # shift by 4 would overflow)
            codes = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
        return codes, scale

    k_codes, k_scale = quant(k)
    v_codes, v_scale = quant(v)
    return k_codes, v_codes, k_scale, v_scale


def dequantize_entries(codes: torch.Tensor, scale: torch.Tensor,
                       kv_dtype: str) -> torch.Tensor:
    """Invert ``quantize_entries``: codes [..., Hkv, dhp] + scale [..., Hkv]
    -> f32 [..., Hkv, dh]."""
    if kv_dtype == "int4":
        c = codes.to(torch.int32)
        lo = ((c & 0x0F) ^ 8) - 8                   # sign-extend low nibble
        hi = (((c >> 4) & 0x0F) ^ 8) - 8            # sign-extend high nibble
        codes = torch.cat([lo, hi], dim=-1)
    return codes.float() * scale[..., None].float()


def store_bytes(store: Store, data_only: bool = True) -> int:
    if data_only:
        keys = tuple(k for k in ("k_pages", "v_pages", "k_scales",
                                 "v_scales") if k in store)
    else:
        keys = tuple(store)
    return sum(store[k].numel() * store[k].element_size() for k in keys)


def entry_bytes(cfg: ModelConfig, kv_dtype: Optional[str] = None) -> int:
    """Payload bytes one (token, layer) entry costs: K+V codes plus
    scales.  The full-precision baseline is 2·Hkv·dh·itemsize."""
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if kv_dtype is None:
        itemsize = torch.empty((), dtype=_TORCH_DTYPES[cfg.dtype]
                               ).element_size()
        return 2 * Hkv * dh * itemsize
    per_head = dh if kv_dtype == "int8" else dh // 2
    return 2 * Hkv * (per_head + 4)               # int8 codes + f32 scale


def gather_view(store: Store, block_table: torch.Tensor,
                with_kv: bool = True,
                kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Resolve each slot's page chain into logical entry order.

    block_table: [S, J] int.  Returns [S, J·ps(, ...)] arrays: metadata
    always, K/V (dequantized with a quantized store) when ``with_kv``."""
    S, J = block_table.shape
    ps = store["pos_pages"].shape[1]
    flat = block_table.reshape(-1).long()

    def take(leaf):
        return leaf.index_select(0, flat).reshape(
            (S, J * ps) + tuple(leaf.shape[2:]))

    out = {"pos": take(store["pos_pages"]),
           "l0": take(store["l0_pages"]),
           "l1": take(store["l1_pages"])}
    if with_kv:
        if kv_dtype is None:
            out["k"] = take(store["k_pages"])
            out["v"] = take(store["v_pages"])
        else:
            out["k"] = dequantize_entries(take(store["k_pages"]),
                                          take(store["k_scales"]), kv_dtype)
            out["v"] = dequantize_entries(take(store["v_pages"]),
                                          take(store["v_scales"]), kv_dtype)
    return out


def _flat_targets(block_table: torch.Tensor, e: torch.Tensor,
                  valid: torch.Tensor, page_size: int,
                  num_pages: int) -> torch.Tensor:
    """Logical per-slot entry index -> flat physical index into the pools
    (``num_pages·page_size``, the drop row, where invalid).
    block_table: [S, J]; e, valid: [S, N] (slot-major)."""
    J = block_table.shape[1]
    j = torch.clamp(e // page_size, 0, J - 1).long()
    pages = torch.gather(block_table.long(), 1, j)                # [S, N]
    phys = pages * page_size + e.long() % page_size
    return torch.where(valid, phys, torch.full_like(phys,
                                                    num_pages * page_size))


def _scatter(store: Store, idx: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, pos: torch.Tensor, l0: torch.Tensor,
             l1: torch.Tensor, kv_dtype: Optional[str] = None) -> Store:
    """Write entries at flat physical indices, IN PLACE.  The reference
    drops out-of-range targets (``mode="drop"``); here every target is in
    [0, P·ps] and the dropped ones all land on the drop row, so no host
    sync filters them.  With a quantized store, full-precision KV rows are
    quantized here (the single write choke point)."""
    P, ps = store["pos_pages"].shape
    flat = idx.reshape(-1).long()

    def put(pages, vals):
        full = _with_drop_row(pages)
        full.index_put_((flat,), vals.reshape(
            (-1,) + tuple(pages.shape[2:])).to(pages.dtype))

    if kv_dtype is None:
        put(store["k_pages"], k)
        put(store["v_pages"], v)
    else:
        kc, vc, k_sc, v_sc = quantize_entries(k, v, kv_dtype)
        put(store["k_pages"], kc)
        put(store["v_pages"], vc)
        put(store["k_scales"], k_sc)
        put(store["v_scales"], v_sc)
    put(store["pos_pages"], pos)
    put(store["l0_pages"], l0)
    put(store["l1_pages"], l1)
    return store


# ---------------------------------------------------------------------------
# Prefill packing (one slot)
# ---------------------------------------------------------------------------

def prefill_views_from_cache(cache: List[Dict], cfg: ModelConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack the prefill cache's per-layer KV views (the port keeps one
    {"k", "v"} [1, T, Hkv, dh] dict per layer) into [nA, T, Hkv, dh]."""
    k = torch.stack([ce["k"][0] for ce in cache])
    v = torch.stack([ce["v"][0] for ce in cache])
    return k, v


def pack_prefill(store: Store, cache: List[Dict], gates: torch.Tensor,
                 valid_len: int, block_table: torch.Tensor,
                 cfg: ModelConfig, start_token: int = 0,
                 start_entry: int = 0,
                 kv_dtype: Optional[str] = None) -> Store:
    """Scatter one prefilled prompt's compact entries into its pages (in
    place).

    gates: [nA, T] execution gates (T may include right-padding; tokens at
    index >= valid_len are dropped).  Entries are token-major — token t's
    fresh layers are contiguous — so decode appends continue the stream.
    ``start_token``/``start_entry`` offset a warm-prefix suffix pack."""
    k_views, v_views = prefill_views_from_cache(cache, cfg)
    nA, T = gates.shape
    k_views = k_views[:, :T]
    v_views = v_views[:, :T]
    ps = store["pos_pages"].shape[1]
    P = store["pos_pages"].shape[0]
    dev = gates.device

    tok = torch.arange(T, device=dev)
    fresh = history.fresh_mask(gates, reuse_enabled(cfg))        # [nA, T]
    fresh = fresh & (tok[None, :] < valid_len) & (tok[None, :] >= start_token)
    freshT = fresh.T.contiguous()                                # [T, nA]
    f = freshT.reshape(-1).to(torch.int32)
    e = (torch.cumsum(f, 0, dtype=torch.int32) - f).reshape(T, nA)
    e = e + start_entry
    l1 = history.next_fresh_layer(fresh).T                       # [T, nA]

    idx = _flat_targets(block_table.reshape(1, -1), e.reshape(1, T * nA),
                        freshT.reshape(1, T * nA), ps, P)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[:, None].expand(
        T, nA)
    l0 = torch.arange(nA, dtype=torch.int32, device=dev)[None, :].expand(
        T, nA)
    return _scatter(store, idx.reshape(T, nA),
                    k_views.transpose(0, 1), v_views.transpose(0, 1),
                    pos, l0, l1, kv_dtype=kv_dtype)


def prefill_entry_count(gates: np.ndarray, valid_len: int,
                        reuse: bool) -> int:
    """Host-side mirror of ``pack_prefill``'s entry count."""
    return int(history.fresh_counts(gates, valid_len, reuse).sum())


# ---------------------------------------------------------------------------
# Prefix sharing: copy-on-write + warm-prefix reconstruction
# ---------------------------------------------------------------------------

def copy_page_masked(store: Store, src: int, dst: int, keep: int) -> Store:
    """Copy page ``src`` into private page ``dst`` IN PLACE, keeping only
    the first ``keep`` in-page entries (the shared-prefix part of a partial
    boundary page).  Entries past ``keep`` are blanked (position
    MASKED_POS, payload, scales and l0/l1 zero), so the copy carries
    nothing of the donor slot's divergent suffix.  Every leaf is written
    through its own storage, never rebound, and the drop row is not
    touched."""
    ps = store["pos_pages"].shape[1]
    m = torch.arange(ps, device=store["pos_pages"].device) < keep
    for key, leaf in store.items():
        row = leaf[src]
        mask = m.reshape((ps,) + (1,) * (row.ndim - 1))
        blank = torch.full_like(row, history.MASKED_POS if
                                key == "pos_pages" else 0)
        leaf[dst].copy_(torch.where(mask, row, blank))
    return store


def views_from_pages(store: Store, block_table: torch.Tensor, fill: int,
                     cfg: ModelConfig, cap: int,
                     kv_dtype: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert one slot's entry stream into per-layer prefill views.

    block_table: [J] the slot's page chain (its first ``pages_for(fill)``
    pages are enough); fill: the entry count; cap: the time extent of the
    views.  For each attention layer the entry valid at that layer goes
    back to its token position — the exact inverse of ``pack_prefill``
    (cross-layer reuse means one physical entry may serve many layers).
    Quantized stores are dequantized on the way (``gather_view``), so the
    views are full precision.  Returns (k_views, v_views): [nA, cap, Hkv,
    dh]; positions the stream does not cover stay zero (as in a fresh
    ``init_chunk_cache``).  ``views_from_pages_batch`` does it for every
    slot of a block table at once."""
    fill = torch.full((1,), int(fill), dtype=torch.int32,
                      device=store["pos_pages"].device)
    k, v = views_from_pages_batch(store, block_table.reshape(1, -1), fill,
                                  cfg, cap, kv_dtype=kv_dtype)
    return k[:, 0], v[:, 0]


def views_from_pages_batch(store: Store, block_table: torch.Tensor,
                           fill: torch.Tensor, cfg: ModelConfig, cap: int,
                           kv_dtype: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``views_from_pages`` over S slots: block_table [S, J], fill [S] (each
    slot's entry count: a speculative verify passes the pre-draft fill, so
    the draft's tentative entries above it stay out).  Returns (k_views,
    v_views): [nA, S, cap, Hkv, dh], layer-major, so ``[a]`` is layer a's
    time-major staging cache for the S slots.

    The reference scatters each layer's rows (``mode="drop"`` losing
    MASKED_POS and positions ≥ cap).  Here one scatter of entry indices,
    every layer and slot at once, builds an [nA, S, cap] map (dropped
    targets land in a spare column past ``cap``; uncovered positions keep
    the index of a zero row), and one gather reads the rows: the same
    values, a few launches and no host sync, and only nA·S·cap rows
    written instead of nA·S·E."""
    view = gather_view(store, block_table, with_kv=True, kv_dtype=kv_dtype)
    S, E = view["pos"].shape
    nA, dev = num_attention_layers(cfg), view["pos"].device
    fill = fill.to(device=dev, dtype=torch.int32)
    layer = torch.arange(nA, device=dev)[None, :, None]
    in_fill = (torch.arange(E, device=dev)[None] < fill[:, None])[:, None]
    eff = history.effective_positions(
        view["pos"][:, None], view["l0"][:, None], view["l1"][:, None],
        in_fill, layer).transpose(0, 1).long()              # [nA, S, E]
    col = torch.where((eff >= 0) & (eff < cap), eff,
                      torch.full_like(eff, cap))
    lane = (torch.arange(nA, device=dev)[:, None] * S
            + torch.arange(S, device=dev)[None])[..., None]   # [nA, S, 1]
    flat = (lane * (cap + 1) + col).reshape(-1)
    if dev.type == "cpu":
        hits = torch.zeros(nA * S * (cap + 1), dtype=torch.int64).index_add_(
            0, flat, torch.ones_like(flat)).view(nA, S, cap + 1)[..., :cap]
        assert int(hits.max()) <= 1, \
            "two admitted entries share a position within a layer"
    # row s·(E + 1) + e of the slots' rows, each slot followed by a zero row
    row = (torch.arange(S, device=dev)[:, None] * (E + 1)
           + torch.arange(E, device=dev)[None])                # [S, E]
    src = (torch.arange(S, device=dev)[None, :, None] * (E + 1) + E
           ).expand(nA, S, cap + 1).reshape(-1).clone()
    src.index_put_((flat,), row[None].expand(nA, S, E).reshape(-1))
    src = src.view(nA, S, cap + 1)[..., :cap].reshape(-1)

    def rows(x):
        x = torch.cat([x, x.new_zeros((S, 1) + tuple(x.shape[2:]))], dim=1)
        x = x.reshape((S * (E + 1),) + tuple(x.shape[2:]))
        return x.index_select(0, src).view((nA, S, cap)
                                           + tuple(x.shape[1:]))

    return rows(view["k"]), rows(view["v"])


def chunk_cache_from_views(k_views: torch.Tensor, v_views: torch.Tensor,
                           cfg: ModelConfig, dtype=None) -> List[Dict]:
    """Per-layer views [nA, cap, Hkv, dh] -> a batch-1 staging cache in
    ``model.init_chunk_cache``'s layout (a list of per-layer {"k", "v"}
    [1, cap, Hkv, dh]), so a warm admission resumes chunked prefill where
    the shared prefix's prefill left off."""
    assert k_views.shape[0] == cfg.num_layers == num_attention_layers(cfg), (
        k_views.shape, cfg.num_layers)
    dt = dtype or _TORCH_DTYPES[cfg.dtype]
    return [{"k": k_views[a].to(dt)[None], "v": v_views[a].to(dt)[None]}
            for a in range(k_views.shape[0])]


# ---------------------------------------------------------------------------
# Decode commit (all slots, one token each)
# ---------------------------------------------------------------------------

def commit_decode(store: Store, buf_k: torch.Tensor, buf_v: torch.Tensor,
                  gates: torch.Tensor, t: torch.Tensor,
                  block_table: torch.Tensor, fill: torch.Tensor,
                  active: torch.Tensor, cfg: ModelConfig,
                  kv_dtype: Optional[str] = None) -> Store:
    """Append this step's fresh entries for every active slot (in place).

    buf_k/buf_v: [nA, S, Hkv, dh] — each attention layer's token view;
    only fresh layers' views are written.  gates: [nA, S];
    t/fill/active: [S]."""
    nA, S = gates.shape
    ps = store["pos_pages"].shape[1]
    P = store["pos_pages"].shape[0]
    fresh = history.fresh_mask(gates, reuse_enabled(cfg)) & active[None, :]
    f = fresh.to(torch.int32)
    e = fill.to(torch.int32)[None, :] + torch.cumsum(f, 0,
                                                     dtype=torch.int32) - f
    l1 = history.next_fresh_layer(fresh)                          # [nA, S]
    idx = _flat_targets(block_table, e.T, fresh.T, ps, P).T
    pos = t.to(torch.int32)[None, :].expand(nA, S)
    l0 = torch.arange(nA, dtype=torch.int32,
                      device=gates.device)[:, None].expand(nA, S)
    return _scatter(store, idx, buf_k, buf_v, pos, l0, l1, kv_dtype=kv_dtype)
