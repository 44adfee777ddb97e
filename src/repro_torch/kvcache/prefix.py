"""Host-side prefix cache: refcounted sharing of prompt-prefix pages.

Counterpart of the JAX package's ``kvcache/prefix.py`` (its own copy: the
port imports nothing of that package).  Serving traffic is dominated by
shared system prompts and multi-turn reuse; this registry turns one
request's prefill into pages the next request reuses:

* After a cold prefill completes, the engine *publishes* the prompt at
  every ``block``-token boundary: each boundary becomes a
  :class:`PrefixRecord` — the token prefix, its execution gates, its entry
  count, and the page-chain prefix that physically holds those entries.
  Publishing pins the pages (``PageAllocator.ref_pages``), so they survive
  the owning slot's release.

* At admission the engine *probes* with the new prompt; the longest
  matching record (capped at ``len(prompt) - 1``: at least one cold token
  must remain to produce the first token's logits) is aliased into the new
  slot's block table (``alias_into``), its partial boundary page is
  copied on write (``paged.copy_page_masked``), and prefill runs only on
  the cold suffix.

* Under page pressure the engine evicts least-recently-used records
  (``evict_one``) before preempting residents; a record in use by an
  in-flight admission is pinned (``in_use``) and never evicted.

Records never copy KV to the host: the pages themselves are the store, and
``paged.views_from_pages`` rebuilds the staging cache on the device when a
warm suffix needs attention context.  Keys are BLAKE2b digests of the raw
token prefix; the record keeps the exact token tuple and lookup verifies
it, so a digest collision can never alias the wrong prefix.  Host numpy
and ``hashlib`` only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kvcache.paged import PageAllocator, prefill_entry_count


def _digest(tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


@dataclasses.dataclass
class PrefixRecord:
    key: bytes
    tokens: Tuple[int, ...]          # the exact prefix (collision guard)
    entries: int                     # packed entry count E_s of the prefix
    pages: Tuple[int, ...]           # page-chain prefix holding the entries
    gates: np.ndarray                # [nA, Ts] the prefix's execution gates
    in_use: int = 0                  # in-flight warm admissions reading it
    stamp: int = 0                   # LRU clock

    @property
    def length(self) -> int:
        return len(self.tokens)


class PrefixCache:
    """LRU registry of published prompt prefixes over a PageAllocator."""

    def __init__(self, alloc: PageAllocator, block: int, reuse: bool,
                 max_records: int = 256):
        if block < 1:
            raise ValueError("prefix block must be >= 1 token")
        self.alloc = alloc
        self.block = block
        self.reuse = reuse
        self.max_records = max_records
        self._records: Dict[bytes, PrefixRecord] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def lookup(self, tokens: Sequence[int]) -> Optional[PrefixRecord]:
        """Longest published record matching a strict prefix of ``tokens``
        (at most ``len(tokens) - 1`` tokens: the last prompt token always
        prefills cold, so admission still produces first-token logits)."""
        toks = tuple(int(t) for t in tokens)
        top = ((len(toks) - 1) // self.block) * self.block
        for ts in range(top, 0, -self.block):
            rec = self._records.get(_digest(toks[:ts]))
            if rec is not None and rec.tokens == toks[:ts]:
                self._clock += 1
                rec.stamp = self._clock
                self.hits += 1
                self.tokens_saved += rec.length
                return rec
        self.misses += 1
        return None

    def pin(self, rec: PrefixRecord) -> None:
        rec.in_use += 1

    def unpin(self, rec: PrefixRecord) -> None:
        rec.in_use -= 1
        assert rec.in_use >= 0, "prefix record unpinned below zero"

    def page_pins(self) -> Dict[int, int]:
        """page -> number of records pinning it (for
        ``PageAllocator.check_conservation``)."""
        pins: Dict[int, int] = {}
        for rec in self._records.values():
            for page in rec.pages:
                pins[page] = pins.get(page, 0) + 1
        return pins

    # -- mutation -----------------------------------------------------------
    def publish(self, tokens: Sequence[int], gates: np.ndarray,
                chain: Sequence[int]) -> int:
        """Register every block boundary of a completed prefill.

        ``gates``: [nA, T] the prompt's execution gates; ``chain``: the
        owning slot's page chain right after its prefill was packed (the
        entry stream is token-major, so ``chain[:pages_for(E_s)]`` holds
        exactly the first ``Ts`` tokens' entries plus at most one partial
        boundary page).  Returns the number of new records."""
        toks = tuple(int(t) for t in tokens)
        gates = np.asarray(gates)
        added = 0
        for ts in range(self.block, len(toks) + 1, self.block):
            key = _digest(toks[:ts])
            rec = self._records.get(key)
            if rec is not None and rec.tokens == toks[:ts]:
                self._clock += 1
                rec.stamp = self._clock       # refresh, already pinned
                continue
            entries = prefill_entry_count(gates, ts, self.reuse)
            pages = tuple(chain[:self.alloc.pages_for(entries)])
            self.alloc.ref_pages(pages)
            self._clock += 1
            self._records[key] = PrefixRecord(
                key=key, tokens=toks[:ts], entries=entries, pages=pages,
                gates=gates[:, :ts].copy(), stamp=self._clock)
            added += 1
        while len(self._records) > self.max_records:
            if self.evict_one() is None:
                break
        return added

    def evict_one(self) -> Optional[int]:
        """Drop the least-recently-used unpinned record; returns the number
        of pages actually freed (None when nothing is evictable).  Longer
        records lose ties, so a nested shorter prefix (more broadly
        shareable) outlives its extensions."""
        victim = None
        for rec in self._records.values():
            if rec.in_use:
                continue
            if victim is None or (rec.stamp, -rec.length) < (
                    victim.stamp, -victim.length):
                victim = rec
        if victim is None:
            return None
        del self._records[victim.key]
        return self.alloc.deref_pages(victim.pages)

    def clear(self) -> int:
        """Drop every record (a store that did not survive its run leaves
        them aliasing blank pages).  Returns the number of pages freed."""
        freed = 0
        for rec in list(self._records.values()):
            assert rec.in_use == 0, "clearing a pinned prefix record"
            del self._records[rec.key]
            freed += self.alloc.deref_pages(rec.pages)
        return freed
