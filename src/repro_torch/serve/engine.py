"""Serving engines: prefill, then autoregressive decode with dynamic
routing and cross-layer KV reuse, with the KV-storage saving *measured*
from the per-step execution-gate log.

Counterpart of the JAX package's ``serve/engine.py``:

``ServeEngine``
    Lock-step batch: one fixed batch, every sequence at the same position.

``ContinuousBatchingEngine``
    Slot-based continuous batching with monolithic prefill
    (length-bucketed where ``can_bucket``, else at the exact prompt
    length) or chunked prefill (``prefill_chunk`` C > 0: C tokens per
    iteration through a staging cache, interleaved with the residents'
    decode steps, an optional ``step_tokens`` budget deferring a chunk),
    over either KV mode: the dense slot pool (``max_slots ×
    max_len`` rows per layer, allocated once; a Mamba stack's conv
    histories and SSM state per slot) or the paged §4.4 entry stream
    (``kvcache/paged.py``) with alloc-on-demand pages, proactive headroom
    and preemption of the youngest resident, and optionally the prefix
    cache (``kvcache/prefix.py``: published prompt prefixes shared as
    refcounted pages, a warm admission prefilling only its cold suffix).
    Decode runs one step per
    dispatch or, with ``decode_steps > 1``, device-resident N-step epochs
    (``models.model.DecodeEpoch``: on CUDA a captured graph of one
    iteration, replayed), or, with ``spec_k`` > 0, self-speculative
    draft + verify windows (a draft epoch under skip-biased router
    parameters, one verify chunk of the full model, host acceptance, and
    in the paged store the verified commit and its rollback).  Each run
    fills a ``MetricsRegistry`` (``obs/metrics.py``) and, when asked, a span
    trace (``obs/trace.py``); its run loops are generators that yield once
    per engine iteration, so ``RequestHandle.tokens()`` streams a request's
    tokens while it runs, and a pass at each iteration's top retires
    cancelled and expired requests, publishes a crash-consistent snapshot
    when one is due (``serve/snapshot.py``; ``resume()`` continues a dead
    run from it) and fires an injected host kill.  A ``FaultPlan``
    (``serve/faults.py``) injects dispatch errors, stalls and page OOM at
    the loops' seams, and a ``Watchdog`` observes every sync.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LOCAL, ModelConfig
from repro_torch.core import kv_reuse, routing
from repro_torch.kvcache import history as history_mod
from repro_torch.kvcache import paged as paged_mod
from repro_torch.kvcache import prefix as prefix_mod
from repro_torch.models import layers, transformer
from repro_torch.models import model as model_mod
from repro_torch.models.model import DecodeEpoch, LanguageModel
from repro_torch.obs import (MetricsRegistry, as_tracer, graphs_captured,
                             request_tid)
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.errors import (AdmissionRejected, ConfigError,
                                      HungDispatch, PageExhausted,
                                      SimulatedKill)
from repro_torch.serve import sampling as sampling_mod
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.faults import (FaultInjected, as_fault_plan,
                                      sleep_stall)
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import (ActiveRequest, PrefillChunk,
                                         Request, Scheduler, can_bucket,
                                         can_chunk_prefill, can_speculate,
                                         default_buckets)


@dataclasses.dataclass
class ServeStats:
    """Engine statistics for one ``generate()`` or ``run()`` (names as in
    the reference).  Times are host wall seconds around work that ends in a
    device synchronize.  On the continuous engine this is a *derived view*:
    every counter field is read out of the run's ``MetricsRegistry`` at
    ``_finalize`` (``run()["metrics"]``, which also holds the histograms,
    per-layer and per-step series the flat fields cannot), except the
    port's own ``prefill_aborts``, ``prefill_deferrals``,
    ``decode_iterations`` and ``graph_replays``.

      prefill_tokens    — prompt tokens prefilled (padding excluded).
      decode_tokens     — tokens emitted (the first, from prefill, included).
      prefill_s / decode_s — wall time of prefill work / decode steps.
                          A chunk that is not its prompt's last is only
                          enqueued: ``prefill_s`` holds its host time, and
                          the device work it queued is waited for at the
                          next decode sync, in ``decode_s`` (and
                          ``device_s``).
      prefill_chunks    — prefill work units run: one per chunk with
                          ``prefill_chunk > 0``, one per prompt otherwise
                          (a prompt prefilled again after a preemption or
                          an aborted chunked prefill counts again).
      interleaved_steps — iterations in which a prefill work unit ran
                          while requests were resident.
      prefill_aborts    — in-flight chunked prefills aborted under page
                          pressure (the port's; each is also a preemption).
      prefill_deferrals — plans that deferred the in-flight prompt's next
                          work unit under ``step_tokens`` (the port's).
      attn_keep_frac    — mean decode-time keep rate over routed submodules.
      kv_saved_fraction — measured compact-KV storage saving over the gate
                          log; ``kv_saved_analytic`` is the configured-
                          keep-rate estimate.
      requests_completed / decode_dispatches — finished requests / decode
                          dispatches (continuous engine): one per step in
                          single-step mode, one per N-step epoch with
                          ``decode_steps > 1``.
      decode_iterations — decode iterations the device ran (the port's;
                          equal to ``decode_dispatches`` in single-step
                          mode, the sum of the epoch lengths in fused
                          mode).
      device_s / host_s — wall time the host spent blocked on device
                          results (the per-step or per-epoch sync and the
                          prefills' token reads) / the rest of the run
                          loop's wall time.  In fused mode a paged
                          prefill's read waits for the epoch in flight
                          (in ``device_s`` and ``prefill_s``); a dense
                          prefill is only enqueued (``prefill_s`` is host
                          time).
      compiles          — CUDA graphs captured during the run (fused mode
                          on CUDA: one for the dense pool, one per
                          block-table width for the paged store);
                          ``graph_replays`` — their replays.
      epoch_shrinks     — paged fused epochs halved under page pressure.
      requests_cancelled / deadline_exceeded / preempt_budget_exhausted —
                          requests finished "cancelled", "deadline" and
                          "preempt_budget"; ``requests_shed`` — submissions
                          refused by load shedding since the last run.
      faults_injected   — ``FaultPlan`` faults that fired (a kill included);
                          ``dispatch_retries`` — iterations abandoned at an
                          injected dispatch error and planned again;
                          ``watchdog_strikes`` — syncs the watchdog judged
                          stragglers (soft).
      snapshots / resumes — boundary snapshots published / runs continued
                          from one (a resumed run counts from its boundary:
                          the dead run's counters are not restored).

    Paged mode (``kv_mode == "paged"``): page pool geometry, the live
    footprint's peak ``pages_peak``, ``preemptions``, the entry-stream write
    counters (``kv_entries_stored`` vs the per-layer-dense baseline
    ``kv_entries_dense``; a warm admission writes only its suffix) and the
    history-buffer hit rates measured from the gate log.  With the prefix
    cache: ``prefix_hits`` (warm admissions whose first suffix work unit
    ran), ``prefix_misses`` (cold admissions), ``prefix_tokens_saved``
    (prompt tokens they did not prefill) and ``prefix_records`` (records
    resident at the run's end).

    Speculative decoding (``spec_k`` > 0): ``spec_windows`` (draft +
    verify windows), ``spec_tokens_drafted`` (γ per active slot and
    window), ``spec_tokens_accepted``, ``spec_acceptance_rate`` (accepted
    / drafted), ``spec_entries_rolled_back`` (paged: tentative draft
    entries above the committed fill).  A window counts two decode
    dispatches (one with γ = 0) and γ + 1 decode iterations; ``compiles``
    and ``graph_replays`` are the draft epoch's."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_chunks: int = 0
    interleaved_steps: int = 0
    prefill_aborts: int = 0
    prefill_deferrals: int = 0
    attn_keep_frac: float = 1.0
    kv_saved_fraction: float = 0.0
    kv_saved_analytic: float = 0.0
    requests_completed: int = 0
    decode_dispatches: int = 0
    decode_iterations: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    compiles: int = 0
    graph_replays: int = 0
    epoch_shrinks: int = 0
    # -- paged-KV engine mode (kv_mode == "paged") -------------------------
    kv_mode: str = "dense"
    page_size: int = 0
    pages_total: int = 0
    pages_peak: int = 0                   # peak pages in use (live footprint)
    preemptions: int = 0                  # OOM-safe mid-decode evictions
    kv_entries_stored: int = 0            # live compact-store writes
    kv_entries_dense: int = 0             # per-layer-dense baseline writes
    history_hit_rate: float = 0.0         # reads served by the history buf
    history_hits_per_layer: List[float] = dataclasses.field(
        default_factory=list)
    # -- prefix cache (kv.prefix_cache) ------------------------------------
    prefix_hits: int = 0                  # warm-prefix admissions
    prefix_misses: int = 0                # cold admissions with cache on
    prefix_tokens_saved: int = 0          # prompt tokens skipped at prefill
    prefix_records: int = 0               # records resident at run end
    # -- speculative decoding (spec_k > 0) ---------------------------------
    spec_windows: int = 0                 # draft+verify windows dispatched
    spec_tokens_drafted: int = 0          # draft proposals fed to verify
    spec_tokens_accepted: int = 0         # proposals the verifier kept
    spec_entries_rolled_back: int = 0     # tentative paged entries discarded
    spec_acceptance_rate: float = 0.0     # accepted / drafted (0 when off)
    # -- request lifecycle -------------------------------------------------
    requests_cancelled: int = 0           # finish_reason == "cancelled"
    deadline_exceeded: int = 0            # finish_reason == "deadline"
    requests_shed: int = 0                # submit()-time load shedding
    preempt_budget_exhausted: int = 0     # finish_reason == "preempt_budget"
    # -- robustness: faults, the watchdog, snapshots -------------------------
    faults_injected: int = 0              # FaultPlan faults that fired
    dispatch_retries: int = 0             # iterations abandoned + replanned
    watchdog_strikes: int = 0             # straggler strikes (soft)
    snapshots: int = 0                    # boundary snapshots written
    resumes: int = 0                      # runs continued from a snapshot

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def kv_entries_saved_fraction(self) -> float:
        """Live storage saving of the paged history buffer."""
        if not self.kv_entries_dense:
            return 0.0
        return 1.0 - self.kv_entries_stored / self.kv_entries_dense


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome.

      tokens        — generated token ids, stop token (if hit) included.
      ttft_s        — wall seconds from ``run()`` start to the first token.
      decode_s      — wall seconds inside decode steps this request took
                      part in.
      finish_reason — "length" (budget), "stop" (stop token), "max_len";
                      or a lifecycle outcome with the tokens so far:
                      "deadline" (``deadline_s`` elapsed), "cancelled"
                      (``cancel``), "preempt_budget" (preempted more than
                      ``max_preemptions`` times).  A request retired
                      before it held a slot has no tokens.
      kv_stored / kv_dense — measured compact-store entries vs the
                      per-layer-dense baseline over the whole request.
      max_decode_stall_s — longest gap between two consecutive emissions."""
    uid: int
    tokens: np.ndarray
    prompt_len: int
    ttft_s: float
    decode_s: float
    finish_reason: str
    kv_stored: int = 0
    kv_dense: int = 0
    max_decode_stall_s: float = 0.0

    @property
    def decode_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def decode_tok_per_s(self) -> float:
        n = self.decode_tokens - 1       # first token is prefill's
        return n / self.decode_s if self.decode_s > 0 and n > 0 else 0.0

    @property
    def kv_saved_fraction(self) -> float:
        if self.kv_dense == 0:
            return 0.0
        return 1.0 - self.kv_stored / self.kv_dense


def analytic_kv_saved(cfg: ModelConfig) -> float:
    """Compact-store saving at the configured keep rate: layer 0 dense +
    keep_prob elsewhere."""
    L = max(len(cfg.attention_layers), 1)
    if not (cfg.skip.enabled and cfg.skip.kv_reuse):
        return 0.0
    return 1.0 - (1.0 + (L - 1) * cfg.skip.keep_prob) / L


def _measured_saved_fraction(gates_per_step: List[np.ndarray],
                             cfg: ModelConfig) -> float:
    """Lock-step gate log [L, B] per step -> measured storage saving."""
    if not gates_per_step or not (cfg.skip.enabled and cfg.skip.kv_reuse):
        return 0.0
    g = torch.from_numpy(np.stack(gates_per_step, axis=-1))  # [L, B, steps]
    return float(kv_reuse.storage_saved_fraction(g))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Lock-step batched engine (one shared decode position).

    ``model`` is a ``LanguageModel`` (its device is the engine's).  Sampling
    at ``temperature > 0`` draws from the ``torch.Generator`` given to
    ``generate``, by default one on that device seeded with 0."""

    def __init__(self, model: LanguageModel, max_len: int = 512,
                 temperature: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.temperature = temperature

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, object]:
        """prompts: [B, T0] int.  Returns {"tokens": [B, max_new_tokens]
        int32, "stats": ServeStats}."""
        cfg, dev = self.cfg, self.model.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        B, T0 = prompts.shape
        stats = ServeStats()
        toks = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)

        _sync(dev)
        t0 = perf_counter()
        logits, cache, _ = self.model.prefill(toks, pad_to=self.max_len)
        _sync(dev)
        stats.prefill_s = perf_counter() - t0
        stats.prefill_tokens = B * T0

        out = np.zeros((B, max_new_tokens), np.int32)
        keep_acc, keep_n = 0.0, 0
        gates_per_step: List[np.ndarray] = []
        emitted = 0
        tok = sample(logits, generator, self.temperature)
        t0 = perf_counter()
        for i in range(max_new_tokens):
            out[:, i] = tok.cpu().numpy()
            emitted += B
            pos = T0 + i
            if pos >= self.max_len:
                break
            logits, cache, dstats = self.model.decode_step(
                cache, tok[:, None], pos)
            if "attn_gate" in dstats:
                gates_per_step.append(
                    dstats["attn_gate"].float().cpu().numpy())
            keep_acc += float(dstats["keep_frac_sum"])
            keep_n += max(float(dstats["n_routed"]), 1.0)
            tok = sample(logits, generator, self.temperature)
        _sync(dev)
        stats.decode_s = perf_counter() - t0
        stats.decode_tokens = emitted

        stats.attn_keep_frac = keep_acc / max(keep_n, 1.0)
        stats.kv_saved_fraction = _measured_saved_fraction(gates_per_step, cfg)
        stats.kv_saved_analytic = analytic_kv_saved(cfg)
        return {"tokens": out, "stats": stats}


# ---------------------------------------------------------------------------
# Slot-pool plumbing
# ---------------------------------------------------------------------------

def init_pool(cfg: ModelConfig, max_slots: int, max_len: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """The continuous engine's dense pool, allocated once: per layer {"k",
    "v"} [max_slots, extent, Hkv, dh] zeros, the extent max_len for a
    global layer and min(W, max_len) for a LOCAL one (its ring, as the
    reference's ``init_decode_cache`` sizes it), or for a Mamba stack
    {"conv_x" [S, W-1, di], "conv_bc" [S, W-1, 2GN], "ssm" [S, H, P, N]
    fp32}."""
    dt = layers.torch_dtype(cfg)
    if transformer.is_ssm_stack(cfg):
        W, gn = cfg.ssm_conv - 1, cfg.ssm_groups * cfg.ssm_state
        return [{"conv_x": torch.zeros((max_slots, W, cfg.d_inner_ssm),
                                       dtype=dt, device=device),
                 "conv_bc": torch.zeros((max_slots, W, 2 * gn), dtype=dt,
                                        device=device),
                 "ssm": torch.zeros((max_slots, cfg.ssm_nheads,
                                     cfg.ssm_headdim, cfg.ssm_state),
                                    dtype=torch.float32, device=device)}
                for _ in range(cfg.num_layers)]
    W = cfg.window_size
    out = []
    for i in range(cfg.num_layers):
        extent = (min(W, max_len) if cfg.block_kind(i) == LOCAL and W
                  else max_len)
        shape = (max_slots, extent, cfg.num_kv_heads, cfg.resolved_head_dim)
        out.append({"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)})
    return out


def pool_insert(pool: List[Dict], cache: List[Dict], slot: int
                ) -> List[Dict]:
    """Overwrite row ``slot`` of every pool leaf, in place, with a
    single-request prefill cache (batch 1; KV padded to max_len).  Every
    leaf is written whole: an SSM state, which no position masks, must
    not keep anything of the slot's previous request.  A LOCAL layer's
    row is cut to its ring's extent, as the reference's ``_align_kv_row``
    does: a prompt ≤ W was collected linearly, and below W slot s holds
    position s, so the prefix is the ring; a longer prompt's cache is
    already the ring."""
    for pe, ce in zip(pool, cache):
        for name, leaf in pe.items():
            row = ce[name][0]
            if name in ("k", "v") and row.shape[0] != leaf.shape[1]:
                row = row[:leaf.shape[1]]
            leaf[slot].copy_(row)
    return pool


def _fetch(*tensors):
    """Read device tensors back in one transfer (each as float32: token ids
    and counts are exact in it, logits too); None stays None.  Returns
    one numpy array per argument, in its shape."""
    live = [t for t in tensors if t is not None]
    if not live:
        return [None] * len(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in live]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


def _unported(config: EngineConfig, cfg: ModelConfig) -> List[str]:
    """Levers of the reference engine this port does not serve yet, each
    with the ROADMAP queue 1 item that will port it."""
    obs = config.obs
    out = []
    if obs.mesh is not None or obs.sharding_policy is not None:
        out.append("mesh / sharding_policy (item 14)")
    return out


@dataclasses.dataclass
class _RunState:
    """Host-side state of one ``run()``.  ``metrics`` is the run's
    source-of-truth registry: ``stats``' counter fields are derived from
    it at ``_finalize``."""
    stats: ServeStats
    results: Dict[int, RequestResult]
    t_run: float
    generator: torch.Generator
    metrics: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    keep_acc: float = 0.0
    keep_n: float = 0.0
    # -- observability bookkeeping -----------------------------------------
    step_idx: int = 0                     # cumulative decode iterations
    disp_idx: int = 0                     # engine iterations that decoded
    compiled_seen: int = 0                # CUDA graphs captured so far
    epochs: List[DecodeEpoch] = dataclasses.field(default_factory=list)
    traced: set = dataclasses.field(default_factory=set)     # request spans
    admitted: set = dataclasses.field(default_factory=set)   # prefill spans
    hist: Optional[history_mod.HistoryAccounting] = None
    # fused mode: first tokens sampled by a dense prefill that the host has
    # not read yet ({slot: device [1] tensor}); the next epoch feeds them
    # from the device
    pending: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # paged fused mode: the epoch length that fit after a page-pressure
    # shrink (0 = uncapped) and the clean-epoch streak that grows it back
    epoch_cap: int = 0
    clean_epochs: int = 0
    # chunked prefill: the in-flight prompt's staging cache (per layer
    # {"k", "v"} [1, cap, Hkv, dh]) and its chunks' gate logs [L, 1, C]
    stage_cache: Optional[List[Dict[str, torch.Tensor]]] = None
    stage_gates: List[torch.Tensor] = dataclasses.field(
        default_factory=list)
    # crash consistency: the boundary the last snapshot was published at,
    # and whether a decode step, epoch or window was dispatched and not yet
    # synced (never so at a boundary)
    last_snap: int = -1
    unsynced: bool = False


@dataclasses.dataclass
class _WarmAdmission:
    """Host state of one warm-prefix admission between the scheduler's
    probe (allocator work done, device work deferred) and the slot's first
    suffix work unit (COW copy + staging-cache restore)."""
    rec: prefix_mod.PrefixRecord
    # the boundary page's copy on write: (shared source page, private
    # destination page, entries kept); None when the prefix's entries end
    # on a page boundary
    copy: Optional[tuple] = None


class RequestHandle(int):
    """What ``submit()`` returns: the request uid (an ``int``, so callers
    that compare or store uids keep working) plus the streaming surface.

    ``tokens()`` yields ``(token, step)`` pairs as the engine emits them,
    *driving the engine itself* when the buffer runs dry — iterating a
    handle interleaves engine iterations with consumption, no thread
    needed.  Emission granularity is the engine iteration (an epoch in
    fused mode, a window in speculative mode)."""

    def __new__(cls, uid: int, engine):
        h = super().__new__(cls, uid)
        h.engine = engine
        return h

    @property
    def uid(self) -> int:
        return int(self)

    def done(self) -> bool:
        """True once the request has a final :class:`RequestResult`."""
        return int(self) in self.engine._stream_done

    def result(self) -> Optional[RequestResult]:
        """The final result, or None while the request is still running
        (``tokens()`` / ``run()`` drive it to completion)."""
        return self.engine._stream_results.get(int(self))

    def tokens(self):
        """Iterate ``(token, step)`` pairs for this request, pumping the
        engine's run loop whenever no buffered token is ready."""
        return self.engine._stream_tokens(int(self))


class ContinuousBatchingEngine:
    """Continuous batching over a fixed slot pool (per-sequence positions).

    Requests are admitted into free slots, prefilled monolithically
    (right-padded to a length bucket where that is exact, logits taken at
    the real last token) or, with ``prefill_chunk`` C > 0, C tokens per
    iteration (``model.prefill_chunk`` into a staging cache that the last
    chunk inserts into the pool or packs into pages; only where
    ``can_chunk_prefill``, else ``ConfigError``), decoded concurrently — each sequence at its own
    position — one ragged decode step per iteration (or, with
    ``decode_steps`` N > 1, one device-resident epoch of up to N steps),
    and evicted on stop token, length or ``max_len``.
    ``kv_mode="paged"`` keeps the KV in the
    §4.4 entry stream: before each step every resident is guaranteed one
    step of page headroom (the youngest resident is preempted and requeued
    when the free list runs dry), admission is gated on genuinely spare
    pages, and each step's fresh entries and history-buffer hits are
    accounted from its gate log.
    One host sync per step (per epoch) reads the tokens and the attention
    gate log.

    ``decode_steps`` (default ``cfg.decode_steps_per_dispatch``; must be
    >= 1) > 1 runs the fused epoch (``models.model.DecodeEpoch``): the
    host syncs once per epoch.  Admission, prefills and pool inserts are
    enqueued on the same stream behind the epoch, their inputs copied
    from pinned memory without a sync.  In the dense pool a prefill's
    first token stays on the device and the next epoch feeds it (a first
    token equal to the stop token kills the slot at the epoch's entry),
    so the host prepares it while the epoch runs; a paged prefill reads
    its first token and gate log back, so it waits for the epoch.  In the paged store every resident's worst case
    for the whole epoch is reserved before dispatch; when the free list
    cannot cover it the epoch halves before anyone is preempted, and the
    length that fit caps later epochs until two clean epochs in a row
    double it back.  At temperature 0 the tokens equal the single-step
    engine's.

    ``step_tokens`` caps an iteration's tokens (each decode slot costs
    the epoch length, a chunk its length): an over-budget chunk waits one
    iteration, never two.  A paged chunked (or budgeted) prompt reserves
    its worst case at admission; under page pressure an in-flight chunked
    prefill is aborted and requeued before any resident is preempted.

    ``prefix_cache`` (paged only, and only where ``can_chunk_prefill``,
    else ``ConfigError``): every completed paged prefill publishes its
    prompt at each ``prefix_block``-token boundary (``PrefixCache``,
    pinning the pages that hold those entries).  Admission probes the
    cache: the longest published prefix (at most the prompt's length − 1)
    is aliased into the new slot's chain by reference, its partial
    boundary page queued for a copy on write, and only the cold suffix is
    prefilled: at its first work unit the boundary page is copied
    (``paged.copy_page_masked``) and the staging cache restored from the
    shared entries (``views_from_pages`` + ``chunk_cache_from_views``);
    the suffix then runs through ``model.prefill_chunk`` (chunk C, or one
    power-of-two-padded forward with chunking off) and only its entries
    are packed.  Under page pressure least-recently-used records are
    evicted before an admission is refused or anyone is preempted.  The
    paged store outlives a ``run()``: each paged loop takes the store the
    last run stashed at its clean exit (records alias its pages); a run
    that raised stashes nothing, so the next run starts from a zeroed
    store, requeues what the dead run left in flight and clears the prefix
    cache.

    ``spec_k`` K > 0 (only where ``can_speculate``, and not with
    ``decode_steps`` > 1, else ``ValueError``) decodes in self-speculative
    windows: γ ≤ K draft iterations (``_window_gamma`` clamps γ so the
    window's writes stay below ``max_len``) under ``draft_params``, the
    params with router skip biases raised by ``draft_keep``
    (``core.routing.draft_router_bias``; a ``DecodeEpoch`` in draft mode,
    on CUDA a captured graph), then one verify chunk of the full model
    over the fed token and the drafts, host acceptance, and emission of
    the accepted prefix plus a correction per slot (``_run_dense_spec``,
    ``_run_paged_spec``; the paged store commits only the emitted
    columns' verifier KV and trims the rest).  At temperature 0 the tokens
    are the plain engine's.

    ``model`` is a ``LanguageModel``; its device is the engine's.  An
    attention-free Mamba stack serves from the dense pool only (paged mode
    raises ``ValueError``, as do ``prefill_buckets``: it prefills at the
    exact prompt length, and admission overwrites the slot's conv
    histories and state whole; ``prefill_chunk`` > 0 raises
    ``ConfigError``).  Pass an
    ``EngineConfig`` or its flat kwargs (``max_slots``, ``max_len``,
    ``kv_mode``, ``page_size``, ``num_pages``, ``kv_dtype``,
    ``temperature``, ``prefill_buckets``, ``prefill_chunk``,
    ``decode_steps``, ``step_tokens``, ``prefix_cache``,
    ``prefix_block``, ``spec_k``, ``draft_keep``, ``trace``,
    ``max_queue_depth``, ``max_queue_delay_s``, ``max_preemptions``,
    ``faults``, ``watchdog``, ``snapshot_dir``, ``snapshot_every``).  The
    reference's other lever, a mesh (``mesh`` / ``sharding_policy``),
    raises ``ConfigError`` naming the ROADMAP item that will port it.
    Sampling at ``temperature > 0`` draws from the ``torch.Generator``
    given to ``run``.

    Observability: every run fills a ``MetricsRegistry``
    (``run()["metrics"]``, ``self.metrics``; ``ServeStats`` is derived
    from it) and, with ``trace`` (a ``repro_torch.obs.Tracer``, or a path
    the trace is saved to at the end of every run; None, the default, is a
    no-op ``NullTracer``), a Chrome trace of host-time spans: a ``step``
    per engine iteration split into ``plan`` / ``headroom`` / ``prefill``
    / ``dispatch`` / ``sync`` / ``bookkeep`` (``draft`` / ``verify`` /
    ``rollback`` in speculation), and a track per request.  On CUDA a
    ``dispatch`` span is the host's enqueue and a ``sync`` span the wait
    for the device; ``tools/trace_summary.py`` reads the file.

    The run loops are generators yielding once per engine iteration;
    ``run()`` and ``RequestHandle.tokens()`` pump the same driver.  At the
    top of every iteration the lifecycle sweep retires requests that were
    cancelled (``cancel``) or whose ``deadline_s`` elapsed, with their
    partial tokens, releasing slots and pages.  ``max_queue_depth`` /
    ``max_queue_delay_s`` shed submissions (``AdmissionRejected`` with
    its ``reason``); ``max_preemptions`` retires a request preempted more
    often than that ("preempt_budget") instead of requeueing it.

    Robustness (``serve/faults.py``, ``serve/snapshot.py``): ``faults`` (a
    ``FaultPlan`` or a list of ``Fault``) fires scheduled faults at the
    loops' seams, by engine iteration — "dispatch_error" before anything
    of the iteration's decode is enqueued (the loop abandons the iteration
    and plans it again), "stall" inside the sync, "oom" (paged) hiding
    free pages from the headroom pass, "kill" at the boundary after its
    snapshot (``SimulatedKill``).  ``watchdog`` (a ``Watchdog``) observes
    each step's, epoch's or window's dispatch-to-sync time: a straggler
    is counted, a sync past its ``timeout_s`` raises ``HungDispatch``
    carrying the flushed trace's path.  ``snapshot_dir`` publishes a
    crash-consistent snapshot every ``snapshot_every`` iterations at a
    quiescent boundary (no prefill in flight, no deferred first token, no
    staging cache, nothing dispatched and not synced); a fresh engine of
    the same geometry ``resume()``s from it and, at temperature 0, its
    tokens are the uninterrupted run's (at temperature > 0 too: the
    generator's state is restored).  These levers are read at run time,
    so a test may set them on a built engine."""

    def __init__(self, model: LanguageModel,
                 config: Optional[EngineConfig] = None, **kwargs):
        if kwargs:
            if config is not None:
                raise ConfigError(
                    "pass either config=EngineConfig(...) or flat kwargs, "
                    f"not both (got {sorted(kwargs)})")
            config = EngineConfig.from_kwargs(**kwargs)
        elif config is None:
            config = EngineConfig()
        cfg = model.cfg
        missing = _unported(config, cfg)
        if missing:
            raise ConfigError("not ported to repro_torch yet (ROADMAP queue "
                              "1): " + "; ".join(missing))
        self.config = config
        self.model = model
        self.cfg = cfg
        self.device = model.device
        kvc, sch = config.kv, config.scheduling
        self.max_slots, self.max_len = sch.max_slots, sch.max_len
        self.temperature = config.temperature
        self.decode_steps = int(cfg.decode_steps_per_dispatch
                                if sch.decode_steps is None
                                else sch.decode_steps)
        if self.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1 (1 = single-step)")
        self.spec_k = int(config.spec.spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = off)")
        dk = config.spec.draft_keep
        self.draft_keep = 1.0 if dk is None else float(dk)
        # test hook: callable (uid, drafts [γ]) -> [γ] replacing a slot's
        # draft proposals before verification (it syncs the drafts: a test
        # lever for forcing accept/reject patterns, not a serving one)
        self.draft_override = None
        self.draft_params = None
        if self.spec_k:
            if not can_speculate(cfg):
                raise ValueError(
                    f"{cfg.name}: speculative decoding reuses the chunked-"
                    "prefill stack pass for verification — it requires an "
                    "all-global-attention stack with masked-mode routing "
                    "and the bthd cache layout (spec_k=0)")
            if self.decode_steps > 1:
                raise ValueError(
                    "spec_k and decode_steps > 1 are mutually exclusive — "
                    "both amortize host overhead over multi-token "
                    "dispatches; pick one")
            if not 0.0 < self.draft_keep <= 1.0:
                raise ValueError("draft_keep must be in (0, 1]")
            # built once: the draft graphs hold its tensors' addresses
            self.draft_params = routing.draft_router_bias(model.params(),
                                                          self.draft_keep)
        self.kv_mode = kvc.kv_mode
        if self.kv_mode == "paged" and not paged_mod.can_page(cfg):
            raise ValueError(
                f"{cfg.name}: paged KV requires an all-global-attention "
                "stack with masked-mode routing — use kv_mode='dense'")
        self.prefill_chunk = int(cfg.prefill_chunk
                                 if sch.prefill_chunk is None
                                 else sch.prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = monolithic)")
        if self.prefill_chunk and not can_chunk_prefill(cfg):
            raise ConfigError(
                f"{cfg.name}: chunked prefill requires an all-global-"
                "attention stack with masked-mode routing (resumable "
                "cache state) — use prefill_chunk=0")
        # the staging cache: max_len rounded up to a chunk multiple, so a
        # right-padded final chunk always fits
        C = self.prefill_chunk
        self._chunk_cap = -(-self.max_len // C) * C if C else 0
        self.step_tokens = sch.step_tokens
        buckets = sch.prefill_buckets
        if buckets is not None and not can_bucket(cfg):
            raise ValueError(
                f"{cfg.name}: prefill bucketing pads prompts, which corrupts "
                "ring-buffer/SSM state and gather-mode capacity — this "
                "config requires exact-length prefill (prefill_buckets=None)")
        if buckets is None and can_bucket(cfg) and not self.prefill_chunk:
            # chunks set their own shapes; buckets serve monolithic prefill
            buckets = default_buckets(self.max_len)
        self.scheduler = Scheduler(self.max_slots, self.max_len,
                                   buckets=buckets,
                                   prefill_chunk=self.prefill_chunk)
        self.kv_dtype = kvc.kv_dtype
        self.prefix: Optional[prefix_mod.PrefixCache] = None
        # the paged store a run stashed at its clean exit, for the next
        self._store: Optional[Dict[str, torch.Tensor]] = None
        if self.kv_mode == "paged":
            self.n_attn = paged_mod.num_attention_layers(cfg)
            self.page_size = kvc.page_size
            # default pool: the dense pool's worst case (every token fresh
            # at every layer); alloc-on-demand keeps the live footprint far
            # below it — size it down to see backpressure
            cap = self.max_len * self.n_attn
            self.num_pages = (kvc.num_pages if kvc.num_pages is not None
                              else self.max_slots * -(-cap // self.page_size))
            self.allocator = paged_mod.PageAllocator(
                self.num_pages, self.page_size, self.max_slots,
                slot_entry_capacity=cap)
            if kvc.prefix_cache:
                if not can_chunk_prefill(cfg):
                    raise ConfigError(
                        f"{cfg.name}: prefix_cache resumes prefill from a "
                        "reconstructed staging cache — it requires the "
                        "chunk-resumable stack chunked prefill needs")
                self.prefix = prefix_mod.PrefixCache(
                    self.allocator, block=kvc.prefix_block,
                    reuse=paged_mod.reuse_enabled(cfg),
                    max_records=kvc.prefix_max_records)
                self.scheduler.prefix_probe = self._prefix_probe
                # in-flight warm admissions: slot -> _WarmAdmission
                self._warm_pending: Dict[int, _WarmAdmission] = {}
                # a warm suffix resumes mid-sequence through the staging
                # cache even with chunking off; its rows cover the prompt
                self._warm_cap = self._chunk_cap if C else self.max_len
        self._uid = 0
        # -- observability -------------------------------------------------
        self.tracer = as_tracer(config.obs.trace)
        self.metrics: Optional[MetricsRegistry] = None  # last run's registry
        # -- streaming surface -----------------------------------------------
        self._streams: Dict[int, List] = {}      # uid -> [(token, step), ..]
        self._stream_pos: Dict[int, int] = {}    # uid -> emitted high-water
        self._stream_done: set = set()           # uids with a final result
        self._stream_results: Dict[int, RequestResult] = {}
        self._driver = None                      # active run-loop generator
        self._driver_gen: Optional[torch.Generator] = None
        self._driver_out: Optional[Dict] = None
        # -- request lifecycle -----------------------------------------------
        rob = config.robustness
        self.max_queue_depth = rob.max_queue_depth
        self.max_queue_delay_s = rob.max_queue_delay_s
        self.max_preemptions = rob.max_preemptions
        self._cancelled: set = set()     # uids awaiting cooperative cancel
        self._shed_pending: List[str] = []   # shed reasons since last run
        # -- robustness ------------------------------------------------------
        self.faults = as_fault_plan(rob.faults)
        self.watchdog = rob.watchdog
        self.snapshot_dir = rob.snapshot_dir
        self.snapshot_every = max(1, int(rob.snapshot_every))
        self._resume = None              # (device tree, host, step) to apply

    # -- submission and the request lifecycle ------------------------------
    def submit(self, tokens: np.ndarray, max_new_tokens: int,
               stop_token: Optional[int] = None,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Queue one prompt; returns its :class:`RequestHandle` (an ``int``
        subclass carrying the uid).  Iterating ``handle.tokens()`` streams
        ``(token, step)`` pairs and drives the run loop on demand; ``run()``
        drains everything.

        ``deadline_s`` is a wall-clock budget measured from submission:
        past it the request finishes with ``finish_reason == "deadline"``
        (partial tokens kept) and releases its slot and pages at the next
        iteration's lifecycle sweep.  Raises ``AdmissionRejected`` when the
        request can never be served (empty prompt, no decode headroom,
        paged worst-case KV over the pool) or when the engine is shedding
        load (``max_queue_depth`` / ``max_queue_delay_s``)."""
        uid = self._uid
        self._uid += 1
        req = Request(uid=uid, tokens=np.asarray(tokens, np.int32),
                      max_new_tokens=max_new_tokens, stop_token=stop_token,
                      deadline_s=deadline_s)
        tr = self.tracer
        tr.track(request_tid(uid), f"req {uid}")
        tr.instant("submit", request_tid(uid), prompt_len=req.prompt_len,
                   max_new=max_new_tokens)
        if self.kv_mode == "paged":
            # cover both the lifetime worst case and the admission gate's
            # requirement (prompt + one step of headroom): a request
            # _can_place can never pass would park the queue forever
            worst = max(self._worst_case_entries(req),
                        (req.prompt_len + 1) * self.n_attn)
            if self.allocator.pages_for(worst) > self.num_pages:
                raise AdmissionRejected(
                    f"request {uid}: worst-case KV ({worst} entries) "
                    f"exceeds the page pool ({self.num_pages} pages × "
                    f"{self.page_size}) — OOM-safe admission impossible",
                    reason="kv_worst_case", uid=uid)
        self._maybe_shed(req)
        self.scheduler.submit(req)
        return RequestHandle(uid, self)

    def _maybe_shed(self, req: Request) -> None:
        """Load shedding at submit: refuse to grow a queue that is at the
        depth bound or whose *head* has already waited past the delay bound
        (the head's age is the least a newcomer would wait)."""
        q = self.scheduler.queue
        reason = detail = None
        if (self.max_queue_depth is not None
                and len(q) >= self.max_queue_depth):
            reason = "queue_depth"
            detail = (f"queue depth {len(q)} at the shed bound "
                      f"{self.max_queue_depth}")
        elif self.max_queue_delay_s is not None and q:
            head_age = perf_counter() - q[0].submit_s
            if head_age > self.max_queue_delay_s:
                reason = "queue_delay"
                detail = (f"queue head has waited {head_age:.3f}s > "
                          f"bound {self.max_queue_delay_s:.3f}s")
        if reason is not None:
            self._shed_pending.append(reason)
            self.tracer.instant("shed", request_tid(req.uid), reason=reason)
            raise AdmissionRejected(
                f"request {req.uid} shed: {detail}", reason=reason,
                uid=req.uid)

    def cancel(self, uid: int) -> None:
        """Cooperative cancellation: mark ``uid`` for removal at the next
        iteration's lifecycle sweep — a queued request is dropped, an
        in-flight prefill aborted, a resident finishes with its partial
        tokens (``finish_reason == "cancelled"``), its slot and pages
        released.  Unknown or already-finished uids are a no-op."""
        self._cancelled.add(uid)
        self.tracer.instant("cancel", request_tid(uid))

    # -- crash-consistent snapshots (serve/snapshot.py) --------------------
    def resume(self, snapshot_dir: Optional[str] = None,
               step: Optional[int] = None) -> int:
        """Load the newest (or the given ``step``) boundary snapshot under
        ``snapshot_dir`` (default: the engine's own); the next ``run()``
        continues from it: scheduler queue and residents, allocator chains,
        finished results, the device KV state and the generator's state
        are restored (copied into the run's own pool or store before
        anything is built over it), so the surviving requests' tokens are
        those the dead process would have produced.  Returns the boundary
        restored.  Requests submitted to this engine before ``run()`` merge
        into the restored queue in age order.  A snapshot of another
        geometry raises ``ValueError`` ("fingerprint"), one whose tensors
        differ in shape or dtype ``ValueError`` too."""
        snap_dir = snapshot_dir or self.snapshot_dir
        if snap_dir is None:
            raise ValueError("resume() needs a snapshot_dir (argument or "
                             "constructor)")
        template = {"kv": self._init_kv_state("meta"),
                    "rng": torch.Generator(device=self.device)}
        tree, host, at = snapshot_mod.load_snapshot(
            snap_dir, template, step,
            check=functools.partial(snapshot_mod.check_fingerprint, self))
        self._resume = (tree, host, at)
        return at

    def _init_kv_state(self, device):
        """A fresh KV state of the engine's mode on ``device`` (``meta``:
        shapes and dtypes only, the restore template)."""
        if self.kv_mode == "paged":
            return paged_mod.init_store(self.cfg, self.num_pages,
                                        self.page_size,
                                        kv_dtype=self.kv_dtype,
                                        device=device)
        return init_pool(self.cfg, self.max_slots, self.max_len, device)

    # -- paged-mode memory policy ------------------------------------------
    def _worst_case_entries(self, req: Request) -> int:
        """Every stored token fresh at every attention layer (the last
        generated token is emitted but never fed)."""
        toks = min(self.max_len, req.prompt_len + req.max_new_tokens - 1)
        return toks * self.n_attn

    def _can_place(self, req: Request) -> bool:
        """Admission gate: free pages for the prompt's worst-case entries
        plus one decode step of headroom (the residents' next-step headroom
        is reserved before admission, so the free list is genuinely
        spare).  Prefix records hold pages too: least-recently-used ones
        are evicted (never pinned ones) before the pool counts as full."""
        need = req.prompt_len * self.n_attn + self.n_attn
        pages = self.allocator.pages_for(need)
        if pages > self.allocator.pages_per_slot:
            return False
        while pages > self.allocator.free_pages and self._reclaim_pages():
            pass
        return pages <= self.allocator.free_pages

    def _reclaim_pages(self) -> bool:
        """Page-pressure valve: drop one LRU prefix record.  True when a
        record went (its unshared pages back on the free list): callers
        loop until their reservation fits or this gives False, and only
        then preempt."""
        return (self.prefix is not None
                and self.prefix.evict_one() is not None)

    def _acquire_store(self) -> Dict[str, torch.Tensor]:
        """The page store of one paged run: the one the last run stashed at
        its clean exit (published records alias its pages; stale entries
        in pages handed out again are masked by the chain fill, as within
        a run).  The stash is taken at once, so a run that raises leaves
        none.  Without one (the first run, or the last raised) the store
        is fresh and zeroed, so what aliased the old one goes: the dead
        run's in-flight prefill and residents are released and requeued to
        prefill again, warm admissions unpinned, the prefix cache
        cleared."""
        store, self._store = self._store, None
        if store is not None:
            return store
        sched, alloc = self.scheduler, self.allocator
        if sched.prefilling is not None:
            alloc.release(sched.abort_prefill().slot)
        for slot in sorted(sched.active):
            sched.requeue(sched.release(slot).req)
            alloc.release(slot)
        if self.prefix is not None:
            for slot in list(self._warm_pending):
                self._abort_warm(slot)
            self.prefix.clear()
        return paged_mod.init_store(self.cfg, self.num_pages, self.page_size,
                                    kv_dtype=self.kv_dtype,
                                    device=self.device)

    # -- prefix sharing ------------------------------------------------------
    def _prefix_probe(self, req: Request, slot: int) -> int:
        """The scheduler's admission hook: find the longest published
        prefix of ``req``'s prompt and alias its full pages into ``slot``
        by reference; the partial boundary page's copy on write is
        deferred to the slot's first suffix work unit (nothing reads the
        slot's pages before it).  The cold suffix's worst-case pages are
        reserved here, inside the plan that passed ``_can_place``.
        Returns the prompt tokens covered (0 = cold admission)."""
        rec = self.prefix.lookup(req.tokens)
        if rec is None:
            if self.metrics is not None:
                self.metrics.inc("prefix_misses_total")
            return 0
        alloc, nA = self.allocator, self.n_attn
        n_full, rem = divmod(rec.entries, alloc.page_size)
        worst = rec.entries + (req.prompt_len - rec.length) * nA + nA
        alloc.alias_into(slot, rec.pages[:n_full])
        if not alloc.ensure(slot, worst):
            # not after _can_place's whole-prompt worst case (worst less
            # the aliased entries is below it); admit cold all the same
            alloc.release(slot)
            return 0
        alloc.seed_fill(slot, rec.entries)
        self.prefix.pin(rec)
        copy = None
        if rem:
            copy = (int(rec.pages[n_full]),
                    int(alloc.block_table[slot, n_full]), rem)
        self._warm_pending[slot] = _WarmAdmission(rec=rec, copy=copy)
        return rec.length

    def _abort_warm(self, slot: int) -> None:
        """Drop the warm-admission state of an aborted in-flight prefill
        (the caller's ``allocator.release`` already dropped the chain's
        references): the record is unpinned, evictable again."""
        if self.prefix is None:
            return
        warm = self._warm_pending.pop(slot, None)
        if warm is not None:
            self.prefix.unpin(warm.rec)

    # -- main loop and the streaming driver ---------------------------------
    @torch.no_grad()
    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, object]:
        """Drain the queue.  Returns {"results": {uid: RequestResult},
        "stats": ServeStats, "metrics": MetricsRegistry} (stats is a view
        derived from the registry; ``self.metrics`` is the last run's).

        The run loops are generators that yield once per engine iteration
        (the granularity ``RequestHandle.tokens`` observes); ``run()``
        pumps the shared driver to its end, so a partly consumed
        ``tokens()`` iteration resumes here — one driver serves both.  The
        generator's draws come from the one given to the run that starts
        the driver (by default one on the engine's device seeded with 0).
        With a tracer built from a path, the trace is saved there at the
        end of every run."""
        if self._driver is None:
            self._driver_gen = generator
        while self._pump():
            pass
        out, self._driver_out = self._driver_out, None
        return out

    def _make_driver(self, generator):
        """One generator wrapping the mode dispatch; ``yield`` marks engine
        iterations, ``return`` carries the run's dict."""
        paged = self.kv_mode == "paged"
        if self.spec_k:
            loop = self._run_paged_spec if paged else self._run_dense_spec
        elif self.decode_steps > 1:
            loop = self._run_paged_fused if paged else self._run_dense_fused
        else:
            loop = self._run_paged if paged else self._run_dense
        return (yield from loop(generator))

    def _pump(self) -> bool:
        """Advance the shared driver one engine iteration, under
        ``torch.no_grad()`` whatever the caller's grad mode (a generator's
        body runs under the mode of whoever calls ``next``).  Returns False
        when the run completed (its dict lands in ``self._driver_out``).
        An error tears the driver down before it re-raises, so the next
        ``run()`` starts fresh."""
        if self._driver is None:
            self._driver = self._make_driver(self._driver_gen)
        try:
            with torch.no_grad():
                next(self._driver)
            return True
        except StopIteration as e:
            self._driver = self._driver_gen = None
            self._driver_out = e.value
            return False
        except BaseException:
            self._driver = self._driver_gen = None
            raise

    def _end_step(self, rs: _RunState):
        """Close an engine iteration: captures polled, the step span
        closed, the streams fed, then the driver's yield.  Nothing is left
        in flight across it that the next iteration's lifecycle sweep could
        free under the device: every launch is on the one stream, so work
        enqueued later (a page handed out again) runs after it."""
        self._poll_compiles(rs)
        self.tracer.end()                 # step
        self._drain_stream(rs)
        yield

    # -- streaming emission ------------------------------------------------
    def _emit_stream(self, uid: int, out_tokens: List[int],
                     step: int) -> None:
        """Append tokens past the uid's high-water mark to its stream
        buffer.  The mark survives preemption (out_tokens resets, the mark
        does not), so every emitted index streams exactly once: at
        temperature 0 a preempted request derives the same prefix again;
        at temperature > 0 re-decoded tokens may differ from those already
        streamed."""
        w = self._stream_pos.get(uid, 0)
        if len(out_tokens) > w:
            buf = self._streams.setdefault(uid, [])
            buf.extend((int(t), step) for t in out_tokens[w:])
            self._stream_pos[uid] = len(out_tokens)

    def _drain_stream(self, rs: _RunState) -> None:
        """Per-iteration emission sweep over the residents.  A slot still
        holding a deferred first token (``rs.pending``) is skipped: its
        out_tokens[0] is a placeholder until the next epoch's sync resolves
        it, and the next sweep emits it."""
        for slot, st in self.scheduler.active.items():
            if slot not in rs.pending:
                self._emit_stream(st.req.uid, st.out_tokens, rs.step_idx)

    def _record_result(self, rs: _RunState, res: RequestResult) -> None:
        """Single choke point for finished requests: the run's dict and the
        streaming surface see the same RequestResult."""
        rs.results[res.uid] = res
        self._stream_results[res.uid] = res
        self._stream_done.add(res.uid)

    def _stream_tokens(self, uid: int):
        """Yield ``(token, step)`` for ``uid``, pumping the engine when the
        buffer runs dry.  Ends when the request has a final result (or the
        engine drains without ever placing it)."""
        buf = self._streams.setdefault(uid, [])
        sent = 0
        while True:
            while sent < len(buf):
                yield buf[sent]
                sent += 1
            if uid in self._stream_done:
                return
            if not self._pump() and sent >= len(buf) \
                    and uid not in self._stream_done:
                return

    # -- observability plumbing (shared by all six run loops) --------------
    def _new_run_state(self, generator: Optional[torch.Generator],
                       paged: bool) -> _RunState:
        """Fresh per-run state: the stats shell, the metrics registry (this
        run's source of truth), the load sheds since the last run, and the
        ``request ⊃ queued`` spans of everything already queued."""
        if paged:
            stats = ServeStats(kv_mode="paged", page_size=self.page_size,
                               pages_total=self.num_pages)
            hist = history_mod.HistoryAccounting(
                self.n_attn, self.max_slots,
                paged_mod.reuse_enabled(self.cfg))
        else:
            stats, hist = ServeStats(), None
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        rs = _RunState(stats=stats, results={}, t_run=perf_counter(),
                       generator=generator, hist=hist)
        self.metrics = rs.metrics
        # credit submit-time load sheds to this run's registry (each one
        # already emitted its "shed" trace instant at submit)
        for _ in self._shed_pending:
            rs.metrics.inc("requests_shed_total")
        self._shed_pending.clear()
        tr = self.tracer
        for req in self.scheduler.queue:
            rs.traced.add(req.uid)
            tid = request_tid(req.uid)
            tr.track(tid, f"req {req.uid}")
            tr.begin("request", tid)
            tr.begin("queued", tid)
        return rs

    def _step_gauges(self, rs: _RunState) -> None:
        """Per-iteration scheduler/memory gauges + the trace counter row."""
        sched, m = self.scheduler, rs.metrics
        m.set("queue_depth", len(sched.queue))
        m.set("resident_slots", len(sched.active))
        vals = {"queue": len(sched.queue), "resident": len(sched.active)}
        if self.kv_mode == "paged":
            free = self.allocator.free_pages
            m.set("free_pages", free)
            m.set("pages_in_use", self.num_pages - free)
            vals["free_pages"] = free
        self.tracer.counter("sched", vals)

    def _note_admission(self, rs: _RunState) -> None:
        """Call right after ``plan_step``: if the FIFO head was just popped
        into a slot, close its queued span, open its prefill-phase span and
        observe its queue wait."""
        pf = self.scheduler.prefilling
        if pf is None or pf.req.uid in rs.admitted:
            return
        rs.admitted.add(pf.req.uid)
        if pf.req.submit_s:
            rs.metrics.observe("queue_wait_seconds",
                               perf_counter() - pf.req.submit_s)
        tid = request_tid(pf.req.uid)
        tr = self.tracer
        tr.end(tid)                       # queued
        tr.instant("admit", tid, slot=pf.slot)
        tr.begin("prefill", tid)

    def _poll_compiles(self, rs: _RunState) -> None:
        """Surface CUDA graph captures (a run's first epoch, a new
        block-table width) as ``compiles_total`` + ``compile`` instants, so
        a capture is attributable to the iteration that made it."""
        n = graphs_captured(rs.epochs)
        if n > rs.compiled_seen:
            rs.metrics.inc("compiles_total", n - rs.compiled_seen)
            self.tracer.instant("compile", n_new=n - rs.compiled_seen)
            rs.compiled_seen = n

    def _record_step_series(self, rs: _RunState, lay_keep) -> None:
        """Per-step series: per-layer attention-gate keep rate
        (``attn_keep_rate{layer=i}``) and the running measured KV-saved
        fraction, both indexed by cumulative decode iteration."""
        m = rs.metrics
        if lay_keep is not None:
            for i, v in enumerate(lay_keep):
                m.record("attn_keep_rate", rs.step_idx, float(v), layer=i)
        dense = m.value("kv_entries_dense_measured_total")
        if dense:
            m.record("kv_saved_fraction", rs.step_idx,
                     1.0 - m.value("kv_entries_stored_measured_total")
                     / dense)

    # -- the boundary pass, fault seams and the watchdog -------------------
    def _boundary(self, rs: _RunState, kv) -> None:
        """The pass at the top of every iteration of all six run loops,
        after the previous step's, epoch's or window's sync and before
        anything is dispatched: (1) the request-lifecycle sweep
        (cancellation and deadline expiry release their resources within
        one iteration); (2) a crash-consistent snapshot of ``kv`` (the
        run's pool or store) when one is due; (3) the injected host kill,
        which fires *after* the snapshot so a resume loses nothing."""
        self._lifecycle(rs)
        self._maybe_snapshot(rs, kv)
        f = self.faults.take("kill", rs.disp_idx)
        if f is not None:
            rs.metrics.inc("faults_injected_total")
            self.tracer.instant("fault", kind="kill", step=rs.disp_idx)
            raise SimulatedKill(
                f"injected host kill at boundary {rs.disp_idx}: {f.message}",
                trace_path=self._flush_trace())

    def _maybe_snapshot(self, rs: _RunState, kv) -> None:
        """Publish a snapshot when one is due and the boundary is
        quiescent: no prefill in flight, no deferred first token, no
        staging cache.  There host structures, the KV state and the
        generator are the complete engine state.  Nothing dispatched may
        be unsynced at a boundary (every loop syncs its step, epoch or
        window before the next boundary): that is checked, not assumed."""
        if self.snapshot_dir is None:
            return
        if (rs.disp_idx - max(rs.last_snap, 0) < self.snapshot_every
                or rs.disp_idx == 0):
            return
        if (self.scheduler.prefilling is not None or rs.pending
                or rs.stage_cache is not None):
            return
        if rs.unsynced:
            raise RuntimeError(
                f"boundary {rs.disp_idx} with a decode dispatch not yet "
                "synced: a snapshot there would not be quiescent")
        with self.tracer.span("snapshot", step=rs.disp_idx):
            host = snapshot_mod.encode_host_state(self, rs)
            snapshot_mod.save_snapshot(self.snapshot_dir, rs.disp_idx,
                                       {"kv": kv, "rng": rs.generator}, host)
        rs.last_snap = rs.disp_idx
        rs.metrics.inc("snapshots_total")
        self.tracer.instant("snapshot", step=rs.disp_idx)

    def _apply_resume(self, rs: _RunState, kv) -> None:
        """Consume a pending ``resume()``: rebuild the host state, copy the
        restored KV state into ``kv`` (the run's pool or store, in place:
        whatever is built over it keeps valid addresses) and the
        generator's state into the run's, and reopen trace spans for the
        restored requests.  Runs before any epoch is built and before the
        first draw."""
        if self._resume is None:
            return
        tree, host, at = self._resume
        self._resume = None
        snapshot_mod.apply_host_state(self, rs, host)
        rs.last_snap = at
        snapshot_mod.copy_into({"kv": kv, "rng": rs.generator}, tree)
        tr = self.tracer
        for req in self.scheduler.queue:
            if req.uid not in rs.traced:
                rs.traced.add(req.uid)
                tid = request_tid(req.uid)
                tr.track(tid, f"req {req.uid}")
                tr.begin("request", tid)
                tr.begin("queued", tid)
        for st in self.scheduler.active.values():
            uid = st.req.uid
            rs.traced.add(uid)
            rs.admitted.add(uid)
            tid = request_tid(uid)
            tr.track(tid, f"req {uid}")
            tr.begin("request", tid)
        rs.metrics.inc("resumes_total")
        tr.instant("resume", step=at)

    def _fault_dispatch(self, rs: _RunState) -> None:
        """Dispatch-seam fault: raise the scheduled ``FaultInjected``
        before anything of the iteration's decode is enqueued (pool, store
        and epoch buffers untouched); the loop's retry path abandons the
        iteration and plans it again."""
        f = self.faults.take("dispatch_error", rs.disp_idx)
        if f is not None:
            rs.metrics.inc("faults_injected_total")
            self.tracer.instant("fault", kind="dispatch_error",
                                step=rs.disp_idx)
            raise FaultInjected(f.message)

    def _retry(self, rs: _RunState):
        """The retry path after an injected dispatch error: counted, then
        the iteration ends as an idle one does."""
        rs.metrics.inc("dispatch_retries_total")
        yield from self._end_step(rs)

    def _fault_stall(self, rs: _RunState) -> None:
        """Sync-seam fault: sleep inside the sync span, before the results
        are read, emulating a hung device dispatch the watchdog then
        observes."""
        f = self.faults.take("stall", rs.disp_idx)
        if f is not None:
            rs.metrics.inc("faults_injected_total")
            self.tracer.instant("fault", kind="stall", step=rs.disp_idx,
                                stall_s=f.stall_s)
            sleep_stall(f.stall_s)

    def _fault_oom(self, rs: _RunState) -> List[int]:
        """Headroom-seam fault (paged): hide free pages for this iteration
        so reservations fail exactly as if residents had filled the pool;
        the loop returns them (``allocator.unhide_pages``) before
        admission, or in the headroom pass when they are the only way
        out."""
        f = self.faults.take("oom", rs.disp_idx)
        if f is None:
            return []
        hidden = self.allocator.hide_pages(f.pages)
        rs.metrics.inc("faults_injected_total")
        self.tracer.instant("fault", kind="oom", step=rs.disp_idx,
                            pages=len(hidden))
        return hidden

    def _watch(self, rs: _RunState, phase: str, seconds: float) -> None:
        """Feed one dispatch-to-sync wall time to the watchdog; a straggler
        strike is counted and traced, a hard-timeout breach flushes the
        trace and re-raises ``HungDispatch`` with its path attached."""
        wd = self.watchdog
        if wd is None:
            return
        try:
            if wd.observe(phase, seconds):
                rs.metrics.inc("watchdog_strikes_total")
                self.tracer.instant("watchdog", phase=phase,
                                    elapsed_s=round(seconds, 6),
                                    strikes=wd.strikes)
        except HungDispatch as e:
            rs.metrics.inc("watchdog_timeouts_total")
            self.tracer.instant("watchdog", phase=phase,
                                elapsed_s=round(seconds, 6), timeout=True)
            e.trace_path = self._flush_trace()
            raise

    def _flush_trace(self) -> Optional[str]:
        """Flush the trace on the abort path (open spans and all) so the
        failure can be read afterwards; returns its path."""
        tr = self.tracer
        if tr.enabled and tr.path is not None:
            tr.save()
            return str(tr.path)
        return None

    # -- the lifecycle sweep -----------------------------------------------
    def _expired(self, req: Request, now: float) -> Optional[str]:
        """The request's lifecycle verdict at ``now``: "cancelled",
        "deadline", or None (keep going)."""
        if req.uid in self._cancelled:
            return "cancelled"
        if (req.deadline_s is not None and req.submit_s
                and now - req.submit_s > req.deadline_s):
            return "deadline"
        return None

    def _lifecycle(self, rs: _RunState) -> None:
        """Sweep every request the engine holds — queued, mid-prefill,
        resident — for cancellation or deadline expiry and retire the hits
        (slot and pages released, a warm admission's record unpinned, typed
        finish reason, trace spans closed).  A resident whose deferred
        first token is still on the device has that one token read (a
        sync on CUDA), so its partial result holds the real value."""
        sched = self.scheduler
        now = perf_counter()
        for req in list(sched.queue):
            reason = self._expired(req, now)
            if reason is not None:
                sched.remove_queued(req.uid)
                self.tracer.end(request_tid(req.uid))    # queued span
                self._finish_unplaced(rs, req, reason)
        pf = sched.prefilling
        if pf is not None:
            reason = self._expired(pf.req, now)
            if reason is not None:
                sched.abort_prefill(requeue=False)
                if self.kv_mode == "paged":
                    self.allocator.release(pf.slot)
                    self._abort_warm(pf.slot)
                rs.stage_cache, rs.stage_gates = None, []
                rs.admitted.discard(pf.req.uid)
                self.tracer.end(request_tid(pf.req.uid))  # prefill span
                self._finish_unplaced(rs, pf.req, reason)
        for slot in sorted(sched.active):
            st = sched.active[slot]
            reason = self._expired(st.req, now)
            if reason is not None:
                tok_dev = rs.pending.pop(slot, None)
                if tok_dev is not None:
                    st.out_tokens[0] = st.next_token = int(tok_dev[0])
                self._finish(rs, slot, reason)

    def _finish_unplaced(self, rs: _RunState, req: Request,
                         reason: str) -> None:
        """Retire a request that never (or no longer) holds a slot —
        removed from the queue, aborted mid-prefill or out of preemption
        budget there — with an empty token result and a typed reason."""
        self._cancelled.discard(req.uid)
        self._record_result(rs, RequestResult(
            uid=req.uid, tokens=np.zeros((0,), np.int32),
            prompt_len=req.prompt_len, ttft_s=0.0, decode_s=0.0,
            finish_reason=reason))
        self._count_lifecycle(rs, reason)
        tid = request_tid(req.uid)
        self.tracer.instant("finish", tid, reason=reason, tokens=0)
        if req.uid in rs.traced:
            self.tracer.end(tid)          # close the request root span

    @staticmethod
    def _count_lifecycle(rs: _RunState, reason: str) -> None:
        if reason == "cancelled":
            rs.metrics.inc("requests_cancelled_total")
        elif reason == "deadline":
            rs.metrics.inc("deadline_exceeded_total")
        elif reason == "preempt_budget":
            rs.metrics.inc("preempt_budget_exhausted_total")

    # -- prefill work units ------------------------------------------------
    def _tensor(self, a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        """A host array on the engine's device: on CUDA an asynchronous
        copy from pinned memory, so the host does not wait for the work in
        flight on the stream (a fused epoch's replays)."""
        t = torch.tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill(self, rs: _RunState, req: Request, pad_to=None,
                 defer: bool = False):
        """Monolithic prefill of one prompt (bucketed, or at its exact
        length) with the first token sampled.  Returns (token, gate log
        [L, Tb] or None without attention, cache): on the host, or with
        ``defer`` as device tensors ([1] and [L, Tb]) with no sync."""
        padded, last = self.scheduler.pad_prompt(req.tokens)
        logits, cache, pstats = self.model.prefill(
            self._tensor(padded[None]), pad_to=pad_to,
            last_index=self._tensor([last]))
        tok = sample(logits, rs.generator, self.temperature)
        gates = pstats.get("attn_gate")
        gates = None if gates is None else gates[:, 0]
        if defer:
            return tok, gates, cache
        t_sync = perf_counter()
        tok, gates = _fetch(tok, gates)
        rs.metrics.inc("device_seconds_total", perf_counter() - t_sync)
        return int(tok[0]), gates, cache

    def _feed(self):
        """This step's (tokens [S, 1], positions [S]); free slots feed
        token 0 at position 0 (their outputs are discarded)."""
        feed = np.zeros((self.max_slots, 1), np.int64)
        pos = np.zeros((self.max_slots,), np.int32)
        for slot, st in self.scheduler.active.items():
            feed[slot, 0] = st.next_token
            pos[slot] = st.pos
        return self._tensor(feed), self._tensor(pos, torch.int32)

    def _plan_dense(self, rs: _RunState, pool, n_steps: int,
                    fused: bool = False) -> None:
        """The dense pool's prefill work of one iteration, from the step
        planner: with chunking off every placeable queued request prefills
        whole (the budget may defer one); with ``prefill_chunk`` > 0 one
        chunk runs, so the residents decode between a prompt's chunks.
        ``fused`` (the fused loop, which wraps the whole pass in one
        ``plan`` span) leaves each first token on the device."""
        sched, tr = self.scheduler, self.tracer
        pre_active = bool(sched.active)
        did_prefill = False
        while True:
            with contextlib.nullcontext() if fused else tr.span("plan"):
                plan = sched.plan_step(token_budget=self.step_tokens,
                                       decode_steps=n_steps)
            self._note_admission(rs)
            if plan.prefill is None:
                if sched.prefilling is not None:
                    rs.stats.prefill_deferrals += 1
                break
            with tr.span("prefill"):
                self._prefill_work_dense(
                    rs, plan.prefill, pool,
                    defer=fused and plan.prefill.req.max_new_tokens > 1)
            did_prefill = True
            if self.prefill_chunk:
                break
        if did_prefill and pre_active:
            rs.metrics.inc("interleaved_steps_total")

    def _plan_paged(self, rs: _RunState, store, reuse: bool,
                    n_steps: int) -> None:
        """The paged store's prefill work of one iteration: one
        ``plan_step`` plan, admission gated on spare pages by
        ``_can_place``, at most one work unit.  A chunked (or budgeted)
        prompt reserves its worst case in the iteration that admits it:
        its chunks span iterations whose headroom passes also draw from
        the free list."""
        sched, alloc, nA = self.scheduler, self.allocator, self.n_attn
        tr = self.tracer
        pre_active = bool(sched.active)
        with tr.span("plan"):
            plan = sched.plan_step(can_place=self._can_place,
                                   token_budget=self.step_tokens,
                                   decode_steps=n_steps)
        self._note_admission(rs)
        pf = sched.prefilling
        if plan.prefill is None and pf is not None:
            rs.stats.prefill_deferrals += 1
        if (pf is not None and pf.done == 0
                and (self.prefill_chunk or self.step_tokens is not None)):
            if not alloc.ensure(pf.slot, pf.req.prompt_len * nA + nA):
                raise RuntimeError(
                    "worst-case page reservation failed in the same "
                    "iteration as a successful _can_place admission "
                    "check — allocator bug")
        if plan.prefill is not None:
            with tr.span("prefill"):
                self._prefill_work_paged(rs, plan.prefill, store, reuse)
            if pre_active:
                rs.metrics.inc("interleaved_steps_total")

    def _chunk_work(self, rs: _RunState, work: PrefillChunk, t0: float,
                    defer: bool, width: Optional[int] = None,
                    warm: int = 0):
        """One chunk through the staging cache (allocated at the prompt's
        first chunk unless a warm admission restored it), right-padded to
        C (or ``width``: a warm suffix's dispatch; ``warm`` is its record's
        length), its gate log kept on the device; inputs go through pinned
        memory.  A chunk that is not its prompt's last is only enqueued and
        counted (its device work is waited for by the next sync, a decode
        step's or epoch's): returns None.  The last returns (its first
        token, the prompt's gate log [L, Tp] (the chunks' logs side by
        side; Tp a chunk multiple ≥ T0), the staging cache), token and log
        on the host or, with ``defer``, as device tensors, and clears the
        run's staging state."""
        C = width or self.prefill_chunk
        if work.is_first and rs.stage_cache is None:
            rs.stage_cache = model_mod.init_chunk_cache(
                self.cfg, 1, self._chunk_cap, self.device)
            rs.stage_gates = []
        c = len(work.tokens)
        padded = np.pad(work.tokens, (0, C - c))
        tr = self.tracer
        if warm:
            idx = ((work.start - warm) // self.prefill_chunk
                   if self.prefill_chunk else 0)
            args = dict(tokens=c, warm=warm)
        else:
            idx = work.start // self.prefill_chunk
            args = dict(tokens=c)
        with tr.span(f"prefill[{idx}]", request_tid(work.req.uid), **args), \
                tr.annotate("prefill_chunk"):
            logits, rs.stage_cache, cstats = self.model.prefill_chunk(
                rs.stage_cache, self._tensor(padded[None]),
                self._tensor([work.start], torch.int32),
                last_index=self._tensor([c - 1]))
        rs.stage_gates.append(cstats["attn_gate"])
        if not work.is_last:
            rs.metrics.inc("prefill_chunks_total")
            rs.metrics.inc("prefill_seconds_total", perf_counter() - t0)
            self.scheduler.prefill_advance(work)
            return None
        tok = sample(logits, rs.generator, self.temperature)
        gates = torch.cat(rs.stage_gates, dim=2)[:, 0]
        cache = rs.stage_cache
        rs.stage_cache, rs.stage_gates = None, []
        if defer:
            return tok, gates, cache
        t_sync = perf_counter()
        tok, gates = _fetch(tok, gates)
        rs.metrics.inc("device_seconds_total", perf_counter() - t_sync)
        return int(tok[0]), gates, cache

    def _prefill_work_dense(self, rs: _RunState, work: PrefillChunk, pool,
                            defer: bool = False) -> None:
        """One dense-pool prefill work unit: a monolithic (bucketed)
        prefill and pool insert, or one staging-cache chunk, the last of
        which inserts the staging cache (cut to max_len) into the pool's
        own tensors in place.  ``defer`` (fused mode) leaves the first
        token and the gate log on the device, with no host sync."""
        t0 = perf_counter()
        if not self.prefill_chunk:
            tr = self.tracer
            with tr.span("prefill[0]", request_tid(work.req.uid),
                         tokens=work.req.prompt_len), tr.annotate("prefill"):
                tok, gates, cache = self._prefill(rs, work.req,
                                                  pad_to=self.max_len,
                                                  defer=defer)
                pool_insert(pool, cache, work.slot)
        else:
            staged = self._chunk_work(rs, work, t0, defer)
            if staged is None:
                return
            tok, gates, cache = staged
            pool_insert(pool, model_mod.slice_cache_time(cache, self.max_len),
                        work.slot)
        del cache
        self._finish_prefill(rs, work, tok, t0, gates, defer=defer)

    def _prefill_work_paged(self, rs: _RunState, work: PrefillChunk, store,
                            reuse: bool) -> None:
        """One paged prefill work unit: a monolithic prefill at the
        bucketed length, or one staging-cache chunk; on the prompt's last
        work unit reserve pages for its measured entries plus one decode
        step (a chunked prompt reserved its worst case at admission) and
        pack them from the gate log [nA, Tp]."""
        alloc, nA, slot = self.allocator, self.n_attn, work.slot
        if self.prefix is not None and slot in self._warm_pending:
            return self._prefill_work_warm(rs, work, store, reuse)
        T0 = work.req.prompt_len
        t0 = perf_counter()
        if not self.prefill_chunk:
            tr = self.tracer
            with tr.span("prefill[0]", request_tid(work.req.uid),
                         tokens=T0), tr.annotate("prefill_paged"):
                tok, gates, cache = self._prefill(rs, work.req)
        else:
            staged = self._chunk_work(rs, work, t0, defer=False)
            if staged is None:
                return
            tok, gates, cache = staged
        n_ent = paged_mod.prefill_entry_count(gates, T0, reuse)
        if not alloc.ensure(slot, n_ent + nA):
            raise PageExhausted(
                "page reservation failed after a successful _can_place "
                "worst-case check — allocator bug", slot=slot,
                free_pages=alloc.free_pages, pages_total=self.num_pages)
        paged_mod.pack_prefill(
            store, cache, self._tensor(gates, torch.float32), T0,
            self._tensor(alloc.block_table[slot], torch.int32), self.cfg,
            kv_dtype=self.kv_dtype)
        del cache
        alloc.append(slot, n_ent, nA * T0)
        rs.hist.on_prefill(slot, gates, T0)
        if self.prefix is not None:
            self.prefix.publish(work.req.tokens, gates, alloc.chain(slot))
        self._finish_prefill(rs, work, tok, t0, gates)

    def _prefill_work_warm(self, rs: _RunState, work: PrefillChunk, store,
                           reuse: bool) -> None:
        """A warm admission's work unit: the scheduler cut the prompt to
        its cold suffix (``work.start`` is the record's length), so nothing
        runs forward over the shared prefix.  The first suffix work unit
        does what the probe deferred: the boundary page's copy on write,
        then the staging cache restored from the shared entries (int8 and
        int4 pages dequantize exactly: their scales are powers of two).
        The suffix runs through ``_chunk_work``: chunks of C or, with
        chunking off, one dispatch padded to a power of two (at least 8,
        clamped to the suffix where it would run past the staging cache;
        a chunk is clamped the same way).  The last packs only the
        suffix's entries (``start_token``/``start_entry``), stitches the
        record's gate log to the suffix's so accounting and publishing see
        the whole prompt, republishes the longer chain and unpins."""
        alloc, nA, slot = self.allocator, self.n_attn, work.slot
        warm = self._warm_pending[slot]
        rec = warm.rec
        Ts, E_s = int(rec.length), int(rec.entries)
        t0 = perf_counter()
        if work.is_first:
            tr, tid = self.tracer, request_tid(work.req.uid)
            if warm.copy is not None:
                with tr.span("cow_copy", tid, entries=int(warm.copy[2])), \
                        tr.annotate("cow_copy"):
                    paged_mod.copy_page_masked(store, *warm.copy)
            with tr.span("warm_restore", tid, tokens=Ts, entries=E_s), \
                    tr.annotate("warm_restore"):
                chain = alloc.block_table[slot, :alloc.pages_for(E_s)]
                k_views, v_views = paged_mod.views_from_pages(
                    store, self._tensor(chain, torch.int32), E_s, self.cfg,
                    self._warm_cap, kv_dtype=self.kv_dtype)
                rs.stage_cache = paged_mod.chunk_cache_from_views(
                    k_views, v_views, self.cfg)
                del k_views, v_views
            rs.stage_gates = []
            rs.metrics.inc("prefix_hits_total")
            rs.metrics.inc("prefix_tokens_saved_total", Ts)
            tr.instant("prefix_hit", tid, warm_tokens=Ts, entries=E_s)
        c = len(work.tokens)
        if self.prefill_chunk:
            width = self.prefill_chunk
        else:
            width = 1 << max(3, (c - 1).bit_length())
        if work.start + width > self._warm_cap:
            width = c
        staged = self._chunk_work(rs, work, t0, defer=False, width=width,
                                  warm=Ts)
        if staged is None:
            return
        tok, suffix_gates, cache = staged
        T0 = work.req.prompt_len
        gates = np.concatenate([np.asarray(rec.gates, np.float32),
                                suffix_gates], axis=1)
        n_suffix = int(history_mod.host_fresh_mask(
            suffix_gates, reuse)[:, :T0 - Ts].sum())
        if not alloc.ensure(slot, E_s + n_suffix + nA):
            raise PageExhausted(
                "warm-suffix page reservation failed after the probe's "
                "worst-case reservation — allocator bug", slot=slot,
                free_pages=alloc.free_pages, pages_total=self.num_pages)
        paged_mod.pack_prefill(
            store, cache, self._tensor(gates, torch.float32), T0,
            self._tensor(alloc.block_table[slot], torch.int32), self.cfg,
            start_token=Ts, start_entry=E_s, kv_dtype=self.kv_dtype)
        del cache
        alloc.append(slot, n_suffix, nA * (T0 - Ts))
        rs.hist.on_prefill(slot, gates, T0)
        self.prefix.publish(work.req.tokens, gates, alloc.chain(slot))
        self.prefix.unpin(rec)
        del self._warm_pending[slot]
        self._finish_prefill(rs, work, tok, t0, gates)

    # -- single-step run loops ---------------------------------------------
    def _run_dense(self, generator):
        """Fixed ``max_slots × max_len`` pool.  Per iteration: the
        lifecycle sweep, the planner's prefill work (every placeable
        prompt, or one chunk), then one ragged decode step over the
        pool."""
        sched, cfg, tr = self.scheduler, self.cfg, self.tracer
        rs = self._new_run_state(generator, paged=False)
        m = rs.metrics
        L = max(len(cfg.attention_layers), 1)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        pool = init_pool(cfg, self.max_slots, self.max_len, self.device)
        self._apply_resume(rs, pool)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, pool)
            if not sched.has_work():      # the sweep drained the run
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            self._plan_dense(rs, pool, 1)
            if not sched.active:
                yield from self._end_step(rs)
                continue
            t0 = perf_counter()
            try:
                with tr.span("dispatch"), tr.annotate("decode_step"):
                    self._fault_dispatch(rs)
                    feed, pos = self._feed()
                    logits, pool, dstats = self.model.decode_step(pool, feed,
                                                                  pos)
                    tok = sample(logits, rs.generator, self.temperature)
            except FaultInjected:
                yield from self._retry(rs)
                continue
            self._dispatched(rs)
            t_sync = perf_counter()
            with tr.span("sync"):
                self._fault_stall(rs)
                toks, gates = _fetch(tok, dstats.get("attn_gate"))
            now = perf_counter()
            self._step_times(rs, t0, t_sync, now, "decode_step")
            with tr.span("bookkeep"):
                self._bookkeep(rs, toks, gates, t0, now, measure, L)
            rs.step_idx += 1
            rs.disp_idx += 1
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        return self._finalize(rs)

    def _run_paged(self, generator):
        """Paged-pool mode.  Per iteration: (1) the lifecycle sweep; (2)
        proactively guarantee one decode step of page headroom for every
        resident, preempting the youngest resident if the free list runs
        dry, so the step can never run out of pages; (3) one
        ``plan_step`` plan, admission gated on spare pages by
        ``_can_place``, at most one prefill; (4) one ragged decode step
        over all slots, the walk bounded to a power-of-two bucket of the
        live chains; (5) append the measured fresh entries and the
        history-buffer accounting from the step's gate log.  Page pressure
        evicts prefix records before anyone is preempted; a clean exit
        stashes the store for the next run."""
        sched, alloc, cfg, tr = (self.scheduler, self.allocator, self.cfg,
                                 self.tracer)
        nA = self.n_attn
        reuse = paged_mod.reuse_enabled(cfg)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        store = self._acquire_store()
        rs = self._new_run_state(generator, paged=True)
        self._apply_resume(rs, store)
        m = rs.metrics
        per_step = functools.partial(self._paged_append, rs, reuse)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, store)
            if not sched.has_work():
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            hidden = self._fault_oom(rs)
            with tr.span("headroom"):
                self._ensure_window(rs, 0, hidden)
            if hidden:
                alloc.unhide_pages(hidden)
            self._plan_paged(rs, store, reuse, 1)
            if not sched.active:
                yield from self._end_step(rs)
                continue
            # bound the walk to the live chains; power-of-two buckets keep
            # the number of distinct walk widths logarithmic
            j_live = max(1, alloc.max_chain_pages())
            j_step = min(1 << (j_live - 1).bit_length(), alloc.pages_per_slot)
            t0 = perf_counter()
            try:
                with tr.span("dispatch"), tr.annotate("paged_decode_step"):
                    self._fault_dispatch(rs)
                    feed, pos = self._feed()
                    logits, store, dstats = self.model.paged_decode_step(
                        store, feed, pos,
                        self._tensor(alloc.block_table[:, :j_step],
                                     torch.int32),
                        self._tensor(alloc.fill, torch.int32))
                    tok = sample(logits, rs.generator, self.temperature)
            except FaultInjected:
                yield from self._retry(rs)
                continue
            self._dispatched(rs)
            t_sync = perf_counter()
            with tr.span("sync"):
                self._fault_stall(rs)
                toks, gates = _fetch(tok, dstats["attn_gate"])
            now = perf_counter()
            self._step_times(rs, t0, t_sync, now, "decode_step")
            with tr.span("bookkeep"):
                self._bookkeep(rs, toks, gates, t0, now, measure, nA,
                               per_slot=per_step)
            rs.step_idx += 1
            rs.disp_idx += 1
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        self._store = store
        return self._finalize(rs)

    def _paged_append(self, rs: _RunState, reuse: bool, slot: int,
                      g: np.ndarray) -> None:
        """The paged hook of a decode iteration's per-slot bookkeeping: the
        allocator append of its measured fresh entries and the history
        replay."""
        nA = self.n_attn
        fresh_n = int(1 + (g[1:] > 0.5).sum()) if reuse else nA
        self.allocator.append(slot, fresh_n, nA)
        rs.hist.on_decode_step(slot, g)

    def _dispatched(self, rs: _RunState, n: int = 1) -> None:
        """A decode step, epoch or window is enqueued (``n`` dispatches: a
        window with drafts counts two); its sync is owed before the next
        boundary."""
        rs.metrics.inc("decode_dispatches_total", n)
        rs.unsynced = True

    def _step_times(self, rs: _RunState, t0: float, t_sync: float,
                    now: float, phase: str) -> None:
        """A decode step's, epoch's or window's times: the sync's wait, and
        its wall from dispatch to the end of the sync, which the watchdog
        observes as ``phase``."""
        m = rs.metrics
        rs.unsynced = False
        m.inc("device_seconds_total", now - t_sync)
        m.inc("decode_seconds_total", now - t0)
        m.observe("step_seconds", now - t0)
        self._watch(rs, phase, now - t0)

    # -- fused-epoch run loops (decode_steps > 1) --------------------------
    def _epoch(self, kv, rs: _RunState, paged: bool) -> DecodeEpoch:
        """The run's epoch over the dense pool or, ``paged``, the store: on
        CUDA the owner of its captured graphs (the pool's and the store's
        addresses hold for the whole run): one for the dense pool, one per
        block-table width for the store (power-of-two buckets of the live
        chains clamped to pages_per_slot, so at most
        ceil(log2(pages_per_slot)) + 1)."""
        ep = DecodeEpoch(self.model.params(), kv, self.cfg,
                         slots=self.max_slots, n_max=self.decode_steps,
                         max_len=self.max_len,
                         temperature=self.temperature,
                         generator=rs.generator, paged=paged,
                         sampler=sample)
        rs.epochs.append(ep)
        return ep

    def _epoch_args(self, rem: Dict[int, int]):
        """The epoch's inputs from the resident set; ``rem[slot]`` gets
        each slot's horizon — min(budget left, positions to max_len) —
        whose max picks the epoch length.  Returns (feed, pos, act,
        budget, stop, slots)."""
        S = self.max_slots
        feed = np.zeros((S,), np.int64)
        pos = np.zeros((S,), np.int32)
        act = np.zeros((S,), bool)
        budget = np.zeros((S,), np.int32)
        stop = np.full((S,), -1, np.int64)
        slots = []
        for slot, st in self.scheduler.active.items():
            feed[slot] = st.next_token
            pos[slot] = st.pos
            act[slot] = True
            b = st.req.max_new_tokens - len(st.out_tokens)
            budget[slot] = b
            if st.req.stop_token is not None:
                stop[slot] = st.req.stop_token
            rem[slot] = min(b, self.max_len - st.pos)
            slots.append(slot)
        return feed, pos, act, budget, stop, slots

    def _epoch_len(self, rem: Dict[int, int]) -> int:
        """``decode_steps`` clipped to the longest resident horizon,
        rounded up to a power of two (the reference's bound on its
        compiled loop variants; kept so epochs, and so tokens, match)."""
        rem_max = max(rem.values())
        return min(self.decode_steps, 1 << max(0, rem_max - 1).bit_length())

    def _launch_epoch(self, rs: _RunState, ep: DecodeEpoch, n: int) -> None:
        ep.run(n, annotate=functools.partial(
            self.tracer.annotate,
            "paged_decode_epoch" if ep.paged else "decode_epoch"))
        self._dispatched(rs)
        rs.stats.decode_iterations += n

    def _process_epoch(self, rs: _RunState, ep: DecodeEpoch, n_run: int,
                       slots: List[int], t_disp: float,
                       per_step=None) -> None:
        """The epoch's one sync, then the per-token bookkeeping replayed in
        step order exactly as the single-step loops do it
        (``step_active`` masks the steps a slot sat out after finishing
        mid-epoch).  ``per_step`` is the paged hook (allocator append +
        history replay).  A host/device disagreement on finishing raises
        instead of desyncing the KV state."""
        cfg, sched, tr = self.cfg, self.scheduler, self.tracer
        L = max(len(cfg.attention_layers), 1)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        t_sync = perf_counter()
        with tr.span("sync"):
            self._fault_stall(rs)
            toks, step_act, gates, fin_act = ep.fetch(n_run)
        now = perf_counter()
        self._step_times(rs, t_disp, t_sync, now, "decode_epoch")
        step_s = (now - t_disp) / n_run
        with tr.span("bookkeep"):
            # deferred first tokens first: their slots either join the
            # replay below or were killed at the epoch's entry and finish
            # here
            self._resolve_pending(rs)
            if tr.enabled:
                t0u, t1u = tr.to_us(t_disp), tr.to_us(now)
                for slot in slots:
                    st = sched.active.get(slot)
                    if st is not None:
                        tr.span_at(f"decode[{rs.disp_idx}]",
                                   request_tid(st.req.uid), t0u, t1u,
                                   tokens=int(step_act[:, slot].sum()))
            for slot in slots:
                st = sched.active.get(slot)
                if st is None:
                    continue
                reason = None
                for s in range(n_run):
                    if not step_act[s, slot]:
                        continue
                    g = gates[s, :, slot] if gates is not None else None
                    if g is not None:
                        rs.keep_acc += float(g.sum())
                        rs.keep_n += L
                    if per_step is not None:
                        per_step(slot, g)
                    reason = self._advance_slot(rs, st, int(toks[s, slot]),
                                                g, step_s, measure, L)
                    if reason:
                        self._finish(rs, slot, reason)
                        break
                if (reason is None) != bool(fin_act[slot]):
                    raise RuntimeError(
                        f"fused-epoch divergence on slot {slot}: host finish "
                        f"reason {reason!r} vs device active "
                        f"{bool(fin_act[slot])} — the device loop's stop/"
                        "length conditions no longer mirror _advance_slot")
            lay = None
            if gates is not None:
                msum = float(step_act.sum())
                if msum:
                    # per-layer keep rate over every executed (step, slot)
                    lay = (gates * step_act[:, None, :]).sum(axis=(0, 2)) \
                        / msum
            self._record_step_series(rs, lay)
        rs.step_idx += n_run
        rs.disp_idx += 1

    def _run_dense_fused(self, generator):
        """Dense pool with device-resident N-step epochs.  Per iteration:
        (0) the lifecycle sweep; (1) launch one epoch over the residents
        (sampling, stop/length detection and position advance on the
        device; deferred first tokens copied into the feed on the device);
        (2) while it runs, admission, prefills (first token left on the
        device, inputs copied from pinned memory) and pool inserts,
        enqueued behind it on the same stream with no host sync; (3) one
        sync and the epoch's bookkeeping.  Tokens equal ``_run_dense``'s at
        temperature 0."""
        sched, tr = self.scheduler, self.tracer
        rs = self._new_run_state(generator, paged=False)
        m = rs.metrics
        pool = init_pool(self.cfg, self.max_slots, self.max_len, self.device)
        # restored into the pool before the epoch is built over it
        self._apply_resume(rs, pool)
        ep = self._epoch(pool, rs, paged=False)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, pool)
            if not sched.has_work():
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            slots: List[int] = []
            n_eff, t_disp = 1, None
            if sched.active:
                rem: Dict[int, int] = {}
                feed, pos, act, budget, stop, slots = self._epoch_args(rem)
                n_eff = self._epoch_len(rem)
                t_disp = perf_counter()
                try:
                    with tr.span("dispatch", n=n_eff):
                        self._fault_dispatch(rs)
                        ep.load(feed, pos, act, budget, stop)
                        for slot, tok_dev in rs.pending.items():
                            if act[slot]:
                                ep.feed[slot].copy_(tok_dev[0])
                        self._launch_epoch(rs, ep, n_eff)
                except FaultInjected:
                    yield from self._retry(rs)
                    continue
            with tr.span("plan"):
                self._plan_dense(rs, pool, n_eff, fused=True)
            if t_disp is not None:
                self._process_epoch(rs, ep, n_eff, slots, t_disp)
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        return self._finalize(rs)

    def _run_paged_fused(self, generator):
        """Paged store with device-resident N-step epochs: the entry
        stream's fill advances on the device, and the allocator and
        history accounting are replayed from the epoch's gate log at its
        one sync.  OOM safety is per epoch: before launch every resident's
        worst case for the whole epoch (fill + min(n, horizon) · n_attn
        entries) is reserved; when the free list cannot cover it prefix
        records are evicted, then the epoch halves, and only at one step is
        the youngest resident preempted.
        After a shrink the length that fit caps later epochs, and two
        clean epochs in a row double the cap back."""
        sched, alloc, nA = self.scheduler, self.allocator, self.n_attn
        tr = self.tracer
        reuse = paged_mod.reuse_enabled(self.cfg)
        store = self._acquire_store()
        rs = self._new_run_state(generator, paged=True)
        # restored into the store before the epoch is built over it
        self._apply_resume(rs, store)
        m = rs.metrics
        ep = self._epoch(store, rs, paged=True)
        per_step = functools.partial(self._paged_append, rs, reuse)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, store)
            if not sched.has_work():
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            slots: List[int] = []
            n_eff, t_disp = 1, None
            if sched.active:
                rem = {slot: min(st.req.max_new_tokens - len(st.out_tokens),
                                 self.max_len - st.pos)
                       for slot, st in sched.active.items()}
                n_eff = self._epoch_len(rem)
                if rs.epoch_cap:
                    n_eff = min(n_eff, rs.epoch_cap)
                hidden = self._fault_oom(rs)
                shrunk = False
                with tr.span("headroom"):
                    while True:
                        failed = None
                        for slot in sorted(sched.active):
                            need = (int(alloc.fill[slot])
                                    + min(n_eff, rem.get(slot, 1)) * nA)
                            if not alloc.ensure(slot, need):
                                failed = slot
                                break
                        if failed is None:
                            break
                        if self._reclaim_pages():
                            continue
                        if n_eff > 1:
                            n_eff //= 2
                            shrunk = True
                            continue
                        if not self._preempt_youngest(rs, exclude=failed):
                            if hidden:
                                # the injected OOM drove the pool down to
                                # one resident: return the hidden pages
                                # instead of dying
                                alloc.unhide_pages(hidden)
                                hidden = []
                                continue
                            raise PageExhausted(
                                f"page pool exhausted with a single resident "
                                f"request (slot {failed}) — submit() should "
                                "have rejected it", slot=failed,
                                free_pages=alloc.free_pages,
                                pages_total=self.num_pages)
                if hidden:
                    alloc.unhide_pages(hidden)
                if shrunk:
                    rs.epoch_cap, rs.clean_epochs = n_eff, 0
                    m.inc("epoch_shrinks_total")
                    tr.instant("epoch_shrink", n_eff=n_eff)
                elif rs.epoch_cap:
                    rs.clean_epochs += 1
                    if rs.clean_epochs >= 2:
                        grown = rs.epoch_cap * 2
                        rs.epoch_cap = (0 if grown >= self.decode_steps
                                        else grown)
                        rs.clean_epochs = 0
                feed, pos, act, budget, stop, slots = self._epoch_args({})
                j_live = max(1, alloc.max_chain_pages())
                j_step = min(1 << (j_live - 1).bit_length(),
                             alloc.pages_per_slot)
                t_disp = perf_counter()
                try:
                    with tr.span("dispatch", n=n_eff):
                        self._fault_dispatch(rs)
                        ep.load(feed, pos, act, budget, stop, fill=alloc.fill,
                                block_table=alloc.block_table[:, :j_step])
                        self._launch_epoch(rs, ep, n_eff)
                except FaultInjected:
                    yield from self._retry(rs)
                    continue
            # admission sees the free list net of the epoch's reservation
            self._plan_paged(rs, store, reuse, n_eff)
            if t_disp is not None:
                self._process_epoch(rs, ep, n_eff, slots, t_disp,
                                    per_step=per_step)
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        self._store = store
        return self._finalize(rs)

    # -- speculative decoding (spec_k > 0) ---------------------------------
    def _window_gamma(self) -> int:
        """Draft length of this window, clamped so (a) every active slot
        holds the window's C = γ + 1 KV writes below ``max_len`` (a dense
        verify row written past the last would land on a committed row)
        and (b) the window is not all waste when every resident is nearly
        out of budget.  0 = verify-only: a C = 1 window, one plain decode
        step."""
        g = self.spec_k
        rem_max = 1
        for st in self.scheduler.active.values():
            g = min(g, self.max_len - st.pos - 1)
            rem_max = max(rem_max,
                          st.req.max_new_tokens - len(st.out_tokens))
        return max(0, min(g, rem_max - 1))

    def _ensure_window(self, rs: _RunState, gamma: int,
                       hidden: List[int]) -> None:
        """Grow every resident's page chain to a window's worst case (fill
        + (γ + 1)·n_attn entries; γ = 0 is one decode step's headroom)
        BEFORE the block table is read for the device: an append past the
        ensured chain would read a block-table zero and scatter into
        physical page 0, another slot's data.  Under pressure prefix
        records are evicted first, then the youngest resident preempted;
        ``hidden`` is the oom fault's page list, returned to the pool in
        place (and emptied) when it is the only way out."""
        alloc, sched = self.allocator, self.scheduler
        need_per = (gamma + 1) * self.n_attn
        for slot in sorted(sched.active):
            if slot not in sched.active:          # preempted below
                continue
            while not alloc.ensure(slot, int(alloc.fill[slot]) + need_per):
                if self._reclaim_pages():
                    continue
                if not self._preempt_youngest(rs, exclude=slot):
                    if hidden:
                        alloc.unhide_pages(hidden)
                        hidden.clear()
                        continue
                    raise PageExhausted(
                        f"page pool exhausted with a single resident "
                        f"request (slot {slot}) — submit() should have "
                        "rejected it", slot=slot,
                        free_pages=alloc.free_pages,
                        pages_total=self.num_pages)

    def _draft_epoch(self, kv, rs: _RunState, paged: bool) -> DecodeEpoch:
        """The run's draft loop over the pool or the store, under the draft
        parameters: on CUDA one captured graph of a draft iteration (one
        per block-table width paged), replayed γ times a window."""
        ep = DecodeEpoch(self.draft_params, kv, self.cfg,
                         slots=self.max_slots, n_max=self.spec_k,
                         max_len=0,
                         temperature=self.temperature,
                         generator=rs.generator, paged=paged,
                         sampler=sample, draft=True)
        rs.epochs.append(ep)
        return ep

    def _spec_inputs(self):
        """This window's host (feed [S], pos [S], active [S], the active
        slots in order); free slots feed token 0 at position 0."""
        feed, pos, act = self._epoch_args({})[:3]
        return feed, pos, act, sorted(self.scheduler.active)

    def _draft(self, rs: _RunState, ep: DecodeEpoch, feed: np.ndarray,
               feed_dev: torch.Tensor, pos_dev: torch.Tensor,
               act: np.ndarray, gamma: int, fill=None, bt=None):
        """The window's draft: γ draft iterations, then the verify feed
        [S, C] on the device (the fed token and the proposals; with the
        ``draft_override`` hook, rebuilt on the host).  γ = 0 drafts
        nothing."""
        if not gamma:
            return feed_dev[:, None]
        S = self.max_slots
        ep.load(feed_dev, pos_dev, act, np.zeros((S,), np.int32),
                np.full((S,), -1, np.int64), fill=fill, block_table=bt)
        ep.run(gamma, annotate=functools.partial(self.tracer.annotate,
                                                 "spec_draft"))
        if self.draft_override is not None:
            d = ep.tokens[:gamma].T.cpu().numpy().copy()       # [S, γ]
            for slot, st in self.scheduler.active.items():
                d[slot] = np.asarray(
                    self.draft_override(st.req.uid, d[slot].copy()),
                    np.int64)
            return self._tensor(np.concatenate([feed[:, None], d], axis=1))
        return torch.cat([feed_dev[:, None], ep.tokens[:gamma].T], dim=1)

    def _accept_windows(self, rs: _RunState, cur: List[int], gamma: int,
                        drafts: np.ndarray, tgt: np.ndarray,
                        vlog: Optional[np.ndarray],
                        dlog: Optional[np.ndarray]):
        """Host acceptance of one window: ({slot: emitted tokens, before
        truncation}, {slot: accepted drafts}).  Temperature 0 takes the
        greedy prefix match (the chain plain greedy decoding gives);
        temperature > 0 the exact accept / resample test per slot, its
        uniforms drawn from the run's generator."""
        emitted: Dict[int, List[int]] = {}
        accepted: Dict[int, int] = {}
        if self.temperature <= 0.0:
            acc, corr = sampling_mod.greedy_verify(tgt, drafts)
            for slot in cur:
                a = int(acc[slot])
                emitted[slot] = ([int(x) for x in drafts[slot, :a]]
                                 + [int(corr[slot])])
                accepted[slot] = a
            return emitted, accepted
        S, gen = drafts.shape[0], rs.generator
        u_acc = torch.rand((S, max(gamma, 1)), generator=gen,
                           dtype=torch.float64, device=gen.device)
        u_fin = torch.rand((S, gamma + 1), generator=gen,
                           dtype=torch.float64, device=gen.device)
        u_acc, u_fin = u_acc.cpu().numpy(), u_fin.cpu().numpy()
        p_t = sampling_mod.softmax_probs(vlog, self.temperature)
        p_d = (sampling_mod.softmax_probs(dlog, self.temperature)
               if gamma else None)
        for slot in cur:
            if gamma:
                a, toks = sampling_mod.speculative_accept_window(
                    drafts[slot], p_d[slot], p_t[slot], u_acc[slot],
                    u_fin[slot])
            else:
                a, toks = 0, [sampling_mod.inverse_cdf_sample(
                    p_t[slot, 0], float(u_fin[slot, 0]))]
            emitted[slot] = toks
            accepted[slot] = a
        return emitted, accepted

    def _plan_emission(self, st: ActiveRequest,
                       toks: List[int]) -> List[int]:
        """A window's emitted tokens cut to what ``_advance_slot`` will
        append: a stop token, the budget and ``max_len`` each end the
        request mid-window.  The paged engine commits exactly this many
        verify columns (the plain engine's fill trajectory, entry for
        entry)."""
        keep: List[int] = []
        for tok in toks:
            keep.append(tok)
            if st.req.stop_token is not None and tok == st.req.stop_token:
                break
            if len(st.out_tokens) + len(keep) >= st.req.max_new_tokens:
                break
            if st.pos + len(keep) >= self.max_len:
                break
        return keep

    def _emission_caps(self, cur: List[int]):
        """[S] bounds of ``_plan_emission`` for the fused greedy commit:
        budget left, positions left to ``max_len``, stop token (-1 none);
        slots outside ``cur`` keep harmless defaults (``active`` masks
        them)."""
        S = self.max_slots
        budget = np.ones((S,), np.int32)
        length = np.ones((S,), np.int32)
        stop = np.full((S,), -1, np.int64)
        for s in cur:
            st = self.scheduler.active[s]
            budget[s] = st.req.max_new_tokens - len(st.out_tokens)
            length[s] = self.max_len - st.pos
            if st.req.stop_token is not None:
                stop[s] = st.req.stop_token
        return (self._tensor(budget, torch.int32),
                self._tensor(length, torch.int32), self._tensor(stop))

    def _spec_verify_commit(self, store, chunk: torch.Tensor,
                            pos_dev: torch.Tensor, bt: torch.Tensor,
                            fill_dev: torch.Tensor, act_dev: torch.Tensor,
                            caps, cap: int):
        """Paged verify, greedy accept and the verified commit with no host
        sync between them (temperature 0): the greedy rule and
        ``_plan_emission``'s truncation (stop token, budget, ``max_len``)
        are elementwise over the verifier's argmax chain, so the device
        decides each slot's committed column count and rewrites the stream
        before the host reads anything; the host replays the acceptance
        from the argmax chain and requires the same counts.  Returns
        (argmax [S, C], gates [L, S, C], committed [S]) on the device."""
        logits, vstats = self.model.paged_verify_chunk(
            store, chunk, pos_dev, bt, fill_dev, cap=cap)
        tgt = torch.argmax(logits, dim=-1)                        # [S, C]
        C = tgt.shape[1]
        match = chunk[:, 1:] == tgt[:, :-1]
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(
            1, dtype=torch.int32)
        budget_cap, len_cap, stop = caps
        cols = torch.arange(C, dtype=torch.int32, device=tgt.device)[None]
        is_stop = (stop[:, None] >= 0) & (tgt == stop[:, None])
        stop_n = torch.where(is_stop, cols, C).amin(1) + 1
        n = torch.minimum(torch.minimum(acc + 1, stop_n),
                          torch.minimum(budget_cap, len_cap))
        committed = torch.where(act_dev, n.clamp(min=1),
                                0).to(torch.int32)
        bk, bv = vstats["kv_token"]
        model_mod.commit_verified(store, bk, bv, vstats["attn_gate"],
                                  pos_dev, bt, fill_dev, committed, act_dev,
                                  self.cfg)
        return tgt, vstats["attn_gate"], committed


    def _spec_bookkeep(self, rs: _RunState, cur: List[int], gamma: int,
                       plan_emit: Dict[int, List[int]],
                       accepted: Dict[int, int],
                       gates: Optional[np.ndarray], window_s: float,
                       measure: bool, n_layers: int, *, span,
                       per_tok=None) -> int:
        """Walk each slot's truncated emission in token order with exactly
        the plain loops' per-token accounting: emitted token i pairs with
        verify gate column i (the gates of processing the token that
        produced it).  ``per_tok`` is the paged hook (allocator append and
        history replay); ``span`` the window's (dispatch, sync end) clock
        readings for the requests' ``decode`` spans.  Returns the longest
        emission (the window's step-equivalent count)."""
        m, tr, sched = rs.metrics, self.tracer, self.scheduler
        m.inc("spec_windows_total")
        rs.stats.decode_iterations += gamma + 1
        max_emit = 1
        t0u, t1u = tr.to_us(span[0]), tr.to_us(span[1])
        lay_sum, lay_n = None, 0
        for slot in cur:
            st = sched.active[slot]
            keep = plan_emit[slot]
            a = accepted[slot]
            tid = request_tid(st.req.uid)
            if gamma:
                m.inc("spec_tokens_drafted_total", gamma)
                m.inc("spec_tokens_accepted_total", a)
                m.observe("spec_acceptance_rate", a / gamma)
            tr.instant("accept", tid, drafted=gamma, accepted=a,
                       emitted=len(keep))
            tr.span_at(f"decode[{rs.disp_idx}]", tid, t0u, t1u,
                       tokens=len(keep))
            share = window_s / len(keep)
            max_emit = max(max_emit, len(keep))
            reason = None
            for i, tok in enumerate(keep):
                g = gates[:, slot, i] if gates is not None else None
                if g is not None:
                    rs.keep_acc += float(g.sum())
                    rs.keep_n += n_layers
                if per_tok is not None:
                    per_tok(slot, g)
                reason = self._advance_slot(rs, st, int(tok), g, share,
                                            measure, n_layers)
                if reason and i != len(keep) - 1:
                    raise RuntimeError(
                        f"speculative window divergence on slot {slot}: "
                        f"_advance_slot finished ({reason!r}) at emitted "
                        f"token {i} but _plan_emission kept {len(keep)} — "
                        "the truncation rules no longer mirror the finish "
                        "conditions")
            if gates is not None:
                win = gates[:, slot, :len(keep)].sum(axis=1)
                lay_sum = win if lay_sum is None else lay_sum + win
                lay_n += len(keep)
            if reason:
                self._finish(rs, slot, reason)
        self._record_step_series(rs, lay_sum / lay_n if lay_n else None)
        return max_emit

    def _run_dense_spec(self, generator):
        """Dense-pool speculative loop.  Per iteration: the lifecycle sweep
        and the planner's prefill work as ``_run_dense``, then ONE window
        instead of a decode step: (1) γ draft iterations under
        ``draft_params`` propose tokens (their KV rows tentative); (2) one
        ``verify_chunk`` runs the full model over [feed, drafts], rewriting
        every window row with the verifier's KV (dense rollback is free:
        rows past the accepted prefix stay dead until the next window
        overwrites them); (3) one sync reads the per-column argmax, the
        drafts and the gates (and at temperature > 0 both logit sets); (4)
        host acceptance emits the accepted prefix and a correction per
        slot.  Up to γ + 1 tokens a slot a window; at temperature 0 the
        tokens are ``_run_dense``'s."""
        sched, cfg, tr = self.scheduler, self.cfg, self.tracer
        rs = self._new_run_state(generator, paged=False)
        m = rs.metrics
        L = max(len(cfg.attention_layers), 1)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        sampled = self.temperature > 0.0
        pool = init_pool(cfg, self.max_slots, self.max_len, self.device)
        # restored into the pool before the draft loop is built over it
        self._apply_resume(rs, pool)
        ep = self._draft_epoch(pool, rs, paged=False)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, pool)
            if not sched.has_work():
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            self._plan_dense(rs, pool, 1)
            if not sched.active:
                yield from self._end_step(rs)
                continue
            feed, pos, act, cur = self._spec_inputs()
            gamma = self._window_gamma()
            t0 = perf_counter()
            try:
                with tr.span("draft", k=gamma):
                    self._fault_dispatch(rs)
                    feed_dev = self._tensor(feed)
                    pos_dev = self._tensor(pos, torch.int32)
                    chunk = self._draft(rs, ep, feed, feed_dev, pos_dev, act,
                                        gamma)
            except FaultInjected:
                yield from self._retry(rs)
                continue
            with tr.span("verify", k=gamma), tr.annotate("spec_verify"):
                logits, pool, vstats = self.model.verify_chunk(pool, chunk,
                                                               pos_dev)
            self._dispatched(rs, 2 if gamma else 1)
            t_sync = perf_counter()
            with tr.span("sync"):
                self._fault_stall(rs)
                tgt, drafts, gates, dlog, vlog = _fetch(
                    torch.argmax(logits, dim=-1), chunk[:, 1:],
                    vstats.get("attn_gate"),
                    ep.logits[:gamma].transpose(0, 1)
                    if (gamma and sampled) else None,
                    logits if sampled else None)
            now = perf_counter()
            self._step_times(rs, t0, t_sync, now, "decode_window")
            with tr.span("bookkeep"):
                emitted, accepted = self._accept_windows(
                    rs, cur, gamma, drafts.astype(np.int64),
                    tgt.astype(np.int64), vlog, dlog)
                plan_emit = {s: self._plan_emission(sched.active[s],
                                                    emitted[s])
                             for s in cur}
                max_emit = self._spec_bookkeep(
                    rs, cur, gamma, plan_emit, accepted, gates, now - t0,
                    measure, L, span=(t0, now))
            rs.step_idx += max_emit
            rs.disp_idx += 1
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        return self._finalize(rs)

    def _run_paged_spec(self, generator):
        """Paged-store speculative loop, ``_run_dense_spec``'s twin with the
        tentative-commit protocol: (1) the residents' window headroom is
        reserved (``_ensure_window``) before admission, so ``_can_place``
        sees the free list net of it, and again after it, so a request
        activated by this iteration's prefill is covered too; (2) the
        draft loop appends tentative entries above the pre-draft fill;
        (3) the verifier reads the committed prefix only (restored below
        the pre-draft fill) and returns every window column's KV; (4)
        ``commit_verified`` rewrites the stream from the pre-draft fill
        with exactly the emitted columns, in the plain engine's
        token-major order, while the host replays the allocator and
        history accounting per emitted token and ``trim`` returns the
        rejected tail's pages (only private ones: an aliased prefix page
        keeps its other references).  At temperature 0 verify, accept and
        commit run with no sync between them (``_spec_verify_commit``) and
        the host replay must give the device's counts; at temperature > 0
        the host accepts first and the commit follows."""
        sched, alloc, cfg, tr = (self.scheduler, self.allocator, self.cfg,
                                 self.tracer)
        nA = self.n_attn
        reuse = paged_mod.reuse_enabled(cfg)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        sampled = self.temperature > 0.0
        store = self._acquire_store()
        rs = self._new_run_state(generator, paged=True)
        # restored into the store before the draft loop is built over it
        self._apply_resume(rs, store)
        m = rs.metrics
        ep = self._draft_epoch(store, rs, paged=True)
        per_tok = functools.partial(self._paged_append, rs, reuse)
        t_loop = perf_counter()
        while sched.has_work():
            self._boundary(rs, store)
            if not sched.has_work():
                break
            tr.begin("step", idx=rs.disp_idx)
            self._step_gauges(rs)
            hidden = self._fault_oom(rs)
            with tr.span("headroom"):
                self._ensure_window(
                    rs, self._window_gamma() if sched.active else 0, hidden)
            self._plan_paged(rs, store, reuse, 1)
            if not sched.active:
                if hidden:
                    alloc.unhide_pages(hidden)
                yield from self._end_step(rs)
                continue
            gamma = self._window_gamma()
            with tr.span("headroom"):
                self._ensure_window(rs, gamma, hidden)
            if hidden:
                alloc.unhide_pages(hidden)
            feed, pos, act, cur = self._spec_inputs()
            fill0 = alloc.fill.copy()
            j_live = max(1, alloc.max_chain_pages())
            j_step = min(1 << (j_live - 1).bit_length(), alloc.pages_per_slot)
            bt = alloc.block_table[:, :j_step]
            t0 = perf_counter()
            try:
                with tr.span("draft", k=gamma):
                    self._fault_dispatch(rs)
                    feed_dev = self._tensor(feed)
                    pos_dev = self._tensor(pos, torch.int32)
                    fill_dev = self._tensor(fill0, torch.int32)
                    bt_dev = self._tensor(bt, torch.int32)
                    act_dev = self._tensor(act, torch.bool)
                    chunk = self._draft(rs, ep, feed, feed_dev, pos_dev, act,
                                        gamma, fill=fill0, bt=bt)
            except FaultInjected:
                yield from self._retry(rs)
                continue
            cap = int(pos.max()) + gamma + 1
            dfill = ep.fill if gamma else fill_dev
            with tr.span("verify", k=gamma), tr.annotate("spec_verify"):
                if not sampled:
                    tgt_dev, gates_dev, committed_dev = \
                        self._spec_verify_commit(
                            store, chunk, pos_dev, bt_dev, fill_dev, act_dev,
                            self._emission_caps(cur), cap)
                    logits = None
                else:
                    logits, vstats = self.model.paged_verify_chunk(
                        store, chunk, pos_dev, bt_dev, fill_dev, cap=cap)
                    tgt_dev, gates_dev = (torch.argmax(logits, dim=-1),
                                          vstats["attn_gate"])
                    committed_dev = None
            self._dispatched(rs, 2 if gamma else 1)
            t_sync = perf_counter()
            with tr.span("sync"):
                self._fault_stall(rs)
                tgt, drafts, gates, dfill, committed_np, dlog, vlog = _fetch(
                    tgt_dev, chunk[:, 1:], gates_dev, dfill, committed_dev,
                    ep.logits[:gamma].transpose(0, 1)
                    if (gamma and sampled) else None, logits)
            now = perf_counter()
            self._step_times(rs, t0, t_sync, now, "decode_window")
            with tr.span("bookkeep"):
                emitted, accepted = self._accept_windows(
                    rs, cur, gamma, drafts.astype(np.int64),
                    tgt.astype(np.int64), vlog, dlog)
                plan_emit = {s: self._plan_emission(sched.active[s],
                                                    emitted[s])
                             for s in cur}
            with tr.span("rollback", k=gamma):
                committed = np.zeros((self.max_slots,), np.int32)
                for s in cur:
                    committed[s] = len(plan_emit[s])
                if not sampled:
                    if not np.array_equal(committed_np.astype(np.int32),
                                          committed):
                        raise RuntimeError(
                            "fused spec commit divergence: device committed "
                            f"{committed_np.astype(int).tolist()} vs host "
                            f"plan {committed.tolist()} — greedy accept "
                            "replay bug")
                else:
                    bk, bv = vstats["kv_token"]
                    model_mod.commit_verified(
                        store, bk, bv, vstats["attn_gate"], pos_dev, bt_dev,
                        fill_dev, self._tensor(committed, torch.int32),
                        act_dev, cfg)
                    del vstats, bk, bv
                # rolled back: the draft's tentative entries the commit
                # does not cover (the draft's fresh counts come from the
                # draft's gates, the commit's from the verifier's)
                rolled = 0
                for s in cur:
                    cf = int(fill0[s])
                    for i in range(len(plan_emit[s])):
                        g = gates[:, s, i]
                        cf += int(1 + (g[1:] > 0.5).sum()) if reuse else nA
                    rolled += max(0, int(dfill[s]) - cf)
                m.inc("spec_entries_rolled_back_total", rolled)
                max_emit = self._spec_bookkeep(
                    rs, cur, gamma, plan_emit, accepted, gates, now - t0,
                    measure, nA, per_tok=per_tok, span=(t0, now))
                for slot in cur:
                    if slot in sched.active:
                        alloc.trim(slot)
            rs.step_idx += max_emit
            rs.disp_idx += 1
            yield from self._end_step(rs)
        m.inc("host_seconds_total",
              perf_counter() - t_loop - m.value("device_seconds_total"))
        self._store = store
        return self._finalize(rs)

    # -- bookkeeping shared by both KV modes -------------------------------
    def _finish_prefill(self, rs: _RunState, work: PrefillChunk, tok,
                        t0: float, gates, defer: bool = False) -> None:
        """Activate a request whose prefill (first token included) just
        completed; finish it at once when that token already ends it.
        With ``defer`` (fused dense mode) ``tok`` is the device tensor: the
        host holds a placeholder until ``_resolve_pending`` reads it at
        the next epoch sync, and the stop check runs on the device at the
        next epoch's entry."""
        now = perf_counter()
        m = rs.metrics
        m.inc("prefill_chunks_total")
        m.inc("prefill_seconds_total", now - t0)
        m.inc("prefill_tokens_total", work.req.prompt_len)
        m.inc("decode_tokens_total")
        self.scheduler.prefill_advance(work)
        if defer:
            rs.pending[work.slot], tok = tok, 0
        act = ActiveRequest(req=work.req, slot=work.slot,
                            pos=work.req.prompt_len, next_token=tok,
                            out_tokens=[tok], submit_s=rs.t_run,
                            first_token_s=now, last_emit_s=now)
        act.pf_gates = gates
        self.scheduler.activate(act)
        self.tracer.end(request_tid(work.req.uid))    # prefill phase span
        req = work.req
        if defer:
            return
        if req.stop_token is not None and tok == req.stop_token:
            self._finish(rs, work.slot, "stop")
        elif req.max_new_tokens <= 1:
            self._finish(rs, work.slot, "length")

    def _resolve_pending(self, rs: _RunState) -> None:
        """Backfill the host bookkeeping of first tokens deferred by fused
        dense prefills (called at an epoch sync: the values are long
        computed, so the read is a copy, not a stall).  A deferred first
        token that IS the stop token was killed at the epoch's entry on
        the device (no emission, no KV append), so finishing it here
        mirrors the single-step engine's completion-time stop check."""
        for slot in list(rs.pending):
            tok = int(rs.pending.pop(slot)[0])
            st = self.scheduler.active.get(slot)
            if st is None:
                continue                  # stale (slot preempted)
            st.out_tokens[0] = st.next_token = tok
            if (st.req.stop_token is not None and tok == st.req.stop_token
                    and len(st.out_tokens) == 1):
                self._finish(rs, slot, "stop")

    def _bookkeep(self, rs: _RunState, toks: np.ndarray,
                  gates: Optional[np.ndarray], t0: float, now: float,
                  measure: bool, n_layers: int, per_slot=None) -> None:
        """A single decode step's bookkeeping for every resident (a stack
        without attention logs no gates: no keep rate, no KV accounting):
        the requests' ``decode`` spans, each slot's advance (``per_slot``
        is the paged hook: allocator append and history replay) and the
        step's series."""
        sched, tr = self.scheduler, self.tracer
        rs.stats.decode_iterations += 1
        cur = list(sched.active)
        if tr.enabled:
            t0u, t1u = tr.to_us(t0), tr.to_us(now)
            for slot in cur:
                tr.span_at(f"decode[{rs.disp_idx}]",
                           request_tid(sched.active[slot].req.uid),
                           t0u, t1u, tokens=1)
        lay = gates[:, cur].mean(axis=1) if gates is not None else None
        for slot in cur:
            st = sched.active[slot]
            g = gates[:, slot] if gates is not None else None
            if per_slot is not None:
                per_slot(slot, g)
            if g is not None:
                rs.keep_acc += float(g.sum())
                rs.keep_n += n_layers
            reason = self._advance_slot(rs, st, int(toks[slot]), g,
                                        now - t0, measure, n_layers)
            if reason:
                self._finish(rs, slot, reason)
        self._record_step_series(rs, lay)

    def _advance_slot(self, rs: _RunState, st: ActiveRequest, tok: int,
                      g: Optional[np.ndarray], step_s: float, measure: bool,
                      n_layers: int) -> Optional[str]:
        """One resident's post-step state (the fed token's KV was just
        written at st.pos).  Returns the finish reason or None."""
        m = rs.metrics
        st.decode_s += step_s
        now = perf_counter()
        gap = now - st.last_emit_s
        st.max_stall_s = max(st.max_stall_s, gap)
        m.observe("decode_stall_seconds", gap)
        st.last_emit_s = now
        if g is not None:
            stored = 1 + int(g[1:].sum()) if measure else n_layers
            st.kv_dense += n_layers
            st.kv_stored += stored
            m.inc("kv_entries_dense_measured_total", n_layers)
            m.inc("kv_entries_stored_measured_total", stored)
        st.pos += 1
        st.out_tokens.append(tok)
        st.next_token = tok
        m.inc("decode_tokens_total")
        if st.req.stop_token is not None and tok == st.req.stop_token:
            return "stop"
        if len(st.out_tokens) >= st.req.max_new_tokens:
            return "length"
        if st.pos >= self.max_len:
            return "max_len"
        return None

    def _account_prefill(self, rs: _RunState, st: ActiveRequest) -> None:
        """Fold the prompt-phase gate log into the request's measured
        KV-storage accounting (layer 0 dense + executed layers)."""
        if st.pf_gates is None:
            return
        T0 = st.req.prompt_len
        L = max(len(self.cfg.attention_layers), 1)
        if self.cfg.skip.enabled and self.cfg.skip.kv_reuse:
            g = st.pf_gates
            if isinstance(g, torch.Tensor):      # a deferred prefill's log
                g = g.float().cpu().numpy()
            g = np.asarray(g, np.float32)[:, :T0]
            stored = T0 + int((g[1:] > 0.5).sum())
        else:
            stored = L * T0
        st.kv_dense += L * T0
        st.kv_stored += stored
        rs.metrics.inc("kv_entries_dense_measured_total", L * T0)
        rs.metrics.inc("kv_entries_stored_measured_total", stored)
        st.pf_gates = None

    @staticmethod
    def _make_result(st: ActiveRequest, reason: str) -> RequestResult:
        st.finish_reason = reason
        return RequestResult(
            uid=st.req.uid, tokens=np.asarray(st.out_tokens, np.int32),
            prompt_len=st.req.prompt_len,
            ttft_s=st.first_token_s - st.submit_s, decode_s=st.decode_s,
            finish_reason=reason, kv_stored=st.kv_stored,
            kv_dense=st.kv_dense, max_decode_stall_s=st.max_stall_s)

    def _finish(self, rs: _RunState, slot: int, reason: str) -> None:
        """Evict ``slot``'s request and record its result (paged mode also
        returns its pages and clears its history accounting)."""
        st = self.scheduler.release(slot)
        self._account_prefill(rs, st)
        if self.kv_mode == "paged":
            self.allocator.release(slot)
            rs.hist.on_release(slot)
        self._emit_stream(st.req.uid, st.out_tokens, rs.step_idx)
        res = self._make_result(st, reason)
        self._record_result(rs, res)
        self._cancelled.discard(st.req.uid)
        self._count_lifecycle(rs, reason)
        m = rs.metrics
        m.inc("requests_completed_total")
        m.observe("ttft_seconds", res.ttft_s)
        n = res.decode_tokens - 1
        if n > 0 and res.decode_s > 0:
            m.observe("tpot_seconds", res.decode_s / n)
        tid = request_tid(st.req.uid)
        self.tracer.instant("finish", tid, reason=reason,
                            tokens=res.decode_tokens)
        self.tracer.end(tid)              # close the request root span

    def _preempt_youngest(self, rs: _RunState, exclude: int) -> bool:
        """OOM backpressure (paged mode).  An in-flight chunked prefill is
        always the newest admission and holds its worst-case reservation
        without being a resident, so it goes first: aborted, its pages and
        slot released, its staging state dropped (a warm admission's
        record unpinned), the request requeued to prefill again from its
        first chunk (no decode progress is lost, and the residents decode
        between the abort and the retry).  Else evict the youngest
        resident by original submission time (≠ ``exclude``) and requeue
        it at its age-ordered position; it re-prefills from scratch when
        pages free up.  A victim preempted more than ``max_preemptions``
        times finishes instead ("preempt_budget", its partial tokens
        kept).  Returns False when there is no victim."""
        sched, m, tr = self.scheduler, rs.metrics, self.tracer
        pf = sched.prefilling
        if pf is not None and pf.slot != exclude:
            sched.abort_prefill(requeue=False)
            self.allocator.release(pf.slot)
            self._abort_warm(pf.slot)
            rs.stage_cache, rs.stage_gates = None, []
            m.inc("preemptions_total")
            rs.stats.prefill_aborts += 1
            rs.admitted.discard(pf.req.uid)
            pf.req.preempt_count += 1
            tid = request_tid(pf.req.uid)
            tr.end(tid)                   # the open prefill span
            tr.instant("preempt", tid, kind="prefill_abort",
                       count=pf.req.preempt_count)
            if self._budget_spent(pf.req):
                self._finish_unplaced(rs, pf.req, "preempt_budget")
            else:
                sched.requeue(pf.req)     # age-preserving re-admission
                tr.begin("queued", tid)
            return True
        victims = [s for s in sched.active if s != exclude]
        if not victims:
            return False
        slot = max(victims, key=lambda s: sched.active[s].req.submit_s)
        st = sched.release(slot)
        self.allocator.release(slot)
        rs.hist.on_release(slot)
        rs.pending.pop(slot, None)
        m.inc("preemptions_total")
        rs.admitted.discard(st.req.uid)
        st.req.preempt_count += 1
        tid = request_tid(st.req.uid)
        tr.instant("preempt", tid, kind="evict", slot=slot,
                   count=st.req.preempt_count)
        if self._budget_spent(st.req):
            self._account_prefill(rs, st)
            self._emit_stream(st.req.uid, st.out_tokens, rs.step_idx)
            self._record_result(rs, self._make_result(st, "preempt_budget"))
            self._cancelled.discard(st.req.uid)
            self._count_lifecycle(rs, "preempt_budget")
            tr.instant("finish", tid, reason="preempt_budget",
                       tokens=len(st.out_tokens))
            tr.end(tid)                   # close the request root span
        else:
            sched.requeue(st.req)         # age-preserving re-admission
            tr.begin("queued", tid)
        return True

    def _budget_spent(self, req: Request) -> bool:
        return (self.max_preemptions is not None
                and req.preempt_count > self.max_preemptions)

    def _finalize(self, rs: _RunState) -> Dict[str, object]:
        """Derive the run's ServeStats from the metrics registry (the
        returned dict carries the registry too), fold per-request
        accounting into the aggregate KV numbers, and save the trace when
        the tracer has a path."""
        stats, results, m = rs.stats, rs.results, rs.metrics
        stats.prefill_tokens = int(m.value("prefill_tokens_total"))
        stats.decode_tokens = int(m.value("decode_tokens_total"))
        stats.prefill_s = m.value("prefill_seconds_total")
        stats.decode_s = m.value("decode_seconds_total")
        stats.prefill_chunks = int(m.value("prefill_chunks_total"))
        stats.interleaved_steps = int(m.value("interleaved_steps_total"))
        stats.requests_completed = int(m.value("requests_completed_total"))
        stats.decode_dispatches = int(m.value("decode_dispatches_total"))
        stats.device_s = m.value("device_seconds_total")
        stats.host_s = m.value("host_seconds_total")
        stats.preemptions = int(m.value("preemptions_total"))
        stats.compiles = int(m.value("compiles_total"))
        stats.graph_replays = sum(ep.replays for ep in rs.epochs)
        stats.requests_cancelled = int(m.value("requests_cancelled_total"))
        stats.deadline_exceeded = int(m.value("deadline_exceeded_total"))
        stats.requests_shed = int(m.value("requests_shed_total"))
        stats.preempt_budget_exhausted = int(
            m.value("preempt_budget_exhausted_total"))
        stats.epoch_shrinks = int(m.value("epoch_shrinks_total"))
        stats.faults_injected = int(m.value("faults_injected_total"))
        stats.dispatch_retries = int(m.value("dispatch_retries_total"))
        stats.watchdog_strikes = int(m.value("watchdog_strikes_total"))
        stats.snapshots = int(m.value("snapshots_total"))
        stats.resumes = int(m.value("resumes_total"))
        stats.spec_windows = int(m.value("spec_windows_total"))
        stats.spec_tokens_drafted = int(m.value("spec_tokens_drafted_total"))
        stats.spec_tokens_accepted = int(
            m.value("spec_tokens_accepted_total"))
        stats.spec_entries_rolled_back = int(
            m.value("spec_entries_rolled_back_total"))
        if stats.spec_tokens_drafted:
            stats.spec_acceptance_rate = (stats.spec_tokens_accepted
                                          / stats.spec_tokens_drafted)
        stats.attn_keep_frac = (rs.keep_acc / rs.keep_n if rs.keep_n
                                else 1.0)
        tot_dense = sum(r.kv_dense for r in results.values())
        tot_stored = sum(r.kv_stored for r in results.values())
        stats.kv_saved_fraction = (1.0 - tot_stored / tot_dense
                                   if tot_dense else 0.0)
        stats.kv_saved_analytic = analytic_kv_saved(self.cfg)
        if self.kv_mode == "paged":
            alloc = self.allocator
            stats.pages_peak = alloc.stats.pages_peak
            stats.kv_entries_stored = alloc.stats.entries_appended
            stats.kv_entries_dense = alloc.stats.entries_dense
            stats.history_hit_rate = rs.hist.hit_rate
            stats.history_hits_per_layer = rs.hist.per_layer_hit_rate
            m.set("pages_peak", alloc.stats.pages_peak)
            for i, h in enumerate(rs.hist.per_layer_hit_rate):
                m.set("history_hit_rate", h, layer=i)
            if self.prefix is not None:
                stats.prefix_hits = int(m.value("prefix_hits_total"))
                stats.prefix_misses = int(m.value("prefix_misses_total"))
                stats.prefix_tokens_saved = int(
                    m.value("prefix_tokens_saved_total"))
                stats.prefix_records = len(self.prefix)
                m.set("prefix_records", len(self.prefix))
        if self.tracer.enabled and self.tracer.path is not None:
            self.tracer.save()
        return {"results": results, "stats": stats, "metrics": m}
