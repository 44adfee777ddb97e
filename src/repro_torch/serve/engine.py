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
    and preemption of the youngest resident.  Decode runs one step per
    dispatch or, with ``decode_steps > 1``, device-resident N-step epochs
    (``models.model.DecodeEpoch``: on CUDA a captured graph of one
    iteration, replayed).
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_reuse
from repro_torch.kvcache import history as history_mod
from repro_torch.kvcache import paged as paged_mod
from repro_torch.models import layers, transformer
from repro_torch.models import model as model_mod
from repro_torch.models.model import DecodeEpoch, LanguageModel
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.errors import (AdmissionRejected, ConfigError,
                                      PageExhausted)
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import (ActiveRequest, PrefillChunk,
                                         Request, Scheduler, can_bucket,
                                         can_chunk_prefill, default_buckets)


@dataclasses.dataclass
class ServeStats:
    """Engine statistics for one ``generate()`` or ``run()`` (names as in
    the reference).  Times are host wall seconds around work that ends in a
    device synchronize.

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

    Paged mode (``kv_mode == "paged"``): page pool geometry, the live
    footprint's peak ``pages_peak``, ``preemptions``, the entry-stream write
    counters (``kv_entries_stored`` vs the per-layer-dense baseline
    ``kv_entries_dense``) and the history-buffer hit rates measured from
    the gate log."""
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
      finish_reason — "length" (budget), "stop" (stop token) or "max_len".
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
    "v"} [max_slots, max_len, Hkv, dh] zeros, or for a Mamba stack
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
    shape = (max_slots, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.num_layers)]


def pool_insert(pool: List[Dict], cache: List[Dict], slot: int
                ) -> List[Dict]:
    """Overwrite row ``slot`` of every pool leaf, in place, with a
    single-request prefill cache (batch 1; KV padded to max_len).  Every
    leaf is written whole: an SSM state, which no position masks, must
    not keep anything of the slot's previous request."""
    for pe, ce in zip(pool, cache):
        for name, leaf in pe.items():
            leaf[slot].copy_(ce[name][0])
    return pool


def _to_host(tok: torch.Tensor, gates: Optional[torch.Tensor]):
    """One device-to-host transfer for a step's tokens and gate log (token
    ids are exact in float32).  Returns (int64 tokens, float32 gates or
    None for a stack without attention)."""
    if gates is None:
        return tok.cpu().numpy().astype(np.int64), None
    n = tok.numel()
    flat = torch.cat([tok.reshape(-1).float(),
                      gates.reshape(-1).float()]).cpu().numpy()
    return flat[:n].astype(np.int64), flat[n:].reshape(tuple(gates.shape))


def _unported(config: EngineConfig, cfg: ModelConfig) -> List[str]:
    """Levers of the reference engine this port does not serve yet, each
    with the ROADMAP queue 1 item that will port it."""
    sch, rob, obs = config.scheduling, config.robustness, config.obs
    out = []
    if config.spec.spec_k or config.spec.draft_keep is not None:
        out.append("spec_k / draft_keep (item 11)")
    if config.kv.prefix_cache:
        out.append("prefix_cache (item 10)")
    if rob.faults is not None or rob.watchdog is not None:
        out.append("faults / watchdog (item 12)")
    if rob.snapshot_dir is not None:
        out.append("snapshots (item 12)")
    if rob.max_queue_depth is not None or rob.max_queue_delay_s is not None:
        out.append("load shedding (item 12)")
    if rob.max_preemptions is not None:
        out.append("max_preemptions (item 12)")
    if obs.trace:
        out.append("trace (item 12)")
    if obs.mesh is not None or obs.sharding_policy is not None:
        out.append("mesh / sharding_policy (item 14)")
    return out


@dataclasses.dataclass
class _RunState:
    """Host-side state of one ``run()``."""
    stats: ServeStats
    results: Dict[int, RequestResult]
    t_run: float
    generator: torch.Generator
    keep_acc: float = 0.0
    keep_n: float = 0.0
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

    ``model`` is a ``LanguageModel``; its device is the engine's.  An
    attention-free Mamba stack serves from the dense pool only (paged mode
    raises ``ValueError``, as do ``prefill_buckets``: it prefills at the
    exact prompt length, and admission overwrites the slot's conv
    histories and state whole; ``prefill_chunk`` > 0 raises
    ``ConfigError``).  Pass an
    ``EngineConfig`` or its flat kwargs (``max_slots``, ``max_len``,
    ``kv_mode``, ``page_size``, ``num_pages``, ``kv_dtype``,
    ``temperature``, ``prefill_buckets``, ``prefill_chunk``,
    ``decode_steps``, ``step_tokens``).  The
    reference's other levers raise ``ConfigError`` naming the ROADMAP item that will
    port them.  Sampling at ``temperature > 0`` draws from the
    ``torch.Generator`` given to ``run``."""

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
        self._uid = 0

    # -- submission ----------------------------------------------------------
    def submit(self, tokens: np.ndarray, max_new_tokens: int,
               stop_token: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue one prompt; returns its uid.  Raises ``AdmissionRejected``
        when the request can never be served (empty prompt, no decode
        headroom, paged worst-case KV over the pool)."""
        if deadline_s is not None:
            raise ConfigError("deadline_s is not ported to repro_torch yet "
                              "(ROADMAP queue 1 item 12)")
        uid = self._uid
        self._uid += 1
        req = Request(uid=uid, tokens=np.asarray(tokens, np.int32),
                      max_new_tokens=max_new_tokens, stop_token=stop_token)
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
        self.scheduler.submit(req)
        return uid

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
        spare)."""
        need = req.prompt_len * self.n_attn + self.n_attn
        pages = self.allocator.pages_for(need)
        if pages > self.allocator.pages_per_slot:
            return False
        return pages <= self.allocator.free_pages

    # -- main loop ---------------------------------------------------------
    @torch.no_grad()
    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, object]:
        """Drain the queue.  Returns {"results": {uid: RequestResult},
        "stats": ServeStats}."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        paged = self.kv_mode == "paged"
        if paged:
            stats = ServeStats(kv_mode="paged", page_size=self.page_size,
                               pages_total=self.num_pages)
            hist = history_mod.HistoryAccounting(
                self.n_attn, self.max_slots,
                paged_mod.reuse_enabled(self.cfg))
        else:
            stats, hist = ServeStats(), None
        rs = _RunState(stats=stats, results={}, t_run=perf_counter(),
                       generator=generator, hist=hist)
        if self.decode_steps > 1:
            run = self._run_paged_fused if paged else self._run_dense_fused
        else:
            run = self._run_paged if paged else self._run_dense
        run(rs)
        stats.host_s = perf_counter() - rs.t_run - stats.device_s
        return self._finalize(rs)

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
        tok, gates = _to_host(tok, gates)
        rs.stats.device_s += perf_counter() - t_sync
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
                    defer: bool = False) -> None:
        """The dense pool's prefill work of one iteration, from the step
        planner: with chunking off every placeable queued request prefills
        whole (the budget may defer one); with ``prefill_chunk`` > 0 one
        chunk runs, so the residents decode between a prompt's chunks."""
        sched = self.scheduler
        pre_active = bool(sched.active)
        did_prefill = False
        while True:
            plan = sched.plan_step(token_budget=self.step_tokens,
                                   decode_steps=n_steps)
            if plan.prefill is None:
                if sched.prefilling is not None:
                    rs.stats.prefill_deferrals += 1
                break
            self._prefill_work_dense(rs, plan.prefill, pool,
                                     defer=defer
                                     and plan.prefill.req.max_new_tokens > 1)
            did_prefill = True
            if self.prefill_chunk:
                break
        if did_prefill and pre_active:
            rs.stats.interleaved_steps += 1

    def _run_dense(self, rs: _RunState) -> None:
        """Fixed ``max_slots × max_len`` pool.  Per iteration: the
        planner's prefill work (every placeable prompt, or one chunk), then
        one ragged decode step over the pool."""
        sched, cfg = self.scheduler, self.cfg
        L = max(len(cfg.attention_layers), 1)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        pool = init_pool(cfg, self.max_slots, self.max_len, self.device)
        while sched.has_work():
            self._plan_dense(rs, pool, 1)
            if not sched.active:
                continue
            feed, pos = self._feed()
            t0 = perf_counter()
            logits, pool, dstats = self.model.decode_step(pool, feed, pos)
            tok = sample(logits, rs.generator, self.temperature)
            t_sync = perf_counter()
            toks, gates = _to_host(tok, dstats.get("attn_gate"))
            rs.stats.device_s += perf_counter() - t_sync
            self._bookkeep(rs, toks, gates, perf_counter() - t0, measure, L)

    def _run_paged(self, rs: _RunState) -> None:
        """Paged-pool mode.  Per iteration: (1) proactively guarantee one
        decode step of page headroom for every resident, preempting the
        youngest resident if the free list runs dry, so the step can never
        run out of pages; (2) one ``plan_step`` plan, admission gated on
        spare pages by ``_can_place``, at most one prefill; (3) one ragged
        decode step over all slots, the walk bounded to a power-of-two
        bucket of the live chains; (4) append the measured fresh entries
        and the history-buffer accounting from the step's gate log."""
        sched, alloc, cfg = self.scheduler, self.allocator, self.cfg
        nA = self.n_attn
        reuse = paged_mod.reuse_enabled(cfg)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        store = paged_mod.init_store(cfg, self.num_pages, self.page_size,
                                     kv_dtype=self.kv_dtype,
                                     device=self.device)
        while sched.has_work():
            for slot in sorted(sched.active):
                if slot not in sched.active:      # preempted below
                    continue
                while not alloc.ensure(slot, int(alloc.fill[slot]) + nA):
                    if not self._preempt_youngest(rs, exclude=slot):
                        raise PageExhausted(
                            f"page pool exhausted with a single resident "
                            f"request (slot {slot}) — submit() should have "
                            "rejected it", slot=slot,
                            free_pages=alloc.free_pages,
                            pages_total=self.num_pages)
            self._plan_paged(rs, store, reuse, 1)
            if not sched.active:
                continue
            feed, pos = self._feed()
            # bound the walk to the live chains; power-of-two buckets keep
            # the number of distinct walk widths logarithmic
            j_live = max(1, alloc.max_chain_pages())
            j_step = min(1 << (j_live - 1).bit_length(), alloc.pages_per_slot)
            t0 = perf_counter()
            logits, store, dstats = self.model.paged_decode_step(
                store, feed, pos,
                self._tensor(alloc.block_table[:, :j_step], torch.int32),
                self._tensor(alloc.fill, torch.int32))
            tok = sample(logits, rs.generator, self.temperature)
            t_sync = perf_counter()
            toks, gates = _to_host(tok, dstats["attn_gate"])
            rs.stats.device_s += perf_counter() - t_sync
            for slot in sched.active:
                g = gates[:, slot]
                fresh_n = int(1 + (g[1:] > 0.5).sum()) if reuse else nA
                alloc.append(slot, fresh_n, nA)
                rs.hist.on_decode_step(slot, g)
            self._bookkeep(rs, toks, gates, perf_counter() - t0, measure, nA)

    def _plan_paged(self, rs: _RunState, store, reuse: bool,
                    n_steps: int) -> None:
        """The paged store's prefill work of one iteration: one
        ``plan_step`` plan, admission gated on spare pages by
        ``_can_place``, at most one work unit.  A chunked (or budgeted)
        prompt reserves its worst case in the iteration that admits it:
        its chunks span iterations whose headroom passes also draw from
        the free list."""
        sched, alloc, nA = self.scheduler, self.allocator, self.n_attn
        pre_active = bool(sched.active)
        plan = sched.plan_step(can_place=self._can_place,
                               token_budget=self.step_tokens,
                               decode_steps=n_steps)
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
            self._prefill_work_paged(rs, plan.prefill, store, reuse)
            if pre_active:
                rs.stats.interleaved_steps += 1

    def _chunk_work(self, rs: _RunState, work: PrefillChunk, t0: float,
                    defer: bool):
        """One chunk through the staging cache (allocated at the prompt's
        first chunk), right-padded to C, its gate log kept on the device;
        inputs go through pinned memory.  A chunk that is not its prompt's
        last is only enqueued and counted (its device work is waited for
        by the next sync, a decode step's or epoch's): returns None.  The
        last returns (its first token, the prompt's gate log [L, Tp] (the
        chunks' logs side by side; Tp a chunk multiple ≥ T0), the staging
        cache), token and log on the host or, with ``defer``, as device
        tensors, and clears the run's staging state."""
        C = self.prefill_chunk
        if work.is_first:
            rs.stage_cache = model_mod.init_chunk_cache(
                self.cfg, 1, self._chunk_cap, self.device)
            rs.stage_gates = []
        c = len(work.tokens)
        padded = np.pad(work.tokens, (0, C - c))
        logits, rs.stage_cache, cstats = self.model.prefill_chunk(
            rs.stage_cache, self._tensor(padded[None]),
            self._tensor([work.start], torch.int32),
            last_index=self._tensor([c - 1]))
        rs.stage_gates.append(cstats["attn_gate"])
        if not work.is_last:
            rs.stats.prefill_chunks += 1
            rs.stats.prefill_s += perf_counter() - t0
            self.scheduler.prefill_advance(work)
            return None
        tok = sample(logits, rs.generator, self.temperature)
        gates = torch.cat(rs.stage_gates, dim=2)[:, 0]
        cache = rs.stage_cache
        rs.stage_cache, rs.stage_gates = None, []
        if defer:
            return tok, gates, cache
        t_sync = perf_counter()
        tok, gates = _to_host(tok, gates)
        rs.stats.device_s += perf_counter() - t_sync
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
            tok, gates, cache = self._prefill(rs, work.req,
                                              pad_to=self.max_len,
                                              defer=defer)
        else:
            staged = self._chunk_work(rs, work, t0, defer)
            if staged is None:
                return
            tok, gates, cache = staged
            cache = model_mod.slice_cache_time(cache, self.max_len)
        pool_insert(pool, cache, work.slot)
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
        T0 = work.req.prompt_len
        t0 = perf_counter()
        if not self.prefill_chunk:
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
        self._finish_prefill(rs, work, tok, t0, gates)

    # -- fused-epoch run loops (decode_steps > 1) --------------------------
    def _epoch(self, kv, rs: _RunState, paged: bool) -> DecodeEpoch:
        """The run's epoch over the dense pool or, ``paged``, the store: on
        CUDA the owner of its captured graphs (the pool's and the store's
        addresses hold for the whole run): one for the dense pool, one per
        block-table width for the store (power-of-two buckets of the live
        chains clamped to pages_per_slot, so at most
        ceil(log2(pages_per_slot)) + 1)."""
        return DecodeEpoch(self.model.params(), kv, self.cfg,
                           slots=self.max_slots, n_max=self.decode_steps,
                           max_len=self.max_len,
                           temperature=self.temperature,
                           generator=rs.generator, paged=paged,
                           sampler=sample)

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
        ep.run(n)
        rs.stats.decode_dispatches += 1
        rs.stats.decode_iterations += n
        rs.stats.compiles, rs.stats.graph_replays = ep.captures, ep.replays

    def _process_epoch(self, rs: _RunState, ep: DecodeEpoch, n_run: int,
                       slots: List[int], t_disp: float,
                       per_step=None) -> None:
        """The epoch's one sync, then the per-token bookkeeping replayed in
        step order exactly as the single-step loops do it
        (``step_active`` masks the steps a slot sat out after finishing
        mid-epoch).  ``per_step`` is the paged hook (allocator append +
        history replay).  A host/device disagreement on finishing raises
        instead of desyncing the KV state."""
        cfg, sched = self.cfg, self.scheduler
        L = max(len(cfg.attention_layers), 1)
        measure = cfg.skip.enabled and cfg.skip.kv_reuse
        t_sync = perf_counter()
        toks, step_act, gates, fin_act = ep.fetch(n_run)
        now = perf_counter()
        rs.stats.device_s += now - t_sync
        epoch_s = now - t_disp
        rs.stats.decode_s += epoch_s
        step_s = epoch_s / n_run
        # deferred first tokens first: their slots either join the replay
        # below or were killed at the epoch's entry and finish here
        self._resolve_pending(rs)
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
                reason = self._advance_slot(rs, st, int(toks[s, slot]), g,
                                            step_s, measure, L)
                if reason:
                    self._finish(rs, slot, reason)
                    break
            if (reason is None) != bool(fin_act[slot]):
                raise RuntimeError(
                    f"fused-epoch divergence on slot {slot}: host finish "
                    f"reason {reason!r} vs device active "
                    f"{bool(fin_act[slot])} — the device loop's stop/length "
                    "conditions no longer mirror _advance_slot")

    def _run_dense_fused(self, rs: _RunState) -> None:
        """Dense pool with device-resident N-step epochs.  Per iteration:
        (1) launch one epoch over the residents (sampling, stop/length
        detection and position advance on the device; deferred first
        tokens copied into the feed on the device); (2) while it runs,
        admission, prefills (first token left on the device, inputs
        copied from pinned memory) and pool inserts, enqueued behind it
        on the same stream with no host sync; (3) one sync and the
        epoch's bookkeeping.  Tokens equal ``_run_dense``'s at
        temperature 0."""
        sched = self.scheduler
        pool = init_pool(self.cfg, self.max_slots, self.max_len, self.device)
        ep = self._epoch(pool, rs, paged=False)
        while sched.has_work():
            slots: List[int] = []
            n_eff, t_disp = 1, None
            if sched.active:
                rem: Dict[int, int] = {}
                feed, pos, act, budget, stop, slots = self._epoch_args(rem)
                n_eff = self._epoch_len(rem)
                t_disp = perf_counter()
                ep.load(feed, pos, act, budget, stop)
                for slot, tok_dev in rs.pending.items():
                    if act[slot]:
                        ep.feed[slot].copy_(tok_dev[0])
                self._launch_epoch(rs, ep, n_eff)
            self._plan_dense(rs, pool, n_eff, defer=True)
            if t_disp is not None:
                self._process_epoch(rs, ep, n_eff, slots, t_disp)

    def _run_paged_fused(self, rs: _RunState) -> None:
        """Paged store with device-resident N-step epochs: the entry
        stream's fill advances on the device, and the allocator and
        history accounting are replayed from the epoch's gate log at its
        one sync.  OOM safety is per epoch: before launch every resident's
        worst case for the whole epoch (fill + min(n, horizon) · n_attn
        entries) is reserved; when the free list cannot cover it the epoch
        halves, and only at one step is the youngest resident preempted.
        After a shrink the length that fit caps later epochs, and two
        clean epochs in a row double the cap back."""
        sched, alloc, nA = self.scheduler, self.allocator, self.n_attn
        reuse = paged_mod.reuse_enabled(self.cfg)
        store = paged_mod.init_store(self.cfg, self.num_pages,
                                     self.page_size, kv_dtype=self.kv_dtype,
                                     device=self.device)
        ep = self._epoch(store, rs, paged=True)

        def per_step(slot, g):
            fresh_n = int(1 + (g[1:] > 0.5).sum()) if reuse else nA
            alloc.append(slot, fresh_n, nA)
            rs.hist.on_decode_step(slot, g)

        while sched.has_work():
            slots: List[int] = []
            n_eff, t_disp = 1, None
            if sched.active:
                rem = {slot: min(st.req.max_new_tokens - len(st.out_tokens),
                                 self.max_len - st.pos)
                       for slot, st in sched.active.items()}
                n_eff = self._epoch_len(rem)
                if rs.epoch_cap:
                    n_eff = min(n_eff, rs.epoch_cap)
                shrunk = False
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
                    if n_eff > 1:
                        n_eff //= 2
                        shrunk = True
                        continue
                    if not self._preempt_youngest(rs, exclude=failed):
                        raise PageExhausted(
                            f"page pool exhausted with a single resident "
                            f"request (slot {failed}) — submit() should "
                            "have rejected it", slot=failed,
                            free_pages=alloc.free_pages,
                            pages_total=self.num_pages)
                if shrunk:
                    rs.epoch_cap, rs.clean_epochs = n_eff, 0
                    rs.stats.epoch_shrinks += 1
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
                ep.load(feed, pos, act, budget, stop, fill=alloc.fill,
                        block_table=alloc.block_table[:, :j_step])
                self._launch_epoch(rs, ep, n_eff)
            # admission sees the free list net of the epoch's reservation
            self._plan_paged(rs, store, reuse, n_eff)
            if t_disp is not None:
                self._process_epoch(rs, ep, n_eff, slots, t_disp,
                                    per_step=per_step)

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
        st = rs.stats
        st.prefill_chunks += 1
        st.prefill_s += now - t0
        st.prefill_tokens += work.req.prompt_len
        st.decode_tokens += 1
        self.scheduler.prefill_advance(work)
        if defer:
            rs.pending[work.slot], tok = tok, 0
        act = ActiveRequest(req=work.req, slot=work.slot,
                            pos=work.req.prompt_len, next_token=tok,
                            out_tokens=[tok], submit_s=rs.t_run,
                            first_token_s=now, last_emit_s=now)
        act.pf_gates = gates
        self.scheduler.activate(act)
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
                  gates: Optional[np.ndarray], step_s: float, measure: bool,
                  n_layers: int) -> None:
        """Post-decode bookkeeping for every resident (a stack without
        attention logs no gates: no keep rate, no KV accounting)."""
        rs.stats.decode_s += step_s
        rs.stats.decode_dispatches += 1
        rs.stats.decode_iterations += 1
        for slot in list(self.scheduler.active):
            st = self.scheduler.active[slot]
            g = gates[:, slot] if gates is not None else None
            if g is not None:
                rs.keep_acc += float(g.sum())
                rs.keep_n += n_layers
            reason = self._advance_slot(rs, st, int(toks[slot]), g, step_s,
                                        measure, n_layers)
            if reason:
                self._finish(rs, slot, reason)

    def _advance_slot(self, rs: _RunState, st: ActiveRequest, tok: int,
                      g: Optional[np.ndarray], step_s: float, measure: bool,
                      n_layers: int) -> Optional[str]:
        """One resident's post-step state (the fed token's KV was just
        written at st.pos).  Returns the finish reason or None."""
        st.decode_s += step_s
        now = perf_counter()
        st.max_stall_s = max(st.max_stall_s, now - st.last_emit_s)
        st.last_emit_s = now
        if g is not None:
            st.kv_dense += n_layers
            st.kv_stored += 1 + int(g[1:].sum()) if measure else n_layers
        st.pos += 1
        st.out_tokens.append(tok)
        st.next_token = tok
        rs.stats.decode_tokens += 1
        if st.req.stop_token is not None and tok == st.req.stop_token:
            return "stop"
        if len(st.out_tokens) >= st.req.max_new_tokens:
            return "length"
        if st.pos >= self.max_len:
            return "max_len"
        return None

    def _account_prefill(self, st: ActiveRequest) -> None:
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
        st.pf_gates = None

    def _finish(self, rs: _RunState, slot: int, reason: str) -> None:
        """Evict ``slot``'s request and record its result (paged mode also
        returns its pages and clears its history accounting)."""
        st = self.scheduler.release(slot)
        self._account_prefill(st)
        if self.kv_mode == "paged":
            self.allocator.release(slot)
            rs.hist.on_release(slot)
        st.finish_reason = reason
        rs.results[st.req.uid] = RequestResult(
            uid=st.req.uid, tokens=np.asarray(st.out_tokens, np.int32),
            prompt_len=st.req.prompt_len,
            ttft_s=st.first_token_s - st.submit_s, decode_s=st.decode_s,
            finish_reason=reason, kv_stored=st.kv_stored,
            kv_dense=st.kv_dense, max_decode_stall_s=st.max_stall_s)
        rs.stats.requests_completed += 1

    def _preempt_youngest(self, rs: _RunState, exclude: int) -> bool:
        """OOM backpressure (paged mode).  An in-flight chunked prefill is
        always the newest admission and holds its worst-case reservation
        without being a resident, so it goes first: aborted, its pages and
        slot released, its staging state dropped, the request requeued to
        prefill again from its first chunk (no decode progress is lost,
        and the residents decode between the abort and the retry).  Else
        evict the youngest resident by original submission time (≠
        ``exclude``) and requeue it at its age-ordered position; it
        re-prefills from scratch when pages free up.  Returns False when
        there is no victim."""
        sched = self.scheduler
        pf = sched.prefilling
        if pf is not None and pf.slot != exclude:
            sched.abort_prefill()
            self.allocator.release(pf.slot)
            rs.stage_cache, rs.stage_gates = None, []
            rs.stats.preemptions += 1
            rs.stats.prefill_aborts += 1
            return True
        victims = [s for s in sched.active if s != exclude]
        if not victims:
            return False
        slot = max(victims, key=lambda s: sched.active[s].req.submit_s)
        st = sched.release(slot)
        self.allocator.release(slot)
        rs.hist.on_release(slot)
        rs.pending.pop(slot, None)
        rs.stats.preemptions += 1
        sched.requeue(st.req)
        return True

    def _finalize(self, rs: _RunState) -> Dict[str, object]:
        stats, results = rs.stats, rs.results
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
        return {"results": results, "stats": stats}
