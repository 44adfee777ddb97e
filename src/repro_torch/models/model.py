"""LanguageModel: init / prefill / prefill chunk / decode step over the
layer stack, with SkipGPT routing and cross-layer KV reuse threaded
through every layer; the fused decode epochs, and the speculative draft
loops, verify windows and verified commit.

Counterpart of the JAX package's ``models/model.py`` (inference entry
points).  Parameters are a nested dict named after the reference's pytree
paths, except that the scan-stacked ``stack.stage0`` / ``stack.stages``
leaves become one list ``blocks`` of per-layer dicts (``bridge.py`` maps
path to path).  ``LanguageModel`` owns them as ``nn.Module`` parameters.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kvcache import history
from repro_torch.kvcache import paged as paged_mod
from repro_torch.models import layers, transformer
from repro_torch.quant import quantize_params


def resolve_device(device) -> torch.device:
    """The entry points' device: ``cuda`` unless the caller asks for the
    CPU.  Asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available (pass device='cpu' to run the plain "
                           "versions on the CPU)")
    return device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, int4: bool = False) -> Dict:
    """Parameters with the reference's shapes and distributions, drawn from
    ``generator`` and built directly on ``device``.

    ``int4``: ``quant.quantize_params`` at the config's group size and
    scales, applied to each layer as soon as it is drawn (and to the lm
    head), so the whole tree is never held in the model's dtype: the tree
    equals ``quantize_params`` of the dense tree bit for bit (the draws
    come in the same order), and a model whose dense weights would not fit
    the card beside their codes (deepseek-coder-33b: ~66.7 GB of bf16) is
    built on it.  The rule quantizes 2-D ``w`` leaves only, so an MoE
    block's 3-D expert leaves and its expert router ``gate`` stay in the
    model's dtype (attention, Arctic's dense residual and the head go to
    int4)."""
    transformer.check_supported(cfg)
    quant = (lambda t: t) if not int4 else (
        lambda t: quantize_params(t, cfg.quant.group_size,
                                  cfg.quant.pow2_scales))
    p = {"embed": layers.embedding_init(generator, cfg, device),
         "blocks": [quant(transformer.block_init(generator, cfg, device, i))
                    for i in range(cfg.num_layers)],
         "final_norm": layers.norm_init(cfg.d_model, cfg, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = quant(layers.linear_init(
            generator, cfg.d_model, cfg.vocab_size, cfg, device, scale=0.02))
    return p


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def _pad_cache_to(cache: List[Dict], T: int, pad_to: int) -> List[Dict]:
    """Grow each layer's [B, T, Hkv, dh] KV view to pad_to (decode room); a
    LOCAL layer's ring (W long, from a prompt longer than W), a Mamba
    layer's conv histories and state are left as they are (the
    reference's ``_pad_cache_to`` grows only the leaves T long)."""
    out = []
    for ce in cache:
        grown = {}
        for name, kv in ce.items():
            if name not in ("k", "v") or kv.shape[1] != T:
                grown[name] = kv
                continue
            g = torch.zeros((kv.shape[0], pad_to) + tuple(kv.shape[2:]),
                            dtype=kv.dtype, device=kv.device)
            g[:, :T] = kv
            grown[name] = g
        out.append(grown)
    return out


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            pad_to: Optional[int] = None,
            last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """tokens [B, T] -> (last-position logits [B, V], per-layer cache
    [{"k", "v"}: [B, pad_to or T, Hkv, dh]] or, for a Mamba stack,
    [{"conv_x", "conv_bc", "ssm"}], stats).

    ``last_index``: optional [B] index of each sequence's final *real*
    token — bucketed prefill right-pads prompts to a shared length, and the
    next-token logits must come from the real last position."""
    transformer.check_supported(cfg)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, T)
    x = layers.embed(params["embed"], tokens)
    x, stats, cache, sq = transformer.stack_forward(params["blocks"], x,
                                                    positions, cfg)
    if last_index is None:
        xl = x[:, -1:]
        sql = None if sq is None else sq[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        idx = torch.as_tensor(last_index, device=x.device).long()
        xl = x[rows, idx][:, None]
        sql = None if sq is None else sq[rows, idx][:, None]
    x = layers.norm_apply(params["final_norm"], xl, cfg, stats=sql)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x,
                            cfg)[:, 0]
    if pad_to is not None and pad_to > T:
        cache = _pad_cache_to(cache, T, pad_to)
    return logits, cache, stats


def init_chunk_cache(cfg: ModelConfig, batch: int, cap_len: int,
                     device, dtype: Optional[torch.dtype] = None
                     ) -> List[Dict]:
    """Staging cache of chunked prefill: per layer {"k", "v"} [batch,
    cap_len, Hkv, dh] zeros, time-major (the layout ``prefill`` collects,
    which ``serve.engine.pool_insert`` and ``kvcache.paged.pack_prefill``
    take).  ``cap_len`` is normally max_len rounded up to a chunk
    multiple, so a right-padded final chunk fits.  Raises ``ValueError``
    for a stack that is not all global attention."""
    for i in range(cfg.num_layers):
        if cfg.block_kind(i) != ATTN:
            raise ValueError("chunked prefill requires an all-global-attn "
                             f"stack; got a {cfg.block_kind(i)!r} layer")
    dt = dtype or layers.torch_dtype(cfg)
    shape = (batch, cap_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.num_layers)]


def slice_cache_time(cache: List[Dict], length: int) -> List[Dict]:
    """Each layer's KV views cut to ``length`` along time (views, no copy):
    a staging cache's chunk-multiple overhang shed before a pool insert."""
    return [{name: (kv[:, :length] if name in ("k", "v") else kv)
             for name, kv in ce.items()} for ce in cache]


def _chunk_stack(params: Dict, cache: List[Dict], tokens: torch.Tensor,
                 t0, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict]:
    """The stack pass of ``prefill_chunk``: C tokens at offset ``t0`` over
    the staging cache, each layer's merged view written at [t0, t0 + C).
    Returns (the last block's activations [B, C, D], its Σy²/D carry,
    stats with ``attn_gate`` [L, B, C]); the final norm is the caller's."""
    transformer.check_supported(cfg)
    B, C = tokens.shape
    dev = tokens.device
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=dev)
    t0 = t0.reshape(-1).expand(B).contiguous()
    pos = t0[:, None] + torch.arange(C, dtype=torch.int32, device=dev)[None]
    x = layers.embed(params["embed"], tokens)
    x, _, stats, sq = transformer.stack_prefill_chunk(
        params["blocks"], cache, x, t0, pos, cfg)
    return x, sq, stats


def prefill_chunk(params: Dict, cache: List[Dict], tokens: torch.Tensor,
                  t0, cfg: ModelConfig,
                  last_index: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """One chunk of resumable prefill: tokens [B, C] appended at offset
    ``t0`` ([B] or scalar).  ``cache`` (from ``init_chunk_cache``) holds
    every layer's view of positions [0, t0) and is updated IN PLACE at
    [t0, t0 + C).  Returns (logits [B, V] at ``last_index`` within the
    chunk (default: its last column), cache, stats) with ``attn_gate``
    [L, B, C], the monolithic prefill's gate log column slice by column
    slice.  A right-padded final chunk passes ``last_index`` = real length
    − 1; its pad columns compute values that causal masking keeps out of
    every real token."""
    x, sq, stats = _chunk_stack(params, cache, tokens, t0, cfg)
    B = x.shape[0]
    if last_index is None:
        xl, sql = x[:, -1:], None if sq is None else sq[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        idx = torch.as_tensor(last_index, device=x.device).long()
        xl = x[rows, idx][:, None]
        sql = None if sq is None else sq[rows, idx][:, None]
    x = layers.norm_apply(params["final_norm"], xl, cfg, stats=sql)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x,
                            cfg)[:, 0]
    return logits, cache, stats


def verify_chunk(params: Dict, cache: List[Dict], tokens: torch.Tensor,
                 t0, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """Speculative verification: ``prefill_chunk`` with *every* column
    unembedded.  Feeding the window [f0, d_1..d_k] at positions [t0, t0 +
    k] (t0 [B] or scalar) returns logits [B, k+1, V] whose column j is the
    verifier's next-token distribution after the prefix ending at the
    j-th fed token, so column j judges draft d_{j+1} and column ``a``
    gives the correction after accepting ``a`` drafts.  The window's KV
    lands at [t0, t0 + C) of ``cache`` (the dense pool, or a staging
    cache) IN PLACE, as a prefill chunk's does: rows past the accepted
    prefix are dead until the next window overwrites them, masked until
    then by decode's ``kv_valid_len``.  Returns (logits, cache, stats with
    ``attn_gate`` [L, B, C])."""
    x, sq, stats = _chunk_stack(params, cache, tokens, t0, cfg)
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits, cache, stats


def decode_step(params: Dict, cache: List[Dict], tokens: torch.Tensor,
                t, cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict], Dict]:
    """One token per sequence.  tokens [B, 1]; t: [B] or scalar position
    (lock-step).  The caches are updated IN PLACE (the JAX engine donates
    them).  Returns (logits [B, V], cache, stats) with ``attn_gate`` [L, B]
    (``ssm_gate`` for a Mamba stack)."""
    transformer.check_supported(cfg)
    B = tokens.shape[0]
    t = torch.as_tensor(t, dtype=torch.int32, device=tokens.device)
    t = t.reshape(-1).expand(B).contiguous()
    pos = t[:, None]
    x = layers.embed(params["embed"], tokens)
    x, cache, stats, sq = transformer.stack_decode(params["blocks"], cache, x,
                                                   t, pos, cfg)
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits[:, 0], cache, stats


def paged_decode_step(params: Dict, store: Dict, tokens: torch.Tensor,
                      t, block_table: torch.Tensor, fill: torch.Tensor,
                      cfg: ModelConfig,
                      commit_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict, Dict]:
    """One token for every slot against the paged KV store.

    The dense-pool twin of ``decode_step``: past tokens' KV lives in the
    shared store-once entry stream (``kvcache/paged.py``).  ``block_table``
    [B, J] and ``fill`` [B] come from the host-side ``PageAllocator``, which
    has guaranteed page capacity for this step's ≤ n_attn_layers appends.
    Slots with ``fill == 0`` are inactive: they decode garbage but commit
    nothing; ``commit_mask`` [B] overrides that default.  The store is
    updated IN PLACE.  Returns (logits [B, V], store, stats) with
    ``attn_gate`` [L, B]."""
    transformer.check_supported(cfg)
    if not paged_mod.can_page(cfg):
        raise ValueError(f"{cfg.name}: not a pageable stack")
    B = tokens.shape[0]
    dev = tokens.device
    t = torch.as_tensor(t, dtype=torch.int32, device=dev)
    t = t.reshape(-1).expand(B).contiguous()
    pos = t[:, None]
    block_table = block_table.to(device=dev, dtype=torch.int32)
    fill = fill.to(device=dev, dtype=torch.int32)
    x = layers.embed(params["embed"], tokens)

    # resolve the page chains' metadata once per step (the store is frozen
    # until the end-of-step commit; the kernel walks the pages itself)
    kv_dtype = paged_mod.infer_kv_dtype(store, cfg)
    ctx = paged_mod.gather_view(store, block_table, with_kv=False)
    E = ctx["pos"].shape[1]
    ctx["in_fill"] = (torch.arange(E, device=dev)[None, :]
                      < fill[:, None])
    ctx["k_pages"], ctx["v_pages"] = store["k_pages"], store["v_pages"]
    ctx["block_table"] = block_table
    if kv_dtype is not None:
        ctx["k_scales"], ctx["v_scales"] = store["k_scales"], store["v_scales"]

    x, (buf_k, buf_v), stats, sq = transformer.stack_decode_paged(
        params["blocks"], x, pos, cfg, ctx)
    if commit_mask is None:
        commit_mask = fill > 0
    paged_mod.commit_decode(store, buf_k, buf_v, stats["attn_gate"], t,
                            block_table, fill, commit_mask.to(dev), cfg,
                            kv_dtype=kv_dtype)
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits[:, 0], store, stats


# ---------------------------------------------------------------------------
# Device-resident multi-step decode (one dispatch per N tokens)
# ---------------------------------------------------------------------------

def _entry_active(feed: torch.Tensor, active: torch.Tensor,
                  stop: torch.Tensor) -> torch.Tensor:
    """A deferred first token (sampled by the prefill, never seen by the
    host) may itself be the stop token: kill the slot before it decodes,
    so it emits nothing and appends no KV."""
    return active & ~((stop >= 0) & (feed == stop))


def _loop_finish(tok: torch.Tensor, t: torch.Tensor, emitted: torch.Tensor,
                 active: torch.Tensor, budget: torch.Tensor,
                 stop: torch.Tensor, max_len: int) -> torch.Tensor:
    """Per-slot finish detection, replicating the host engine's
    ``_advance_slot`` conditions: stop token sampled, generation budget
    exhausted (``emitted`` already counts this step's token), or the next
    write position reaching the pool's max_len."""
    hit_stop = (stop >= 0) & (tok == stop)
    return active & ~(hit_stop | (emitted >= budget) | (t + 1 >= max_len))


def _upload(buf: torch.Tensor, v) -> None:
    """Copy host values (or a tensor) into ``buf`` in place; host values
    reach a CUDA buffer through pinned memory, without a stream sync."""
    src = torch.as_tensor(v)
    if buf.is_cuda and not src.is_cuda:
        src = src.to(buf.dtype).pin_memory()
        buf.copy_(src, non_blocking=True)
    else:
        buf.copy_(src)


def _kv_device(kv) -> torch.device:
    return (kv["pos_pages"] if isinstance(kv, dict) else
            next(iter(kv[0].values()))).device


class DecodeEpoch:
    """Up to ``n_max`` fused decode iterations over a slot pool — ``kv`` is
    the dense pool (one dict per layer) or, with ``paged``, the §4.4 store
    — whose whole state lives in static device buffers: the carry (feed,
    t, active, budget, stop, emitted and, paged, fill and the block table,
    one buffer per width) and the stacked per-step outputs (tokens,
    step_active, attention gates), whose row ``step`` — a device counter
    the iteration advances itself — each iteration writes.

    ``run(n)`` is the counterpart of the reference's ``lax.scan`` epoch:
    n iterations of ``_iterate`` (decode step, sampling, finish detection,
    carry update; paged, the fill advance).  CPU tensors take the plain
    eager loop.  CUDA tensors take a CUDA graph of one iteration replayed
    n times: the first epoch at each block-table width (the dense pool has
    one) runs its first iteration eagerly as the warm-up, so kernel builds
    and ``cudaFuncSetAttribute`` calls happen outside the capture, then
    captures the next iteration and replays it n − 1 times.  A failed
    capture or replay raises; nothing falls back to the eager loop.

    A graph fixes its kernels' arguments at capture.  That is valid only
    because every tensor it touches keeps its address: the weights, the
    pool or store (updated in place; a Mamba layer's new conv histories
    and state are copied back into its pool leaves), the buffers here,
    and scratch from the graph's memory pool, shared by every capture of
    this epoch.  Host choices the kernel wrappers make from ``data_ptr()``
    (the router's alignment plan, the SSD scan's clone) are fixed with
    them.  A capture passes through the kernel wrappers without launching,
    so its ticks of their launch counters are taken back and kept as its
    delta; a replay launches the captured kernels without passing through
    the wrappers, so the counters keep counting the wrappers' own launches
    (the warm-up iterations'), and ``graph_launches()`` gives what the
    replays stand for, delta × replays, derived and never added to them.

    ``sampler(logits, generator, temperature)`` draws the tokens (by
    default ``serve.sampling.sample``); at temperature > 0 the run's
    generator is registered with each graph, so every replay draws
    afresh.

    ``draft`` makes it the speculative draft loop's (``draft_loop``,
    ``paged_draft_loop``): an iteration proposes a token for every slot
    and advances (feed, t) unconditionally, with no stop, budget or length
    test (the host clamps the window and truncates emission at
    acceptance), the paged fill advancing where ``active``; it also keeps
    each step's logits [n_max, S, V] (fp32) for the temperature > 0
    accept test.  ``budget`` and ``stop`` are loaded but not read."""

    def __init__(self, params: Dict, kv, cfg: ModelConfig, *, slots: int,
                 n_max: int, max_len: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 paged: bool = False, sampler=None, draft: bool = False):
        if sampler is None:
            from repro_torch.serve.sampling import sample as sampler
        self.params, self.kv, self.cfg = params, kv, cfg
        self.n_max, self.max_len, self.paged = n_max, max_len, paged
        self.temperature, self.generator = temperature, generator
        self.sampler = sampler
        self.reuse = paged_mod.reuse_enabled(cfg)
        dev = _kv_device(kv)
        i32 = dict(dtype=torch.int32, device=dev)
        self.feed = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self.stop = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        self.t = torch.zeros((slots,), **i32)
        self.budget = torch.zeros((slots,), **i32)
        self.emitted = torch.zeros((slots,), **i32)
        self.fill = torch.zeros((slots,), **i32)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self.step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.tokens = torch.zeros((n_max, slots), dtype=torch.int64,
                                  device=dev)
        self.step_active = torch.zeros((n_max, slots), dtype=torch.bool,
                                       device=dev)
        n_attn = len(cfg.attention_layers)
        self.gates = (torch.zeros((n_max, n_attn, slots),
                                  dtype=torch.float32, device=dev)
                      if n_attn else None)
        self.draft = draft
        self.logits = (torch.zeros((n_max, slots, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
                       if draft else None)
        self._tables: Dict[int, torch.Tensor] = {}   # width -> [S, width]
        self._width: Optional[int] = None
        self._graphs: Dict[Optional[int], torch.cuda.CUDAGraph] = {}
        self._deltas: Dict[Optional[int], Dict[str, int]] = {}
        self._replays: Dict[Optional[int], int] = {}
        self._pool = None
        self.captures = 0      # graphs captured
        self.replays = 0       # graph replays (iterations not run eagerly)

    def load(self, feed, t, active, budget, stop, fill=None,
             block_table=None) -> None:
        """Copy one epoch's inputs into the buffers (host arrays or tensors,
        [S] each; the paged store's ``fill`` and ``block_table`` [S, J])."""
        for buf, v in ((self.feed, feed), (self.t, t), (self.active, active),
                       (self.budget, budget), (self.stop, stop)):
            _upload(buf, v)
        if self.paged:
            bt = torch.as_tensor(block_table)
            width = int(bt.shape[1])
            if width not in self._tables:
                self._tables[width] = torch.zeros(
                    tuple(bt.shape), dtype=torch.int32,
                    device=self.feed.device)
            _upload(self._tables[width], bt)
            self._width = width
            _upload(self.fill, fill)

    def run(self, n: int, annotate=contextlib.nullcontext) -> None:
        """n iterations from the loaded carry (the entry check first).
        ``annotate()`` (a context, e.g. the tracer's
        ``torch.profiler.record_function``) wraps the eager iterations and
        the replays, never a capture."""
        if not 1 <= n <= self.n_max:
            raise ValueError(f"epoch length {n} outside 1..{self.n_max}")
        self.active.copy_(_entry_active(self.feed, self.active, self.stop))
        self.emitted.zero_()
        self.step.zero_()
        if self.feed.device.type != "cuda":
            with annotate():
                for _ in range(n):
                    self._iterate()
            return
        key = self._width
        graph, done = self._graphs.get(key), 0
        if graph is None:
            with annotate():
                self._iterate()             # the warm-up: a real iteration
            graph, done = self._capture(key), 1
        with annotate():
            for _ in range(n - done):
                graph.replay()
        self._replays[key] += n - done
        self.replays += n - done

    def captured(self) -> bool:
        """Whether the loaded block-table width (the dense pool has one)
        has its graph: a CUDA run then replays every iteration."""
        return self._width in self._graphs

    def graph_launches(self) -> Dict[str, int]:
        """The wrapper launches the replays so far stand for, by counter:
        each capture's delta × its replays (derived, not counted)."""
        out: Dict[str, int] = {}
        for key, delta in self._deltas.items():
            for k, n in delta.items():
                out[k] = out.get(k, 0) + n * self._replays[key]
        return out

    def _capture(self, key) -> "torch.cuda.CUDAGraph":
        from repro_torch.kernels import ops as kops
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0 and self.generator is not None:
            graph.register_generator_state(self.generator)
        before = kops.kernel_launches()
        with torch.cuda.graph(graph, pool=self._pool):
            self._iterate()
        after = kops.kernel_launches()
        kops.set_kernel_launches(before)     # a capture launches nothing
        self._deltas[key] = {k: after[k] - before[k] for k in after}
        self._graphs[key], self._replays[key] = graph, 0
        self.captures += 1
        return graph

    def _iterate(self) -> None:
        """One iteration of the scan body; every write lands in place."""
        cfg, feed = self.cfg, self.feed[:, None]
        if self.paged:
            logits, _, stats = paged_decode_step(
                self.params, self.kv, feed, self.t, self._tables[self._width],
                self.fill, cfg, commit_mask=self.active & (self.fill > 0))
            gates = stats["attn_gate"]                         # [nA, S]
            n_fresh = history.fresh_mask(gates, self.reuse).to(
                torch.int32).sum(0, dtype=torch.int32)
            self.fill.add_(torch.where(self.active, n_fresh, 0))
        else:
            leaves = [dict(ce) for ce in self.kv]
            logits, _, stats = decode_step(self.params, self.kv, feed,
                                           self.t, cfg)
            for ce, kept in zip(self.kv, leaves):
                for name, leaf in kept.items():
                    if ce[name] is not leaf:       # a Mamba layer's state
                        leaf.copy_(ce[name])
                        ce[name] = leaf
            gates = stats.get("attn_gate")
        tok = self.sampler(logits, self.generator, self.temperature)
        if self.draft:
            self.tokens.index_copy_(0, self.step, tok[None])
            self.logits.index_copy_(0, self.step,
                                    logits[None].to(self.logits.dtype))
            self.feed.copy_(tok)
            self.t.add_(1)
            self.step.add_(1)
            return
        self.emitted.add_(self.active.to(torch.int32))
        nxt = _loop_finish(tok, self.t, self.emitted, self.active,
                           self.budget, self.stop, self.max_len)
        self.tokens.index_copy_(0, self.step, tok[None])
        self.step_active.index_copy_(0, self.step, self.active[None])
        if self.gates is not None:
            self.gates.index_copy_(0, self.step,
                                   gates[None].to(self.gates.dtype))
        self.feed.copy_(torch.where(nxt, tok, self.feed))
        self.t.copy_(torch.where(nxt, self.t + 1, self.t))
        self.active.copy_(nxt)
        self.step.add_(1)

    def outputs(self, n: int) -> Dict[str, Optional[torch.Tensor]]:
        """The last epoch's stacked outputs (``tokens``/``step_active``
        [n, S], ``attn_gate`` [n, L, S] or None for a stack without
        attention) and its final carry, as device tensors."""
        out = {"tokens": self.tokens[:n].clone(),
               "step_active": self.step_active[:n].clone(),
               "attn_gate": (None if self.gates is None
                             else self.gates[:n].clone()),
               "feed": self.feed.clone(), "t": self.t.clone(),
               "active": self.active.clone(),
               "emitted": self.emitted.clone()}
        if self.paged:
            out["fill"] = self.fill.clone()
        if self.draft:
            out["logits"] = self.logits[:n].clone()
        return out

    def fetch(self, n: int):
        """The last epoch's tokens [n, S] int64, step_active [n, S] bool,
        gates [n, L, S] float32 (None without attention) and final active
        [S] bool on the host, in one transfer: the epoch's one sync (token
        ids are exact in float32)."""
        S = self.feed.shape[0]
        parts = [self.tokens[:n].reshape(-1).float(),
                 self.step_active[:n].reshape(-1).float(),
                 self.active.float()]
        if self.gates is not None:
            parts.append(self.gates[:n].reshape(-1))
        flat = torch.cat(parts).cpu().numpy()
        toks = flat[:n * S].reshape(n, S).astype(np.int64)
        act = flat[n * S:2 * n * S].reshape(n, S) > 0.5
        fin = flat[2 * n * S:2 * n * S + S] > 0.5
        gates = (None if self.gates is None else
                 flat[2 * n * S + S:].reshape((n,) + tuple(
                     self.gates.shape[1:])))
        return toks, act, gates, fin


def decode_loop(params: Dict, cache: List[Dict], feed, t, active, budget,
                stop, generator: Optional[torch.Generator] = None, *,
                n_steps: int, cfg: ModelConfig, max_len: int,
                temperature: float = 0.0) -> Tuple[List[Dict], Dict]:
    """``n_steps`` fused decode iterations over the dense slot pool:
    per-step sampling, stop-token/length detection and position advance
    all happen on the device, so the host syncs once per epoch instead of
    once per token (on CUDA one captured graph, replayed; see
    ``DecodeEpoch``).

    Inputs (all [B] over the slot pool): ``feed`` the token each slot
    feeds next, ``t`` its write position, ``active`` slot liveness,
    ``budget`` how many tokens the slot may still emit, ``stop`` its stop
    token id (-1 = none).  A slot that finishes mid-loop freezes its
    (feed, t) pair: every later iteration rewrites, bit for bit, the KV
    row it already wrote at ``t`` instead of appending.  Inactive slots
    compute garbage that never escapes: ``step_active`` masks their tokens.
    Random draws come from ``generator``, one per step.

    Returns (cache, updated in place, out) with ``tokens``/``step_active``
    [n_steps, B], ``attn_gate`` [n_steps, L, B] (None for a stack without
    attention) and the final ``feed``/``t``/``active``/``emitted``."""
    epoch = DecodeEpoch(params, cache, cfg, slots=len(feed), n_max=n_steps,
                        max_len=max_len, temperature=temperature,
                        generator=generator)
    epoch.load(feed, t, active, budget, stop)
    epoch.run(n_steps)
    return cache, epoch.outputs(n_steps)


def paged_decode_loop(params: Dict, store: Dict, feed, t, fill, active,
                      budget, stop,
                      generator: Optional[torch.Generator] = None,
                      block_table=None, *, n_steps: int, cfg: ModelConfig,
                      max_len: int, temperature: float = 0.0
                      ) -> Tuple[Dict, Dict]:
    """``decode_loop``'s paged-store twin: N fused ``paged_decode_step``
    iterations with the entry-stream fill advancing on device — each
    active slot appends its fresh-entry count (layer 0 + executed layers,
    the host ``PageAllocator`` accounting the engine replays from the
    returned gate log).  A slot that finishes mid-loop drops out of the
    commit mask (``active & (fill > 0)``), so it stops appending; the
    host must have reserved pages for ``n_steps`` worst-case appends per
    active slot (``block_table`` [B, J] must span them).  Returns (store,
    updated in place, out) as ``decode_loop`` plus the final ``fill``."""
    epoch = DecodeEpoch(params, store, cfg, slots=len(feed), n_max=n_steps,
                        max_len=max_len, temperature=temperature,
                        generator=generator, paged=True)
    epoch.load(feed, t, active, budget, stop, fill=fill,
               block_table=block_table)
    epoch.run(n_steps)
    return store, epoch.outputs(n_steps)


# ---------------------------------------------------------------------------
# Speculative decoding: draft loops, paged verify, verified commit
# ---------------------------------------------------------------------------

def draft_loop(params: Dict, cache: List[Dict], feed, t,
               generator: Optional[torch.Generator] = None, *,
               n_steps: int, cfg: ModelConfig,
               temperature: float = 0.0) -> Tuple[List[Dict], Dict]:
    """Speculative draft: ``n_steps`` decode iterations under the (usually
    skip-biased, ``core.routing.draft_router_bias``) draft parameters over
    the dense pool, proposing one token per slot and step (on CUDA one
    captured graph of an iteration, replayed; see ``DecodeEpoch``).

    Unlike ``decode_loop`` there is no stop, budget or length masking: a
    window is short (the host clamps γ so every write stays below the
    pool's rows) and the host truncates emission at acceptance, so a draft
    running past a stop token proposes on.  Draft KV lands in the pool
    rows the verify window overwrites at once.  Returns (cache, updated in
    place, out): ``tokens`` [n, B], ``logits`` [n, B, V] (fp32: the
    distributions the temperature > 0 accept test reconstructs), and the
    final ``feed``/``t``."""
    # max_len 0: a draft iteration tests no length
    epoch = DecodeEpoch(params, cache, cfg, slots=len(feed), n_max=n_steps,
                        max_len=0, temperature=temperature,
                        generator=generator, draft=True)
    S = len(feed)
    epoch.load(feed, t, np.ones((S,), bool), np.zeros((S,), np.int32),
               np.full((S,), -1, np.int64))
    epoch.run(n_steps)
    return cache, epoch.outputs(n_steps)


def paged_draft_loop(params: Dict, store: Dict, feed, t, fill, active,
                     generator: Optional[torch.Generator] = None,
                     block_table=None, *, n_steps: int, cfg: ModelConfig,
                     temperature: float = 0.0) -> Tuple[Dict, Dict]:
    """``draft_loop`` against the paged store: tentative entries append at
    the live fill (the committed prefix below the window's entry count
    stays untouched), the fill advancing on the device by the measured
    fresh-entry count of the ``active`` slots (commit mask ``active &
    (fill > 0)``).  Every entry appended here is tentative:
    ``paged_verify_chunk`` reads only the pre-draft prefix, and
    ``commit_verified`` rewrites the stream from the pre-draft fill with
    the verifier's KV for the accepted columns only.  The host must have
    reserved pages for ``n_steps`` worst-case appends per active slot
    (``block_table`` [B, J] must span them).  Returns (store, updated in
    place, out) as ``draft_loop`` plus the final ``fill``, so the host can
    count rolled-back entries."""
    epoch = DecodeEpoch(params, store, cfg, slots=len(feed), n_max=n_steps,
                        max_len=0, temperature=temperature,
                        generator=generator, paged=True, draft=True)
    S = len(feed)
    epoch.load(feed, t, active, np.zeros((S,), np.int32),
               np.full((S,), -1, np.int64), fill=fill,
               block_table=block_table)
    epoch.run(n_steps)
    return store, epoch.outputs(n_steps)


def paged_verify_chunk(params: Dict, store: Dict, tokens: torch.Tensor,
                       t0, block_table: torch.Tensor, fill: torch.Tensor,
                       cfg: ModelConfig, cap: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """Speculative verification against the paged store, read-only.

    The window's C = k+1 fed tokens (tokens [B, C] at positions [t0, t0 +
    C), t0 [B]) attend over the *committed* entry prefix of each slot (the
    entries below ``fill`` [B]: the engine passes the pre-draft fill, so
    the draft loop's tentative entries are invisible) plus the window's
    own KV.  The reference attends in jnp over the gathered stream with
    explicit key positions; here the committed prefix is restored into a
    staging cache ([B, cap, Hkv, dh] per layer, ``views_from_pages_batch``:
    exact as a set of keys, since layer 0 is always fresh, so each
    committed position has exactly one admitted entry at every layer;
    quantized pages dequantized) and the window runs through the chunk
    path over it (``transformer.stack_verify_paged``), whose attention is
    the flash kernel.  ``cap`` (default max(t0) + C, one host read) must
    cover every slot's t0 + C.  Nothing is committed: each layer's window
    views come back in ``stats['kv_token']`` ([L, B, C, Hkv, dh] each) for
    ``commit_verified``.  Returns (logits [B, C, V], stats with
    ``attn_gate`` [L, B, C])."""
    transformer.check_supported(cfg)
    if not paged_mod.can_page(cfg):
        raise ValueError(f"{cfg.name}: not a pageable stack")
    B, C = tokens.shape
    dev = tokens.device
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=dev)
    t0 = t0.reshape(-1).expand(B).contiguous()
    if cap is None:
        cap = int(t0.max()) + C
    kv_dtype = paged_mod.infer_kv_dtype(store, cfg)
    k_views, v_views = paged_mod.views_from_pages_batch(
        store, block_table.to(device=dev, dtype=torch.int32), fill, cfg,
        cap, kv_dtype=kv_dtype)
    dt = layers.torch_dtype(cfg)
    stage = [{"k": k_views[a].to(dt), "v": v_views[a].to(dt)}
             for a in range(k_views.shape[0])]
    del k_views, v_views
    pos = t0[:, None] + torch.arange(C, dtype=torch.int32, device=dev)[None]
    x = layers.embed(params["embed"], tokens)
    x, kv_token, stats, sq = transformer.stack_verify_paged(
        params["blocks"], stage, x, t0, pos, cfg)
    del stage
    stats["kv_token"] = kv_token
    x = layers.norm_apply(params["final_norm"], x, cfg, stats=sq)
    logits = layers.unembed(params["embed"], params.get("lm_head"), x, cfg)
    return logits, stats


def commit_verified(store: Dict, buf_k: torch.Tensor, buf_v: torch.Tensor,
                    gates: torch.Tensor, t0: torch.Tensor,
                    block_table: torch.Tensor, fill0: torch.Tensor,
                    committed: torch.Tensor, active: torch.Tensor,
                    cfg: ModelConfig) -> Tuple[Dict, torch.Tensor]:
    """Post-acceptance paged commit: rewrite the entry stream from the
    pre-draft ``fill0`` with the *verifier's* KV for exactly the leading
    ``committed`` columns of the window (per slot), column by column in
    the token-major order a never-speculated engine appends
    (``paged.commit_decode`` once per column), so the committed stream is
    the plain engine's and every tentative draft entry at or above the
    new fill is dead (masked by the fill at read time, overwritten by the
    next window's draft).

    buf_k/buf_v: [L, S, C, Hkv, dh] (``paged_verify_chunk``'s views);
    gates: [L, S, C]; t0/fill0/committed: [S]; ``active`` [S] masks slots
    outside the window.  The store is written IN PLACE.  Returns (store,
    the per-slot fill after the commit)."""
    reuse = paged_mod.reuse_enabled(cfg)
    dev = gates.device
    kv_dtype = paged_mod.infer_kv_dtype(store, cfg)
    block_table = block_table.to(device=dev, dtype=torch.int32)
    fill = fill0.to(device=dev, dtype=torch.int32).clone()
    committed = committed.to(device=dev, dtype=torch.int32)
    active = active.to(device=dev, dtype=torch.bool)
    t0 = t0.to(device=dev, dtype=torch.int32)
    for j in range(gates.shape[-1]):
        g = gates[..., j]
        mask = active & (j < committed)
        paged_mod.commit_decode(store, buf_k[:, :, j], buf_v[:, :, j], g,
                                t0 + j, block_table, fill, mask, cfg,
                                kv_dtype=kv_dtype)
        n_fresh = history.fresh_mask(g, reuse).to(torch.int32).sum(
            0, dtype=torch.int32)
        fill = fill + torch.where(mask, n_fresh, 0)
    return store, fill


# ---------------------------------------------------------------------------
# nn.Module owner
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """Registers a nested dict/list of tensors as frozen parameters whose
    names are the dict paths ("blocks.3.mixer.router.w")."""

    def __init__(self, tree):
        super().__init__()
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, torch.Tensor):
                self.register_parameter(str(k), nn.Parameter(
                    v, requires_grad=False))
            else:
                self.add_module(str(k), _Tree(v))

    def as_tree(self, like):
        items = like.items() if isinstance(like, dict) else enumerate(like)
        out = {k: (getattr(self, str(k)) if isinstance(v, torch.Tensor)
                   else getattr(self, str(k)).as_tree(v)) for k, v in items}
        return out if isinstance(like, dict) else [out[i]
                                                    for i in range(len(like))]


class LanguageModel(nn.Module):
    """The model's parameters plus its inference entry points.

    ``params`` (a nested dict, e.g. from ``bridge.from_reference``) is moved
    to ``device``; without it ``init_params`` draws them there from a
    ``torch.Generator`` seeded with ``seed`` (``int4``: quantized layer by
    layer as drawn).  ``device`` defaults to ``cuda`` and raises where CUDA
    is missing."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 device="cuda", seed: int = 0, int4: bool = False):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen, self.device, int4=int4)
        else:
            params = _to_device(params, self.device)
        self._layout = params
        self.tree = _Tree(params)

    def params(self) -> Dict:
        """The parameters as the nested dict the layer functions take."""
        return self.tree.as_tree(self._layout)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, pad_to: Optional[int] = None,
                last_index=None):
        return prefill(self.params(), tokens.to(self.device), self.cfg,
                       pad_to=pad_to, last_index=last_index)

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens: torch.Tensor, t0,
                      last_index=None):
        return prefill_chunk(self.params(), cache, tokens.to(self.device),
                             t0, self.cfg, last_index=last_index)

    @torch.no_grad()
    def verify_chunk(self, cache, tokens: torch.Tensor, t0):
        return verify_chunk(self.params(), cache, tokens.to(self.device),
                            t0, self.cfg)

    @torch.no_grad()
    def paged_verify_chunk(self, store, tokens: torch.Tensor, t0,
                           block_table, fill, cap=None):
        return paged_verify_chunk(self.params(), store,
                                  tokens.to(self.device), t0, block_table,
                                  fill, self.cfg, cap=cap)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, t):
        return decode_step(self.params(), cache, tokens.to(self.device), t,
                           self.cfg)

    @torch.no_grad()
    def paged_decode_step(self, store, tokens: torch.Tensor, t,
                          block_table, fill, commit_mask=None):
        return paged_decode_step(self.params(), store,
                                 tokens.to(self.device), t, block_table,
                                 fill, self.cfg, commit_mask=commit_mask)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
