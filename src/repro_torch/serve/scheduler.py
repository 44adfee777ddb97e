"""Request scheduler for the continuous-batching serve engine (after the
JAX package's ``serve/scheduler.py``, which cannot be imported without
JAX).

The scheduler is the software realization of SkipOPU's dynamically
allocated compute: a fixed pool of KV-cache *slots* (the on-chip KV
history buffer analogue — ``max_slots × max_len`` arrays allocated once)
is multiplexed over an unbounded FIFO stream of requests.  A request is
*admitted* when a slot frees up, prefilled into its slot, decoded
interleaved with every other resident request (each at its own position
``t[slot]``), and *evicted* on stop-token / length, immediately releasing
the slot to the next queued request.

Prefill length-bucketing: prompts are right-padded to a small set of
bucket lengths, so the reference's jitted prefill compiles once per bucket
instead of once per prompt length (the port keeps the buckets, so its
prefill shapes are the reference's).  Bucketing is exact only for
masked-mode global-attention stacks — pads sit *after* the real tokens, so
causal masking keeps every real position byte-identical (``can_bucket``).
A Mamba stack's state would absorb the pads, so it prefills at the exact
prompt length (``buckets=None``).

Chunked prefill (``prefill_chunk > 0``): ``plan_step`` metes an admitted
prompt out ``prefill_chunk`` tokens at a time, one chunk per engine
iteration, so resident decode steps run between the chunks of a long
prompt; a ``token_budget`` may defer a chunk by one iteration, never two.
Chunking is exact on the same stacks as bucketing
(``can_chunk_prefill``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from time import perf_counter
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.serve.errors import AdmissionRejected


@dataclasses.dataclass
class Request:
    """One generation request.

    Fields:
      uid            — engine-assigned id; the key of the final
                       ``RequestResult`` in ``run()['results']``.
      tokens         — ``[T0]`` int32 prompt token ids.
      max_new_tokens — generation budget, *including* the first token
                       sampled from the prefill logits.
      stop_token     — optional token id that ends generation early (it
                       is still emitted as the last output token).
      submit_s       — ``perf_counter`` stamp set by ``Scheduler.submit``:
                       the request's *age* for preemption-victim ordering,
                       preserved across requeues, so a preempted request
                       never loses its FIFO seniority.
    """
    uid: int
    tokens: np.ndarray               # [T0] int32 prompt
    max_new_tokens: int
    stop_token: Optional[int] = None
    submit_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclasses.dataclass
class ActiveRequest:
    """Engine-side state of an admitted request."""
    req: Request
    slot: int
    pos: int                         # cache position the next token writes to
    next_token: int = 0              # token fed at ``pos`` next decode step
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    # measured compact-KV accounting (from the decode attn_gate log)
    kv_stored: int = 0               # per-layer entries actually written
    kv_dense: int = 0                # what a dense per-layer store would write
    submit_s: float = 0.0
    first_token_s: float = 0.0
    # time spent in decode steps this request participated in (other
    # requests' interleaved admission prefills excluded)
    decode_s: float = 0.0
    # decode-stall tracking: wall time of the longest gap between two
    # consecutive token emissions (what an eagerly scheduled monolithic
    # prefill of *another* request inflates)
    last_emit_s: float = 0.0
    max_stall_s: float = 0.0
    finish_reason: str = ""
    # prompt-phase execution-gate log ([L_attn, >=T0], device array or np)
    # captured at prefill completion so the measured KV-storage accounting
    # covers the *whole* request, prompt included; resolved lazily at
    # finish time — never a host sync on the hot path
    pf_gates: Optional[object] = None


def default_buckets(max_len: int, lo: int = 16) -> Tuple[int, ...]:
    """Powers of two from ``lo`` up to (and including) max_len."""
    out: List[int] = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def can_bucket(cfg: ModelConfig) -> bool:
    """Padding-exactness condition: right-padded prompts leave every real
    position unchanged only in an all-global-attention stack with
    masked-mode routing (pads would update an SSM state)."""
    all_global = all(k == ATTN for k in cfg.layer_pattern)
    gather = cfg.skip.enabled and cfg.skip.mode == "gather"
    return all_global and not gather


def can_chunk_prefill(cfg: ModelConfig) -> bool:
    """Chunk-exactness condition: the cached prefix must fully determine
    the next chunk's state, and a right-padded final chunk's pads must be
    inert.  Both hold exactly for the bucketable stacks (all global
    attention, masked-mode routing): the per-layer KV views are the whole
    cross-layer reuse state, and causal masking kills the pads.  An SSM
    scan carries state that cannot be split at an arbitrary offset."""
    return can_bucket(cfg)


@dataclasses.dataclass
class PrefillChunk:
    """One unit of prefill work handed to the engine by ``plan_step``.

    With chunking off this is the whole prompt (``is_first and is_last``);
    with ``prefill_chunk > 0`` it is one C-token slice (the final slice
    may be shorter: the engine right-pads it to C and takes the logits at
    its last real token)."""
    req: Request
    slot: int
    start: int                       # token offset of this chunk
    tokens: np.ndarray               # [c] real tokens (c <= prefill_chunk)
    is_first: bool
    is_last: bool


@dataclasses.dataclass
class StepPlan:
    """One engine iteration's worth of work: every resident decode slot
    plus at most one prefill chunk.

    ``decode_steps`` is the iteration's *epoch length*: with the fused
    device-resident decode loop (``decode_steps_per_dispatch > 1``) each
    resident slot decodes up to N tokens per dispatch, so one plan covers
    an N-step epoch and each decode slot costs N budget tokens."""
    decode_slots: List[int]
    prefill: Optional[PrefillChunk]
    decode_steps: int = 1

    @property
    def tokens(self) -> int:
        """Tokens this step computes (the planner's budget currency)."""
        n = len(self.decode_slots) * self.decode_steps
        return n + (len(self.prefill.tokens) if self.prefill else 0)


@dataclasses.dataclass
class _InflightPrefill:
    """Host-side progress of the one prompt currently being prefilled."""
    req: Request
    slot: int
    done: int = 0                    # tokens already prefilled
    deferred: int = 0                # consecutive budget deferrals


class Scheduler:
    """FIFO queue + slot free-list + prefill length-bucketing + the
    chunked-prefill step planner.

    The engine drives one iteration as: (paged-memory headroom pass) →
    ``plan_step()`` → run the returned prefill chunk, if any, and
    ``prefill_advance`` it (the last chunk activates the request) → one
    ragged decode step over the resident slots.  ``plan_step`` owns
    admission: it pops the FIFO head into a free slot, gated on the
    engine's ``can_place`` memory predicate, and then metes the prompt
    out one chunk per call.
    """

    def __init__(self, max_slots: int, max_len: int,
                 buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: int = 0):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = monolithic)")
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self.prefill_chunk = prefill_chunk
        self.queue: Deque[Request] = deque()
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self.active: Dict[int, ActiveRequest] = {}
        self._prefilling: Optional[_InflightPrefill] = None

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_len < 1:
            raise AdmissionRejected(f"request {req.uid}: empty prompt",
                                    reason="empty_prompt", uid=req.uid)
        if req.prompt_len + 1 > self.max_len:
            raise AdmissionRejected(
                f"request {req.uid}: prompt_len={req.prompt_len} leaves no "
                f"decode headroom within max_len={self.max_len}",
                reason="prompt_too_long", uid=req.uid)
        req.submit_s = perf_counter()
        self.queue.append(req)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        return bool(self.queue or self.active or self._prefilling)

    # -- step planning ------------------------------------------------------
    def plan_step(self, can_place=None,
                  token_budget: Optional[int] = None,
                  decode_steps: int = 1) -> StepPlan:
        """Plan one engine iteration.

        Admission: when no prefill is in flight, the FIFO head is popped
        into a free slot iff ``can_place(request)`` passes (the paged
        engine's free-page gate; FIFO order is preserved — a blocked head
        back-pressures the queue).  The in-flight prompt then yields one
        ``PrefillChunk`` per call (the whole prompt when chunking is off).

        ``token_budget`` caps the step's token count (decode slots each
        cost ``decode_steps``; the chunk costs its length).  An
        over-budget chunk is deferred — a decode-only step — but never
        twice in a row, and never when there is no decode work to
        prioritize, so prefill cannot starve.  A request whose last chunk
        ran joins the decode set on the next plan.

        N-step epochs (``decode_steps > 1``): one plan covers an epoch of
        up to ``decode_steps`` decode iterations in one device dispatch;
        the scheduler sees the world only at epoch boundaries, and a slot
        stays resident (its pages reserved) for the whole epoch even if it
        finishes mid-loop, where the device's active mask stops it from
        appending KV."""
        if self._prefilling is None and self.queue and self._free:
            if can_place is None or can_place(self.queue[0]):
                self._prefilling = _InflightPrefill(
                    req=self.queue.popleft(), slot=self._free.pop())
        decode_slots = sorted(self.active)
        chunk: Optional[PrefillChunk] = None
        if self._prefilling is not None:
            pf = self._prefilling
            T0 = pf.req.prompt_len
            C = self.prefill_chunk if self.prefill_chunk else T0
            c = min(C, T0 - pf.done)
            over = (token_budget is not None and decode_slots
                    and len(decode_slots) * decode_steps + c > token_budget)
            if over and pf.deferred < 1:
                pf.deferred += 1
            else:
                pf.deferred = 0
                toks = np.asarray(pf.req.tokens, np.int32)
                chunk = PrefillChunk(
                    req=pf.req, slot=pf.slot, start=pf.done,
                    tokens=toks[pf.done:pf.done + c],
                    is_first=pf.done == 0, is_last=pf.done + c >= T0)
        return StepPlan(decode_slots=decode_slots, prefill=chunk,
                        decode_steps=decode_steps)

    def prefill_advance(self, chunk: PrefillChunk) -> None:
        """Record that ``chunk`` ran; the in-flight state clears on the
        last chunk (the engine then activates the request)."""
        pf = self._prefilling
        assert pf is not None and pf.slot == chunk.slot, "no such prefill"
        pf.done += len(chunk.tokens)
        if pf.done >= pf.req.prompt_len:
            self._prefilling = None

    @property
    def prefilling(self) -> Optional[_InflightPrefill]:
        """The in-flight prefill, if any (a chunked prefill spans engine
        iterations; a monolithic one completes within its own)."""
        return self._prefilling

    def abort_prefill(self) -> _InflightPrefill:
        """Cancel the in-flight prefill: its slot returns to the free list
        and the request goes back into the FIFO at its age-ordered
        position, to re-prefill from scratch.  The paged engine uses this
        as OOM backpressure: the in-flight prompt is the newest admission
        and has no decode progress to lose.  (The reference's
        ``requeue=False``, cancellation, comes with ROADMAP item 12.)"""
        pf = self._prefilling
        assert pf is not None, "no prefill in flight"
        self._prefilling = None
        self._free.append(pf.slot)
        self.requeue(pf.req)
        return pf

    # -- admission / eviction ---------------------------------------------
    def admit(self, can_place=None,
              limit: Optional[int] = None) -> List[Tuple[int, Request]]:
        """Pop FIFO requests into free slots.  Returns [(slot, request)].

        ``can_place(request) -> bool``: optional admission predicate beyond
        slot availability — the paged KV engine passes its free-page check
        here, so admission is gated on *memory*, not just slots.  FIFO
        order is preserved: when the head of the queue cannot be placed,
        admission stops (backpressure) rather than skipping ahead.
        ``limit`` caps admissions per call (a stateful ``can_place`` that
        only reflects *committed* allocations needs limit=1 so each check
        sees the previous admission's consumption)."""
        admitted: List[Tuple[int, Request]] = []
        while self.queue and self._free:
            if limit is not None and len(admitted) >= limit:
                break
            if can_place is not None and not can_place(self.queue[0]):
                break
            slot = self._free.pop()
            admitted.append((slot, self.queue.popleft()))
        return admitted

    def requeue(self, req: Request) -> None:
        """Put a preempted request back into the queue at its
        *age-ordered* position: before every queued request submitted
        later, after every one submitted earlier.  The old behavior
        (append at head) inverted the order of two requests preempted in
        the same storm and — combined with victim selection by admission
        recency — let a single request be re-victimized forever while
        later arrivals ran to completion.  Ordering by the original
        ``submit_s`` (which requeue never touches) makes re-admission
        FIFO-fair: a thrice-preempted request still finishes before
        later arrivals."""
        for i, queued in enumerate(self.queue):
            if queued.submit_s > req.submit_s:
                self.queue.insert(i, req)
                return
        self.queue.append(req)

    def activate(self, state: ActiveRequest) -> None:
        self.active[state.slot] = state

    def release(self, slot: int) -> ActiveRequest:
        """Evict the request in ``slot`` and return the slot to the pool."""
        state = self.active.pop(slot)
        self._free.append(slot)
        return state

    # -- bucketing ---------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        """Padded prefill length for a prompt (identity when unbucketed)."""
        if self.buckets is None:
            return prompt_len
        for b in self.buckets:
            if b >= prompt_len:
                return min(b, self.max_len)
        return self.max_len

    def pad_prompt(self, tokens: np.ndarray) -> Tuple[np.ndarray, int]:
        """Right-pad to the bucket length.  Returns (padded [Tb], last_idx)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        T0 = tokens.shape[0]
        Tb = self.bucket_for(T0)
        if Tb > T0:
            tokens = np.pad(tokens, (0, Tb - T0))
        return tokens, T0 - 1
