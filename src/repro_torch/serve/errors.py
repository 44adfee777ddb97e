"""Typed error hierarchy for the serving engines (a copy of the JAX
package's ``serve/errors.py``, which cannot be imported without JAX: its
package ``__init__`` imports the engine).

SkipOPU's dynamically allocated computation makes resource demand
unpredictable at serve time — page consumption depends on per-token
routing decisions — so admission rejection, OOM backpressure and
preemption are *normal-path* scheduling events in this engine, not rare
errors.  This module gives each of them a type a caller can catch and
act on.

The hierarchy deliberately double-inherits from the builtin types the
old raises used (``AdmissionRejected`` is-a ``ValueError``,
``PageExhausted``/``EngineAborted`` are-a ``RuntimeError``), so callers
written against the old contract keep working while new callers can
catch the precise class.

    ServeError(Exception)
    ├── ConfigError(ServeError, ValueError)         bad EngineConfig field
    ├── AdmissionRejected(ServeError, ValueError)   submit() refused
    ├── PageExhausted(ServeError, RuntimeError)     paged KV out of memory
    ├── DeadlineExceeded(ServeError, TimeoutError)  per-request deadline hit
    └── EngineAborted(ServeError, RuntimeError)     run() cannot continue
        ├── HungDispatch                            watchdog fired
        └── SimulatedKill                           fault-injected host kill
"""
from __future__ import annotations

from typing import Optional


class ServeError(Exception):
    """Base class of every serving-layer error."""


class ConfigError(ServeError, ValueError):
    """An ``EngineConfig`` (or legacy engine kwarg) is invalid — out of
    range, or a combination the engine cannot serve (e.g. ``spec_k`` with
    ``decode_steps > 1``, paged-only levers under ``kv_mode='dense'``).
    Raised at construction time, before any device work.  Is-a
    ``ValueError`` because these conditions raised bare ``ValueError``
    before the config redesign."""


class AdmissionRejected(ServeError, ValueError):
    """``submit()`` refused the request — it can never be served (prompt
    too long for the pool, worst-case KV exceeding the page pool) or the
    engine is shedding load (queue-delay bound exceeded).  The request
    was NOT enqueued; the caller owns retry/redirect policy.

    ``reason`` is a stable machine-readable tag: ``"prompt_too_long"``,
    ``"kv_worst_case"``, ``"queue_depth"``, ``"queue_delay"``,
    ``"empty_prompt"``."""

    def __init__(self, message: str, reason: str = "rejected",
                 uid: Optional[int] = None):
        super().__init__(message)
        self.reason = reason
        self.uid = uid


class PageExhausted(ServeError, RuntimeError):
    """The paged KV free list cannot cover a required reservation and no
    recovery path (epoch shrink, preemption) remains — e.g. a single
    resident's own growth exceeds the pool, which OOM-safe admission
    should have made impossible.  Carries the allocator geometry for
    diagnosis."""

    def __init__(self, message: str, slot: Optional[int] = None,
                 free_pages: Optional[int] = None,
                 pages_total: Optional[int] = None):
        super().__init__(message)
        self.slot = slot
        self.free_pages = free_pages
        self.pages_total = pages_total


class DeadlineExceeded(ServeError, TimeoutError):
    """A request's deadline elapsed.  The engine normally *returns* this
    condition as ``RequestResult.finish_reason == "deadline"`` rather
    than raising; the exception type exists for callers that poll or
    cancel synchronously."""

    def __init__(self, message: str, uid: Optional[int] = None,
                 elapsed_s: float = 0.0, deadline_s: float = 0.0):
        super().__init__(message)
        self.uid = uid
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s


class EngineAborted(ServeError, RuntimeError):
    """``run()`` cannot make further progress and is tearing down.  The
    trace (if tracing was on and had an output path) is flushed before
    the raise and its path attached, so the failure is diagnosable
    post-mortem with ``tools/trace_summary.py``."""

    def __init__(self, message: str, trace_path: Optional[str] = None):
        super().__init__(message)
        self.trace_path = trace_path


class HungDispatch(EngineAborted):
    """The watchdog declared a device dispatch hung: one sync exceeded
    the hard timeout (``watchdog_s``).  Carries the phase and the
    observed wall time."""

    def __init__(self, message: str, phase: str = "dispatch",
                 elapsed_s: float = 0.0,
                 trace_path: Optional[str] = None):
        super().__init__(message, trace_path=trace_path)
        self.phase = phase
        self.elapsed_s = elapsed_s


class SimulatedKill(EngineAborted):
    """Fault-injected host death at a step boundary (``FaultPlan`` kind
    ``"kill"``).  Raised *after* the boundary snapshot, so a
    kill-and-resume test (or a real restart) loses nothing — see
    ``serve/snapshot.py`` and docs/robustness.md."""
