"""Deterministic fault injection + dispatch watchdog for the serve engine
(after the JAX package's ``serve/faults.py``, which cannot be imported
without JAX).

Every recovery path the engine claims — OOM-safe preemption, dispatch
retry, hung-dispatch detection, kill-and-resume — is exercised by tests
through this module instead of hoped-for.  A ``FaultPlan`` schedules
faults by (kind, engine iteration) and the engine consults it at its
existing seams in all six run loops:

  ====================  =====================================================
  kind                  seam and recovery contract
  ====================  =====================================================
  ``"oom"``             headroom/admission seam (paged): ``pages`` free pages
                        are hidden from the allocator for that iteration, so
                        ``ensure()`` fails exactly as if residents had filled
                        the pool → the engine's normal backpressure runs
                        (epoch shrink, then youngest-by-submit preemption).
                        Pages are returned at the end of the iteration.
  ``"dispatch_error"``  dispatch seam: ``FaultInjected`` raised *before*
                        anything of the step, epoch or window is enqueued
                        (pool and store untouched) → the loop abandons the
                        iteration, counts it, and re-plans; no token is
                        lost, survivors are bit-identical.
  ``"stall"``           sync seam: the host sleeps ``stall_s`` inside the
                        sync span, emulating a hung device dispatch → the
                        ``Watchdog`` observes the inflated sync and either
                        records a straggler strike or (past its hard
                        timeout) raises ``HungDispatch`` with the flushed
                        trace's path attached.
  ``"kill"``            step boundary, *after* the boundary snapshot:
                        ``SimulatedKill`` propagates out of ``run()``
                        uncaught, emulating process death.  A fresh engine
                        ``resume()``s from the snapshot directory and the
                        survivors' tokens are bit-identical.
  ====================  =====================================================

Faults fire exactly once (pop semantics); ``fired`` / ``unfired()``
expose what actually triggered so tests can assert the plan was
consumed.  Scheduling is by the engine's iteration counter
(``_RunState.disp_idx``), which is deterministic for a fixed workload —
no wall clock, no randomness.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from repro_torch.serve.errors import HungDispatch, ServeError


class FaultInjected(ServeError, RuntimeError):
    """The injected dispatch exception (kind ``"dispatch_error"``).
    Raised at the dispatch seam and caught by the run loop's retry path;
    escaping to the caller means the recovery path regressed."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    Fields:
      kind    — "oom" | "dispatch_error" | "stall" | "kill".
      step    — engine iteration (dispatch/epoch index) at which to fire.
      pages   — "oom": free pages to hide for that iteration (0 = all).
      stall_s — "stall": seconds the sync seam sleeps.
      message — carried into the raised exception / trace instant.
    """
    kind: str
    step: int
    pages: int = 0
    stall_s: float = 0.0
    message: str = "injected fault"

    KINDS = ("oom", "dispatch_error", "stall", "kill")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {self.KINDS})")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")


class FaultPlan:
    """A deterministic schedule of faults, consumed by the engine seams.

    ``take(kind, step)`` pops (at most one per call) a matching fault —
    a fault fires exactly once.  An empty plan (``FaultPlan()``) is inert
    and costs a dict lookup per seam, so the engine consults it
    unconditionally."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self._pending: List[Fault] = sorted(faults or [],
                                            key=lambda f: f.step)
        self.fired: List[Fault] = []

    def __bool__(self) -> bool:
        return bool(self._pending)

    def take(self, kind: str, step: int) -> Optional[Fault]:
        """Pop the first pending fault of ``kind`` scheduled at or before
        ``step`` (late seams still fire a fault whose exact iteration was
        skipped — e.g. an "oom" scheduled into an iteration that had no
        residents)."""
        for i, f in enumerate(self._pending):
            if f.kind == kind and f.step <= step:
                self.fired.append(self._pending.pop(i))
                return self.fired[-1]
            if f.step > step:
                break
        return None

    def unfired(self) -> List[Fault]:
        """Faults that never triggered (a test asserting full consumption
        catches seams that silently stopped consulting the plan)."""
        return list(self._pending)


def as_fault_plan(faults) -> FaultPlan:
    """Normalize the engine's ``faults=`` argument: None -> empty plan,
    a FaultPlan -> itself, an iterable of Fault -> a plan over it."""
    if faults is None:
        return FaultPlan()
    if isinstance(faults, FaultPlan):
        return faults
    return FaultPlan(list(faults))


def sleep_stall(seconds: float) -> None:
    """The injected stall (its own function so tests can monkeypatch the
    clock if they ever need a faster suite)."""
    time.sleep(seconds)


class Watchdog:
    """Hung-dispatch detection built on the ``StragglerMonitor`` idiom
    (the JAX package's ``train/fault_tolerance.py``): per-dispatch
    wall-time tracking against a trailing median, plus a *hard* timeout
    that converts a hung sync into a diagnosable ``HungDispatch`` failure.

    Two thresholds:
      * ``timeout_s`` — absolute bound on one dispatch+sync; exceeding it
        raises (after the engine flushes its trace, whose path rides on
        the exception).  ``None`` disables the hard bound.
      * ``factor`` × trailing median — a *strike* (recorded, surfaced as
        the ``watchdog_strikes_total`` counter and a ``watchdog`` trace
        instant), mirroring ``StragglerMonitor.observe``.  Needs
        ``min_samples`` observations before it judges, so cold-start
        compile steps don't count.
    """

    def __init__(self, timeout_s: Optional[float] = None,
                 factor: float = 10.0, window: int = 20,
                 min_samples: int = 5):
        self.timeout_s = timeout_s
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self._times: List[float] = []
        self.strikes = 0

    def observe(self, phase: str, seconds: float) -> bool:
        """Record one dispatch+sync wall time.  Returns True when it
        counts as a straggler strike; raises ``HungDispatch`` when it
        breaches the hard timeout."""
        if self.timeout_s is not None and seconds > self.timeout_s:
            raise HungDispatch(
                f"{phase} took {seconds:.3f}s, watchdog timeout is "
                f"{self.timeout_s:.3f}s — dispatch declared hung",
                phase=phase, elapsed_s=seconds)
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < self.min_samples:
            return False
        med = sorted(self._times[:-1])[len(self._times[:-1]) // 2]
        if seconds > self.factor * med:
            self.strikes += 1
            return True
        return False
