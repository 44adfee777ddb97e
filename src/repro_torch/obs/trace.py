"""Zero-dependency span tracer emitting Chrome trace-event JSON (after the
JAX package's ``obs/trace.py``).

The continuous engine records two families of spans into one timeline
(loadable in Perfetto / ``chrome://tracing``; ``tools/trace_summary.py``
summarizes it):

* **engine track** (tid 0): one ``step`` span per run-loop iteration with
  ``plan`` / ``headroom`` / ``prefill`` / ``dispatch`` / ``sync`` /
  ``bookkeep`` children (``draft`` / ``verify`` / ``rollback`` in
  speculation) — the host-side phase breakdown of every engine
  iteration — plus the ``sched`` counter row (queue depth, resident
  slots, free pages) and ``compile`` instants whenever a CUDA graph was
  captured.
* **request tracks** (tid = 1 + uid): the per-request lifecycle
  ``request ⊃ queued → prefill[chunk i] → decode[epoch j] → finish``,
  with ``submit`` / ``admit`` / ``preempt`` / ``prefix_hit`` / ``accept``
  instants and ``cow_copy`` / ``warm_restore`` spans of warm admissions.

Every span is host time (``time.perf_counter``).  On CUDA the work is
enqueued asynchronously: a ``dispatch`` span is the host's enqueue, a
``sync`` span the wait for everything queued before it (a chunk that is
not its prompt's last is only enqueued, and its device time lands in the
next sync).

Spans are emitted as matched ``"B"``/``"E"`` duration events; counters
are ``"C"`` events and instants ``"i"``.  Timestamps are microseconds of
``time.perf_counter`` since tracer creation.

``NullTracer`` is the always-off twin the engine holds by default: the
same API as no-op methods, so the run loops trace unconditionally and pay
only a method call when tracing is off.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
from time import perf_counter
from typing import Dict, List, Optional, Union

import torch

ENGINE_TID = 0          # the engine run-loop track
_PID = 1                # single logical process


def request_tid(uid: int) -> int:
    """Track id for request ``uid`` (engine track is tid 0)."""
    return 1 + uid


class Tracer:
    """Chrome-trace-event span recorder (see module docstring).

    ``path``: optional default output file — ``ContinuousBatchingEngine``
    saves there at the end of every ``run()`` when the tracer was built
    from a path.
    """

    enabled: bool = True

    def __init__(self, path: Optional[Union[str, pathlib.Path]] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._t0 = perf_counter()
        self.events: List[dict] = []
        self._open: Dict[int, List[str]] = {}     # tid -> open span names
        self._named: set = set()                  # tids with thread_name set
        self._event({"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
                     "args": {"name": "skipopu-serve"}})
        self.track(ENGINE_TID, "engine")

    # -- primitives --------------------------------------------------------
    def now_us(self) -> float:
        return (perf_counter() - self._t0) * 1e6

    def to_us(self, t: float) -> float:
        """Convert a raw ``perf_counter()`` reading to trace microseconds
        (for ``span_at`` bounds captured outside the tracer)."""
        return (t - self._t0) * 1e6

    def _event(self, ev: dict) -> None:
        self.events.append(ev)

    def track(self, tid: int, name: str) -> None:
        """Name a track once (``thread_name`` metadata event)."""
        if tid in self._named:
            return
        self._named.add(tid)
        self._event({"name": "thread_name", "ph": "M", "pid": _PID,
                     "tid": tid, "args": {"name": name}})

    def begin(self, name: str, tid: int = ENGINE_TID,
              ts: Optional[float] = None, **args) -> None:
        self._open.setdefault(tid, []).append(name)
        ev = {"name": name, "ph": "B", "pid": _PID, "tid": tid,
              "ts": self.now_us() if ts is None else ts}
        if args:
            ev["args"] = args
        self._event(ev)

    def end(self, tid: int = ENGINE_TID, ts: Optional[float] = None,
            **args) -> None:
        stack = self._open.get(tid)
        if not stack:
            raise RuntimeError(f"Tracer.end on tid {tid} with no open span")
        name = stack.pop()
        ev = {"name": name, "ph": "E", "pid": _PID, "tid": tid,
              "ts": self.now_us() if ts is None else ts}
        if args:
            ev["args"] = args
        self._event(ev)

    @contextlib.contextmanager
    def span(self, name: str, tid: int = ENGINE_TID, **args):
        self.begin(name, tid, **args)
        try:
            yield
        finally:
            self.end(tid)

    def span_at(self, name: str, tid: int, t0_us: float, t1_us: float,
                **args) -> None:
        """A span with explicit bounds, emitted after the fact (per-request
        decode steps, whose extent is only known at the sync)."""
        self.begin(name, tid, ts=t0_us, **args)
        self.end(tid, ts=max(t1_us, t0_us))

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "pid": _PID, "tid": tid,
              "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._event(ev)

    def counter(self, name: str, values: Dict[str, float],
                tid: int = ENGINE_TID) -> None:
        self._event({"name": name, "ph": "C", "pid": _PID, "tid": tid,
                     "ts": self.now_us(), "args": dict(values)})

    def annotate(self, name: str):
        """Context wrapping host work in ``torch.profiler.record_function``,
        so a ``torch.profiler`` trace carries the engine's phase names
        around the kernels.  Never open one inside a CUDA graph capture:
        the engine annotates eager work and ``graph.replay()`` only."""
        return torch.profiler.record_function(name)

    # -- output ------------------------------------------------------------
    def open_spans(self) -> Dict[int, List[str]]:
        """Unclosed spans per tid (should be empty after a drained run)."""
        return {tid: list(s) for tid, s in self._open.items() if s}

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: Optional[Union[str, pathlib.Path]] = None) -> None:
        out = pathlib.Path(path) if path is not None else self.path
        if out is None:
            raise ValueError("no output path (pass one or build "
                             "Tracer(path=...))")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(self.to_json()))


class NullTracer(Tracer):
    """The off switch: same API, records nothing, ``annotate`` is a no-op
    context.  The engine holds one of these unless ``trace=`` was passed,
    so tracing calls stay on the hot path unconditionally."""

    enabled = False

    def __init__(self):                                # no event buffer
        self.path = None
        self.events = []
        self._open = {}

    def track(self, tid, name):
        pass

    def begin(self, name, tid=ENGINE_TID, ts=None, **args):
        pass

    def end(self, tid=ENGINE_TID, ts=None, **args):
        pass

    @contextlib.contextmanager
    def span(self, name, tid=ENGINE_TID, **args):
        yield

    def span_at(self, name, tid, t0_us, t1_us, **args):
        pass

    def instant(self, name, tid=ENGINE_TID, **args):
        pass

    def counter(self, name, values, tid=ENGINE_TID):
        pass

    def annotate(self, name):
        return contextlib.nullcontext()

    def now_us(self) -> float:
        return 0.0

    def to_us(self, t: float) -> float:
        return 0.0


def as_tracer(trace) -> Tracer:
    """Normalize the engine's ``trace=`` argument: ``None`` -> NullTracer,
    a Tracer -> itself, a str/Path -> Tracer saving there after runs."""
    if trace is None:
        return NullTracer()
    if isinstance(trace, Tracer):
        return trace
    return Tracer(path=trace)


def graphs_captured(epochs) -> int:
    """CUDA graphs captured so far across ``DecodeEpoch`` objects (0 on the
    CPU, where an epoch runs eagerly).  The engine polls the delta per
    iteration to surface captures — a new block-table width, the first
    epoch of a run — as a counter + trace instants (the reference's
    compile probe counts XLA compiles instead)."""
    return sum(ep.captures for ep in epochs)
