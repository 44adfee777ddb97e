"""Metrics registry: labeled counters / gauges / histograms / series (a
copy of the JAX package's ``obs/metrics.py``, which is pure Python: the
port imports nothing of that package).

The continuous engine keeps one ``MetricsRegistry`` per ``run()`` as the
single source of truth for run accounting — ``ServeStats`` is a *derived
view* over it (``serve/engine.py::_finalize`` reads every counter field
out of the registry), so the flat stats dataclass keeps its meaning while
the registry adds what a flat aggregate cannot hold:

* **labeled series** — e.g. per-attention-layer keep rate
  (``attn_keep_rate{layer=i}``) and history hit rate;
* **histograms** — TTFT / TPOT / decode-stall / step-wall distributions,
  not just means;
* **time series** — keep rate and measured KV-saved fraction sampled per
  engine step, so routing/KV behaviour is visible *over* a run instead
  of as one end-of-run scalar.

Every ``*_seconds`` value is host wall time (``time.perf_counter``); on
CUDA a dispatch's time is its enqueue and a sync's the wait for the work
queued before it.

Zero dependencies.  Snapshots export as JSON (``snapshot()``) and
Prometheus text exposition format (``to_prometheus()``; series are a
JSON-only concept — Prometheus scrapes would sample them as gauges).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

# default histogram buckets: wall-second scales from 10us to ~2min
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
    0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 120.0)

_KINDS = ("counter", "gauge", "histogram", "series")


def _label_key(labels: Dict[str, object]) -> str:
    """Canonical string key for a label set ('' = unlabeled)."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "buckets": {("+Inf" if i == len(self.bounds)
                             else repr(self.bounds[i])): c
                            for i, c in enumerate(self.counts)}}


class _Family:
    """One metric name: kind + help string + per-label-set children."""

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: Dict[str, object] = {}


class MetricsRegistry:
    """Flat-API registry (``inc`` / ``set`` / ``observe`` / ``record``).

    A metric's kind is fixed by its first use; reusing a name with a
    different kind raises (catches double-bookkeeping bugs early)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help)
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} is a {fam.kind}, not {kind}")
        if help and not fam.help:
            fam.help = help
        return fam

    # -- write API ---------------------------------------------------------
    def inc(self, name: str, v: float = 1.0, help: str = "",
            **labels) -> None:
        """Counter: monotonically accumulating value."""
        fam = self._family(name, "counter", help)
        k = _label_key(labels)
        fam.children[k] = fam.children.get(k, 0.0) + v

    def set(self, name: str, v: float, help: str = "", **labels) -> None:
        """Gauge: last-written value (the peak is tracked alongside and
        exported as ``<name>.max`` in snapshots)."""
        fam = self._family(name, "gauge", help)
        k = _label_key(labels)
        prev = fam.children.get(k)
        peak = v if prev is None else max(prev[1], v)
        fam.children[k] = (v, peak)

    def observe(self, name: str, v: float, help: str = "",
                buckets: Sequence[float] = DEFAULT_BUCKETS,
                **labels) -> None:
        """Histogram sample."""
        fam = self._family(name, "histogram", help)
        k = _label_key(labels)
        h = fam.children.get(k)
        if h is None:
            h = fam.children[k] = Histogram(buckets)
        h.observe(v)

    def record(self, name: str, x: float, v: float, help: str = "",
               **labels) -> None:
        """Time-series point (x = engine step index or wall seconds)."""
        fam = self._family(name, "series", help)
        k = _label_key(labels)
        fam.children.setdefault(k, []).append((float(x), float(v)))

    # -- read API ----------------------------------------------------------
    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Counter total / gauge last value for one label set."""
        fam = self._families.get(name)
        if fam is None:
            return default
        child = fam.children.get(_label_key(labels))
        if child is None:
            return default
        if fam.kind == "gauge":
            return child[0]
        if fam.kind == "counter":
            return child
        raise ValueError(f"value() on {fam.kind} metric {name!r}")

    def peak(self, name: str, default: float = 0.0, **labels) -> float:
        fam = self._families.get(name)
        if fam is None or fam.kind != "gauge":
            return default
        child = fam.children.get(_label_key(labels))
        return default if child is None else child[1]

    def histogram(self, name: str, **labels) -> Optional[Histogram]:
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam.children.get(_label_key(labels))

    def series(self, name: str, **labels) -> List[Tuple[float, float]]:
        fam = self._families.get(name)
        if fam is None:
            return []
        return list(fam.children.get(_label_key(labels), []))

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric, grouped by kind."""
        out: dict = {k + "s": {} for k in _KINDS}
        for fam in self._families.values():
            dst = out[fam.kind + "s"]
            if fam.kind == "counter":
                dst[fam.name] = dict(fam.children)
            elif fam.kind == "gauge":
                dst[fam.name] = {k: {"value": v, "max": p}
                                 for k, (v, p) in fam.children.items()}
            elif fam.kind == "histogram":
                dst[fam.name] = {k: h.to_dict()
                                 for k, h in fam.children.items()}
            else:
                dst[fam.name] = {k: [list(p) for p in pts]
                                 for k, pts in fam.children.items()}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (series exported as gauges
        at their last sample)."""
        lines: List[str] = []
        for fam in sorted(self._families.values(), key=lambda f: f.name):
            ptype = "gauge" if fam.kind == "series" else fam.kind
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {ptype}")
            for k in sorted(fam.children):
                child = fam.children[k]
                lab = "{%s}" % ",".join(
                    f'{p.split("=", 1)[0]}="{p.split("=", 1)[1]}"'
                    for p in k.split(",")) if k else ""
                if fam.kind == "counter":
                    lines.append(f"{fam.name}{lab} {child:g}")
                elif fam.kind == "gauge":
                    lines.append(f"{fam.name}{lab} {child[0]:g}")
                elif fam.kind == "series":
                    last = child[-1][1] if child else 0.0
                    lines.append(f"{fam.name}{lab} {last:g}")
                else:                                  # histogram
                    run = 0
                    for i, c in enumerate(child.counts):
                        run += c
                        le = ("+Inf" if i == len(child.bounds)
                              else f"{child.bounds[i]:g}")
                        extra = f',le="{le}"' if k else f'le="{le}"'
                        plab = ("{%s%s}" % (
                            lab[1:-1], extra) if k else "{%s}" % extra)
                        lines.append(f"{fam.name}_bucket{plab} {run}")
                    lines.append(f"{fam.name}_sum{lab} {child.sum:g}")
                    lines.append(f"{fam.name}_count{lab} {child.count}")
        return "\n".join(lines) + "\n"
