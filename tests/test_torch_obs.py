"""The port's observability layer on the CPU against the JAX package.

``repro_torch.obs`` (``MetricsRegistry``, ``Tracer``, ``NullTracer``,
``as_tracer``) replayed on the same call sequences as the reference's
``repro.obs``: values, peaks, histograms, series, snapshots and the
Prometheus text equal, kind conflicts and unbalanced spans raising alike,
and the traces' events equal with their timestamps left out.

Then the continuous engine beside the reference's on the same requests and
weights, in the dense pool and the paged store, single-step and 4-step
epochs, chunk 8, the prefix cache and ``spec_k`` 2 (dense and paged):
tokens and finish reasons equal, and the two runs' registries equal on
every count-valued metric — every counter and gauge, each histogram's
count, every series point (x exact, value to 1e-6).  Only the time-valued
metrics (``*_seconds*``) and ``compiles_total`` (CUDA graphs captured in
the port, XLA compiles in the reference) are left out.  Each run is traced:
``tools/trace_summary.py`` loads the saved file, every track's spans
balance, and each track's events — name, phase and arguments, in order —
equal the reference's, ``compile`` instants left out.  Tracing on gives
the port's tokens, statistics and launch counts of tracing off.

The smoke llama2-7b runs at fp32 with its routers redrawn at unit scale and
zero bias (``tests/test_torch_chunked.py``), so routing skips and no gate
sits at a near-tie.  The reference's engines run its jnp path
(``use_kernels=False``); each test builds a fresh reference engine (fresh
host state) that takes the compiled steps of the first one built at its
geometry, and hands it a ``jax.numpy`` whose ``asarray`` copies numpy
arrays (``tests/test_torch_decode_loop.py`` says why)."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import trace_summary  # noqa: E402

torch.set_num_threads(2)

SEED = 0
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=False)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
# the ServeStats fields both engines count (times and the port's own left
# out; compiles counts CUDA graphs in the port)
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "epoch_shrinks", "attn_keep_frac", "kv_saved_fraction",
         "kv_saved_analytic", "kv_mode", "page_size", "pages_total",
         "pages_peak", "preemptions", "kv_entries_stored",
         "kv_entries_dense", "history_hit_rate", "history_hits_per_layer",
         "prefix_hits", "prefix_misses", "prefix_tokens_saved",
         "prefix_records", "spec_windows", "spec_tokens_drafted",
         "spec_tokens_accepted", "spec_entries_rolled_back",
         "spec_acceptance_rate", "requests_cancelled", "deadline_exceeded",
         "requests_shed", "preempt_budget_exhausted")
# ContinuousBatchingEngine attributes holding compiled steps (the
# reference's): a fresh engine takes them from the first one at its geometry
JIT_ATTRS = ("_jitted", "_decode", "_prefill", "_sample_tok", "_dense_loops",
             "_paged_loops", "_spec_drafts", "_spec_verify_fn",
             "_spec_commit_fn", "_spec_vc_fn", "_insert", "_chunk_step",
             "_insert_staged", "_prefill_paged", "_pack", "_decode_paged",
             "_warm_cache", "_cow_copy", "_warm_chunk_step")
# engine levers read at run time only: not part of a compiled geometry
RUN_LEVERS = ("decode_steps", "trace", "max_queue_depth", "max_queue_delay_s",
              "max_preemptions")


class _CopyingNumpy:
    """``jax.numpy`` whose ``asarray`` copies a numpy array."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


@pytest.fixture(autouse=True)
def _reference_copies_host_arrays(monkeypatch):
    monkeypatch.setattr(jengine, "jnp", _CopyingNumpy())


def reference_world():
    """(the reference's jnp tree, the port's model) from seed-0 params,
    routers redrawn at unit scale with zero bias."""
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, ref), model


def reference_engines(params):
    """``make(**kw)``: a fresh reference engine (flat kwargs through
    ``EngineConfig``) holding the compiled steps of the first one built at
    the same geometry."""
    built = {}

    def make(**kw):
        eng = jengine.ContinuousBatchingEngine(
            JCFG, params, config=jconfig.EngineConfig.from_kwargs(**kw))
        key = tuple(sorted((k, v) for k, v in kw.items()
                           if k not in RUN_LEVERS))
        first = built.setdefault(key, eng)
        for name in JIT_ATTRS:
            if hasattr(first, name):
                setattr(eng, name, getattr(first, name))
        return eng

    return make


@pytest.fixture(scope="module")
def world():
    return reference_world()


@pytest.fixture(scope="module")
def ref_engine(world):
    return reference_engines(world[0])


# ---------------------------------------------------------------------------
# The registry and the tracer against the reference's
# ---------------------------------------------------------------------------

def _registry_script(mod):
    """Every write and read of the registry API, labeled and not, a kind
    conflict, the exports: the readings in order."""
    m = mod.MetricsRegistry()
    out = []
    m.inc("c", 2.0)
    m.inc("c", 3.0, help="a counter")
    m.inc("tok", 1, layer=0)
    m.inc("tok", 2, layer=1)
    out += [m.value("c"), m.value("tok", layer=0), m.value("tok", layer=1),
            m.value("tok"), m.value("missing", default=-1.0)]
    m.set("g", 7.0, help="a gauge")
    m.set("g", 4.0)
    m.set("g", 9.5, slot=3)
    out += [m.value("g"), m.peak("g"), m.peak("g", slot=3), m.peak("c")]
    for v in (1e-6, 0.001, 0.02, 5.0, 200.0):
        m.observe("h_seconds", v)
    m.observe("rate", 0.5, buckets=(0.25, 0.5, 0.75), layer=2)
    h = m.histogram("h_seconds")
    out += [h.count, h.sum, h.mean, list(h.counts), h.to_dict(),
            m.histogram("rate", layer=2).to_dict(), m.histogram("nope")]
    m.record("s", 0, 0.5, layer=1)
    m.record("s", 1, 0.25, layer=1)
    out += [m.series("s", layer=1), m.series("s", layer=2), m.series("x")]
    for bad in (lambda: m.set("c", 1.0), lambda: m.inc("g"),
                lambda: m.observe("s", 1.0), lambda: m.value("h_seconds")):
        with pytest.raises(ValueError):
            bad()
    snap = m.snapshot()
    out += [json.loads(json.dumps(snap)), m.to_prometheus()]
    return out


def test_registry_matches_reference():
    """``MetricsRegistry`` on one script (counters, gauges with their
    peaks, histograms on the default and on given buckets, labeled and
    unlabeled series, kind conflicts raising ``ValueError``) equals the
    reference's reading for reading, snapshot and Prometheus text
    included."""
    mine = _registry_script(tobs)
    theirs = _registry_script(jobs)
    assert mine == theirs
    assert 'h_seconds_bucket{le="+Inf"} 5' in mine[-1]
    assert mine[-2]["gauges"]["g"][""] == {"value": 4.0, "max": 7.0}


def _strip(events):
    """Events without their timestamps."""
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events]


def _tracer_script(mod, path):
    tr = mod.Tracer(path=path)
    tr.track(5, "req 4")
    tr.track(5, "again")                       # named once
    with tr.span("step", idx=0):
        with tr.span("plan"):
            tr.instant("admit", 5, slot=1)
        tr.begin("request", 5)
        tr.counter("sched", {"queue": 2, "resident": 1})
    tr.span_at("decode[0]", 5, 10.0, 5.0, tokens=1)
    tr.instant("finish", 5, reason="length", tokens=3)
    opened = tr.open_spans()
    tr.end(5)
    with pytest.raises(RuntimeError):
        tr.end(5)
    with tr.annotate("phase"):
        pass
    tr.save()
    spans = trace_summary.pair_spans(trace_summary.load_events(path))
    return (_strip(tr.events), opened, tr.open_spans(),
            {t: [(s["name"], s["depth"]) for s in v]
             for t, v in spans.items()})


def test_tracer_matches_reference(tmp_path):
    """``Tracer`` on one script (tracks, nested spans, an explicit-bounds
    span, instants, a counter, an unbalanced ``end`` raising, a saved file
    that ``trace_summary`` pairs) gives the reference's events, open spans
    and span depths; ``NullTracer`` records nothing, its ``annotate`` a
    no-op; ``as_tracer`` maps None, a tracer and a path alike."""
    mine = _tracer_script(tobs, tmp_path / "port.json")
    theirs = _tracer_script(jobs, tmp_path / "ref.json")
    assert mine == theirs
    assert mine[1] == {5: ["request"]} and mine[2] == {}
    for mod in (tobs, jobs):
        null = mod.as_tracer(None)
        assert isinstance(null, mod.NullTracer) and not null.enabled
        with null.span("x"):
            null.instant("y")
            null.begin("z")
            with null.annotate("w"):
                pass
        null.end()
        assert null.events == [] and null.open_spans() == {}
        assert (null.now_us(), null.to_us(5.0)) == (0.0, 0.0)
        tr = mod.Tracer()
        assert mod.as_tracer(tr) is tr
        with pytest.raises(ValueError):
            tr.save()
        by_path = mod.as_tracer(str(tmp_path / "p.json"))
        assert by_path.enabled and by_path.path == tmp_path / "p.json"
        assert mod.request_tid(4) == 5 and mod.ENGINE_TID == 0


def test_annotate_names_phases_in_a_profile():
    """The port's ``annotate`` is ``torch.profiler.record_function``: a
    ``torch.profiler`` session sees the phase name."""
    tr = tobs.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.annotate("decode_epoch"):
            torch.ones(4).sum()
    assert "decode_epoch" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# Engines against the reference's engines
# ---------------------------------------------------------------------------

TIMED = ("_seconds",)          # time-valued metric names contain this
UNCOMPARED = ("compiles_total",)


def count_view(m):
    """The count-valued part of a registry: {kind: {name: {labels:
    value}}} with time-valued metrics reduced to their presence (a
    histogram to its count) and ``compiles_total`` left out."""
    snap = m.snapshot()
    out = {}
    for kind, fams in snap.items():
        view = out[kind] = {}
        for name, children in fams.items():
            if name in UNCOMPARED:
                continue
            timed = any(t in name for t in TIMED)
            if kind == "histograms":
                view[name] = {k: (h["count"] if timed else h)
                              for k, h in children.items()}
            else:
                view[name] = None if timed else children
    return out


def assert_registries_match(mine, theirs):
    a, b = count_view(mine), count_view(theirs)
    assert a.keys() == b.keys()
    for kind in a:
        assert sorted(a[kind]) == sorted(b[kind]), kind
        for name in a[kind]:
            x, y = a[kind][name], b[kind][name]
            if kind == "series":
                assert x.keys() == y.keys(), name
                for k in x:
                    assert [p[0] for p in x[k]] == [p[0] for p in y[k]], name
                    np.testing.assert_allclose(
                        [p[1] for p in x[k]], [p[1] for p in y[k]],
                        rtol=0, atol=1e-6, err_msg=name)
            elif kind == "gauges":
                assert x.keys() == y.keys(), name
                for k in x:
                    np.testing.assert_allclose(
                        [x[k]["value"], x[k]["max"]],
                        [y[k]["value"], y[k]["max"]], rtol=0, atol=1e-9,
                        err_msg=name)
            else:
                assert x == y, name


def track_sequences(events):
    """Per track, the events in order without timestamps, ``compile``
    instants left out."""
    out = {}
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") == "compile":
            continue
        ev = {k: v for k, v in ev.items() if k != "ts"}
        out.setdefault(ev.get("tid", 0), []).append(ev)
    return out


def _script(n=6, seed=0, new=8, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, size=n)
    return [(rng.integers(0, CFG.vocab_size, (int(n),), dtype=np.int32),
             new) for n in lens]


def _shared(prefix_len, tails, seed, new=6):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, CFG.vocab_size, (prefix_len,), dtype=np.int32)
    return [(np.concatenate([head, rng.integers(0, CFG.vocab_size, (t,),
                                                dtype=np.int32)]), new)
            for t in tails]


def drive(eng, runs):
    """Each run: submit its (prompt, max_new_tokens) pairs, then ``run()``.
    Returns per run (tokens, finish reasons, stats, registry)."""
    out = []
    for reqs in runs:
        uids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        res = eng.run()
        out.append(([res["results"][u].tokens for u in uids],
                    [res["results"][u].finish_reason for u in uids],
                    res["stats"], res["metrics"]))
    return out


GEOM = dict(max_slots=3, max_len=48)
CONFIGS = {
    "dense": (dict(kv_mode="dense"), [_script()]),
    "dense_fused": (dict(kv_mode="dense", decode_steps=4), [_script()]),
    # 7 pages of 8 entries for three residents of up to 22 tokens at 2
    # layers: residents are preempted (5 times)
    "paged_tight": (dict(kv_mode="paged", page_size=8, num_pages=7),
                    [_script(new=12)]),
    "paged_fused": (dict(kv_mode="paged", page_size=8, decode_steps=4),
                    [_script()]),
    "paged_chunk8": (dict(kv_mode="paged", page_size=8, prefill_chunk=8),
                     [_script(seed=1, lo=4, hi=20)]),
    "dense_chunk8_fused": (dict(kv_mode="dense", prefill_chunk=8,
                                decode_steps=4),
                           [_script(n=4, seed=3, lo=9, hi=24)]),
    # a publishing run, then two warm admissions over its 24-token prefix
    "prefix": (dict(kv_mode="paged", page_size=8, prefix_cache=True,
                    prefix_block=8),
               [_shared(24, (4,), 7), _shared(24, (4, 6, 5), 7)[1:]]),
    "spec_dense": (dict(kv_mode="dense", spec_k=2), [_script()]),
    "spec_paged": (dict(kv_mode="paged", page_size=8, spec_k=2),
                   [_script()]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_registry_and_trace_match_reference(world, ref_engine,
                                                   tmp_path, name):
    """The port's engine and the reference's, traced, on the same runs:
    tokens and finish reasons equal; the registries equal on every
    count-valued metric; each saved trace loads in ``trace_summary``,
    balanced, no span left open, each track's events equal to the
    reference's.  Then the port untraced: the same tokens, statistics and
    launch counts; and ``ServeStats`` read out of the registry."""
    kw, runs = CONFIGS[name]
    kw = dict(GEOM, **kw)
    mine_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    mine = ContinuousBatchingEngine(world[1], trace=str(mine_path), **kw)
    theirs = ref_engine(trace=str(ref_path), **kw)
    ops.reset_kernel_launches()
    got = drive(mine, runs)
    launches = ops.kernel_launches()
    want = drive(theirs, runs)
    for (t, r, st, m), (jt, jr, jst, jm) in zip(got, want):
        for a, b in zip(t, jt):
            np.testing.assert_array_equal(a, b)
        assert r == jr
        for f in STATS:
            assert getattr(st, f) == getattr(jst, f), f
        assert_registries_match(m, jm)
        assert st.requests_completed == m.value("requests_completed_total")
    assert mine.metrics is got[-1][3]
    assert mine.tracer.open_spans() == {} == theirs.tracer.open_spans()
    events = trace_summary.load_events(str(mine_path))
    jevents = trace_summary.load_events(str(ref_path))
    trace_summary.pair_spans(events)                  # raises if unbalanced
    summary = trace_summary.summarize(events)
    assert summary["n_steps"] > 0
    assert summary["n_requests"] == sum(len(r) for r in runs)
    a, b = track_sequences(events), track_sequences(jevents)
    assert sorted(a) == sorted(b)
    for tid in a:
        assert a[tid] == b[tid], tid
    names = {ev["name"] for ev in events}
    if name.startswith("spec"):
        assert {"draft", "verify", "accept"} <= names
    if name == "prefix":
        assert {"prefix_hit", "warm_restore"} <= names
    if name == "paged_tight":
        assert "preempt" in names and got[0][2].preemptions > 0
    # tracing off: the same tokens, statistics and launch counts
    plain = ContinuousBatchingEngine(world[1], **kw)
    assert isinstance(plain.tracer, tobs.NullTracer)
    ops.reset_kernel_launches()
    off = drive(plain, runs)
    assert ops.kernel_launches() == launches
    for (t, r, st, m), (ot, orr, ost, om) in zip(got, off):
        for x, y in zip(t, ot):
            np.testing.assert_array_equal(x, y)
        assert r == orr
        for f in STATS:
            assert getattr(st, f) == getattr(ost, f), f
        assert count_view(m) == count_view(om)
