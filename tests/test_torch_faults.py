"""The port's fault injection and watchdog on the CPU against the JAX
package: ``serve/faults.py`` (``FaultPlan``, ``Fault``, ``as_fault_plan``,
``Watchdog``) replayed on the same call scripts as the reference's, and the
continuous engine's fault seams in all six run loops — dense and paged,
single-step, 4-step epochs and ``spec_k`` 2 windows — beside the
reference's engine under the same ``FaultPlan``: two dispatch errors (the
iteration abandoned and planned again), a 0.01 s stall in the sync and,
in the paged loops, an OOM hiding every free page for one iteration.
Each case holds the two engines to the same tokens and finish reasons, the
same ``faults_injected``, ``dispatch_retries``, ``preemptions`` and
``epoch_shrinks``, the same count of every trace instant, every fault
fired, and nothing leaked (slots, pages, fills); the port's tokens also
equal its own clean run's.  A stall past the watchdog's hard timeout
raises ``HungDispatch`` carrying the flushed trace's path in each loop
kind.

The reference's workload (``tests/test_fault_tolerance.py``): prompts of
9, 16, 5 and 21 tokens, +6 tokens, 2 slots, ``max_len`` 48, pages of 8.
Weights and reference engines as in ``tests/test_torch_obs.py`` (fp32
smoke llama2-7b, routers redrawn at unit scale with zero bias, the
reference's jnp path shared by compiled geometry)."""
import numpy as np
import pytest
import torch

from repro.obs import Tracer as JTracer
from repro.serve import errors as jerrors
from repro.serve import faults as jfaults
from repro_torch.obs import Tracer
from repro_torch.serve import errors as terrors
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import ContinuousBatchingEngine
from test_torch_obs import (_reference_copies_host_arrays,  # noqa: F401
                            CFG, reference_engines, reference_world)

torch.set_num_threads(2)

WORKLOAD_LENS = [9, 16, 5, 21]
MAX_NEW = 6
GEOM = dict(max_slots=2, max_len=48)
PAGED = dict(kv_mode="paged", page_size=8)
LOOPS = {
    "dense": dict(kv_mode="dense"),
    "dense_fused": dict(kv_mode="dense", decode_steps=4),
    "dense_spec": dict(kv_mode="dense", spec_k=2),
    "paged": dict(PAGED),
    "paged_fused": dict(PAGED, decode_steps=4),
    "paged_spec": dict(PAGED, spec_k=2),
}
# iterations a fault is scheduled at: a fused epoch or a window covers
# several tokens, so those loops run fewer iterations
STEPS = {"dense": (2, 5), "paged": (2, 5)}
# iterations at which hiding every free page preempts a resident (paged;
# paged_fused, where an epoch halves first) or holds an admission back a
# few iterations (paged_spec: its window headroom never needs a victim
# on this workload)
OOM_STEP = {"paged": 9, "paged_fused": 4, "paged_spec": 2}
MATRIX = ([(loop, kind) for loop in LOOPS
           for kind in ("dispatch_error", "stall")]
          + [(loop, "oom") for loop in LOOPS if loop.startswith("paged")])


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, (n,), dtype=np.int32)
            for n in WORKLOAD_LENS]


def faults_for(mod, loop, kind):
    d, s = STEPS.get(loop, (1, 2))
    return {"dispatch_error": [mod.Fault("dispatch_error", step=d),
                               mod.Fault("dispatch_error", step=s)],
            "stall": [mod.Fault("stall", step=d, stall_s=0.01)],
            "oom": [mod.Fault("oom", step=OOM_STEP.get(loop, d),
                              pages=0)]}[kind]


@pytest.fixture(scope="module")
def world():
    return reference_world()


@pytest.fixture(scope="module")
def ref_engine(world):
    return reference_engines(world[0])


@pytest.fixture(scope="module")
def clean(world):
    """The port's clean run per loop (tokens), built once."""
    cache = {}

    def get(loop):
        if loop not in cache:
            eng = ContinuousBatchingEngine(world[1], **GEOM, **LOOPS[loop])
            cache[loop] = run(eng)[0]
        return cache[loop]
    return get


def run(eng, plan=None):
    """The workload on ``eng`` under ``plan``, traced: (tokens, reasons,
    stats, instant counts, the plan)."""
    if plan is not None:
        eng.faults = plan
    uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts()]
    out = eng.run()
    res = out["results"]
    counts = {}
    for e in eng.tracer.events:
        if e.get("ph") == "i" and e["name"] != "compile":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return ([res[u].tokens.tolist() for u in uids],
            [res[u].finish_reason for u in uids], out["stats"], counts,
            eng.faults)


def assert_no_leaks(eng):
    sched = eng.scheduler
    assert not sched.active and not sched.queue
    assert sched.prefilling is None
    assert sched.free_slots == eng.max_slots
    if eng.kv_mode == "paged":
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages
        assert (eng.allocator.fill == 0).all()


# ---------------------------------------------------------------------------
# FaultPlan / Watchdog: the same scripts in both packages
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:                         # noqa: BLE001
        return ("raise", type(e).__name__, str(e))


def _plan_script(mod):
    log = []
    plan = mod.FaultPlan([mod.Fault("oom", step=3, pages=2),
                          mod.Fault("oom", step=5),
                          mod.Fault("kill", step=4, message="m"),
                          mod.Fault("stall", step=1, stall_s=0.5)])

    def take(kind, step):
        f = plan.take(kind, step)
        return None if f is None else (f.kind, f.step, f.pages, f.stall_s,
                                       f.message)
    log.append(bool(plan))
    for kind, step in (("oom", 0), ("dispatch_error", 99), ("oom", 7),
                       ("oom", 4), ("stall", 0), ("stall", 9), ("oom", 5),
                       ("kill", 3), ("kill", 4), ("kill", 4)):
        log.append(take(kind, step))
    log.append([f.kind for f in plan.fired])
    log.append([f.kind for f in plan.unfired()])
    log.append(bool(plan))
    log.append(_outcome(lambda: mod.Fault("meteor", step=0)))
    log.append(_outcome(lambda: mod.Fault("oom", step=-1)))
    log.append(bool(mod.as_fault_plan(None)))
    p = mod.FaultPlan([mod.Fault("kill", 0)])
    log.append(mod.as_fault_plan(p) is p)
    log.append(mod.as_fault_plan([mod.Fault("kill", 0)]).take(
        "kill", 0).kind)
    log.append(mod.Fault.KINDS)
    return log


def _watchdog_script(mod, errors):
    log = []
    wd = mod.Watchdog(timeout_s=1.0, factor=4.0, window=8, min_samples=3)
    for s in (0.01, 0.01, 0.01, 0.01, 0.1, 0.012, 0.05, 0.3, 0.02):
        log.append(wd.observe("step", s))
    log.append(wd.strikes)
    try:
        wd.observe("decode_epoch", 1.5)
    except errors.HungDispatch as e:
        log.append((type(e).__name__, str(e), e.phase, e.elapsed_s,
                    e.trace_path, isinstance(e, errors.EngineAborted)))
    cold = mod.Watchdog(factor=2.0, min_samples=5)
    log.append([cold.observe("step", s) for s in (5.0, 0.01, 0.01, 0.01)])
    free = mod.Watchdog(window=3, min_samples=2)
    log.append([free.observe("w", s) for s in (1.0, 1.0, 20.0, 1.0, 1.0,
                                               1.0, 30.0)])
    log.append(free.strikes)
    return log


def test_fault_plan_script_matches_reference():
    assert _plan_script(tfaults) == _plan_script(jfaults)
    assert issubclass(tfaults.FaultInjected, terrors.ServeError)
    assert issubclass(tfaults.FaultInjected, RuntimeError)


def test_watchdog_script_matches_reference():
    assert (_watchdog_script(tfaults, terrors)
            == _watchdog_script(jfaults, jerrors))


# ---------------------------------------------------------------------------
# The matrix: six loops x each fault kind, beside the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop,kind", MATRIX,
                         ids=[f"{a}-{b}" for a, b in MATRIX])
def test_fault_matrix_matches_reference(world, ref_engine, clean, loop,
                                        kind):
    kw = dict(GEOM, **LOOPS[loop])
    mine_eng = ContinuousBatchingEngine(world[1], trace=Tracer(), **kw)
    ref_eng = ref_engine(trace=JTracer(), **kw)
    mine = run(mine_eng, tfaults.FaultPlan(faults_for(tfaults, loop, kind)))
    theirs = run(ref_eng, jfaults.FaultPlan(faults_for(jfaults, loop, kind)))
    for eng, got in ((mine_eng, mine), (ref_eng, theirs)):
        assert not got[4].unfired(), (loop, kind, got[4].unfired())
        assert_no_leaks(eng)
        assert got[1] == ["length"] * len(WORKLOAD_LENS)
    assert mine[:2] == theirs[:2]
    assert mine[0] == clean(loop)
    n = len(faults_for(tfaults, loop, kind))
    fields = ("faults_injected", "dispatch_retries", "preemptions",
              "epoch_shrinks")
    assert ([getattr(mine[2], f) for f in fields]
            == [getattr(theirs[2], f) for f in fields])
    assert mine[2].faults_injected == n == mine[3]["fault"]
    assert mine[2].dispatch_retries == (n if kind == "dispatch_error"
                                        else 0)
    assert mine[2].epoch_shrinks == mine[3].get("epoch_shrink", 0)
    if kind == "oom" and loop != "paged_spec":
        assert mine[2].preemptions >= 1
        assert mine[2].epoch_shrinks >= (loop == "paged_fused")
    assert mine[3] == theirs[3]


# ---------------------------------------------------------------------------
# The watchdog's hard timeout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop,phase", [("dense", "decode_step"),
                                        ("paged_fused", "decode_epoch"),
                                        ("dense_spec", "decode_window")])
def test_watchdog_hard_timeout_flushes_trace(world, tmp_path, loop, phase):
    path = tmp_path / "hung.json"
    eng = ContinuousBatchingEngine(
        world[1], trace=str(path), **GEOM, **LOOPS[loop],
        watchdog=tfaults.Watchdog(timeout_s=0.25),
        faults=[tfaults.Fault("stall", step=0, stall_s=0.5)])
    eng.submit(prompts()[0], max_new_tokens=4)
    with pytest.raises(terrors.HungDispatch, match="declared hung") as ei:
        eng.run()
    assert ei.value.phase == phase and ei.value.elapsed_s > 0.25
    assert ei.value.trace_path == str(path) and path.exists()
    assert eng.metrics.value("watchdog_timeouts_total") == 1
    assert [f.kind for f in eng.faults.fired] == ["stall"]
