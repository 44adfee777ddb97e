"""The port's continuous-batching engine on the CPU against the JAX
package's ``ContinuousBatchingEngine`` (``use_kernels=True``, Pallas in
interpret mode), on the same bridged weights and the same submit sequence:
per-request tokens and every shared statistic must be equal, in the dense
slot pool and in the paged §4.4 store.  Also: paged ≡ dense within the
port, tokens unchanged under page-pressure preemption, page conservation
after every run, admission rejection, the unported lever (a mesh or a
sharding policy) raising ``ConfigError`` while the robustness levers
(faults, the watchdog, snapshots) build, and temperature sampling held by
distribution.

Routers are redrawn at unit scale with zero bias so routing really skips
(fp32 smoke config)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve import sampling as jsampling
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LanguageModel
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.errors import AdmissionRejected, ConfigError
from repro_torch.serve.sampling import sample

torch.set_num_threads(2)

SEED = 0
JCFG = dataclasses.replace(jget_config("llama2-7b").smoke(), dtype="float32",
                           use_kernels=True)
CFG = dataclasses.replace(get_config("llama2-7b").smoke(), dtype="float32")
LENS = (9, 16, 5, 21)
GEOM = dict(max_slots=2, max_len=48)
STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "attn_keep_frac", "kv_saved_fraction", "kv_saved_analytic",
         "kv_mode", "page_size", "pages_total", "pages_peak", "preemptions",
         "kv_entries_stored", "kv_entries_dense", "history_hit_rate",
         "history_hits_per_layer")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(SEED)
    ref = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(SEED), JCFG))

    def fix(tree):
        for k, v in tree.items():
            if k == "router":
                v["w"] = rng.standard_normal(v["w"].shape).astype(np.float32)
                v["b"] = np.zeros_like(v["b"])
            elif isinstance(v, dict):
                fix(v)
    fix(ref)
    model = LanguageModel(CFG, bridge.from_reference(ref, CFG), device="cpu")
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in LENS]
    return ref, model, prompts


def _run(eng, prompts, new=5):
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    tokens = [out["results"][u].tokens for u in uids]
    if eng.kv_mode == "paged":
        eng.allocator.check_conservation()
        assert eng.allocator.free_pages == eng.num_pages
        assert (eng.allocator.fill == 0).all()
    return tokens, out


def _mode(kv_mode):
    return dict(GEOM, kv_mode=kv_mode,
                **({"page_size": 8} if kv_mode == "paged" else {}))


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_engine_matches_reference(world, kv_mode):
    ref, model, prompts = world
    jtoks, jout = _run(JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, ref),
                               **_mode(kv_mode)), prompts)
    toks, out = _run(ContinuousBatchingEngine(model, **_mode(kv_mode)),
                     prompts)
    for a, b in zip(toks, jtoks):
        np.testing.assert_array_equal(a, b)
    for name in STATS:
        assert getattr(out["stats"], name) == getattr(jout["stats"], name), \
            name
    for uid, r in out["results"].items():
        jr = jout["results"][uid]
        assert (r.finish_reason, r.kv_stored, r.kv_dense, r.prompt_len) == \
            (jr.finish_reason, jr.kv_stored, jr.kv_dense, jr.prompt_len)
    s = out["stats"]
    assert 0.0 < s.attn_keep_frac < 1.0
    if kv_mode == "paged":
        assert s.history_hit_rate > 0.0
        assert s.history_hits_per_layer[0] == 0.0       # dense base layer
        assert 0.0 < s.kv_entries_saved_fraction < 1.0
        assert 0 < s.pages_peak <= s.pages_total


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_paged_matches_dense(world, kv_dtype):
    """fp32 pages give the dense pool's tokens exactly; quantized pages are
    lossy, so int8 must stay on the dense token path for ≥ 75 % of tokens
    (the reference's own bound) and int4 must complete and conserve."""
    _, model, prompts = world
    dense, _ = _run(ContinuousBatchingEngine(model, **_mode("dense")),
                    prompts, new=8)
    paged, out = _run(ContinuousBatchingEngine(
        model, kv_dtype=kv_dtype, **_mode("paged")), prompts, new=8)
    assert out["stats"].requests_completed == len(prompts)
    same = np.mean(np.concatenate(dense) == np.concatenate(paged))
    if kv_dtype is None:
        assert same == 1.0
    elif kv_dtype == "int8":
        assert same >= 0.75, same


def test_preemption_under_page_pressure(world):
    """A pool too small for both residents forces a mid-decode preemption;
    the preempted request re-prefills and tokens stay identical."""
    _, model, _ = world
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
               for _ in range(2)]
    dense, _ = _run(ContinuousBatchingEngine(model, **_mode("dense")),
                    prompts, new=16)
    paged, out = _run(ContinuousBatchingEngine(
        model, num_pages=6, **_mode("paged")), prompts, new=16)
    assert out["stats"].preemptions >= 1
    assert out["stats"].requests_completed == 2
    for a, b in zip(dense, paged):
        np.testing.assert_array_equal(a, b)


def test_admission_rejects_unservable(world):
    _, model, prompts = world
    eng = ContinuousBatchingEngine(model, num_pages=6, **_mode("paged"))
    with pytest.raises(AdmissionRejected, match="worst-case KV"):
        eng.submit(np.arange(40, dtype=np.int32), max_new_tokens=8)
    # the submit bound covers the admission gate: prompt·nA + nA pages
    tight = ContinuousBatchingEngine(model, num_pages=2, **_mode("paged"))
    with pytest.raises(AdmissionRejected, match="worst-case KV"):
        tight.submit(np.arange(8, dtype=np.int32), max_new_tokens=1)
    dense = ContinuousBatchingEngine(model, **_mode("dense"))
    with pytest.raises(AdmissionRejected) as e:
        dense.submit(np.zeros((0,), np.int32), max_new_tokens=4)
    assert e.value.reason == "empty_prompt"
    with pytest.raises(AdmissionRejected) as e:
        dense.submit(np.zeros((48,), np.int32), max_new_tokens=4)
    assert e.value.reason == "prompt_too_long"


def _drive_scheduler(mod, lens):
    """Submit, plan, prefill, evict and requeue through one scheduler
    module; returns its trace.  Long prompts wait for an empty pool (FIFO
    backpressure); every other step evicts the lowest resident slot and
    every third eviction requeues its request (a preemption)."""
    sched = mod.Scheduler(3, 48, buckets=mod.default_buckets(48))
    for uid, n in enumerate(lens):
        sched.submit(mod.Request(uid=uid, tokens=np.zeros(n, np.int32),
                                 max_new_tokens=4))

    def can_place(req):
        return req.prompt_len < 30 or not sched.active

    trace, step = [], 0
    while sched.has_work():
        step += 1
        assert step < 200, "scheduler did not drain"
        plan = sched.plan_step(can_place=can_place)
        work = plan.prefill
        if work is not None:
            if hasattr(sched, "prefill_advance"):   # the reference's chunks
                sched.prefill_advance(work)
            sched.activate(mod.ActiveRequest(req=work.req, slot=work.slot,
                                             pos=work.req.prompt_len))
        trace.append((plan.decode_slots, work and (work.req.uid, work.slot)))
        if step % 2 == 0 and sched.active:
            st = sched.release(min(sched.active))
            if step % 6 == 0:
                sched.requeue(st.req)
            trace.append(("evict", st.req.uid, sched.free_slots,
                          [r.uid for r in sched.queue]))
    return trace


def test_scheduler_matches_reference():
    """Admission order, slot choice, backpressure, age-ordered requeue,
    eviction, ``admit`` and the prefill buckets equal the JAX package's
    scheduler (monolithic prefill: the reference's chunk is the whole
    prompt)."""
    from repro.serve import scheduler as jsched
    from repro_torch.serve import scheduler as tsched
    lens = np.random.default_rng(3).integers(1, 40, 9).tolist()
    assert _drive_scheduler(tsched, lens) == _drive_scheduler(jsched, lens)
    admitted = []
    for mod in (tsched, jsched):
        sched = mod.Scheduler(3, 48)
        for uid, n in enumerate(lens):
            sched.submit(mod.Request(uid=uid, tokens=np.zeros(n, np.int32),
                                     max_new_tokens=4))
        first = sched.admit(limit=1)
        rest = sched.admit(can_place=lambda r: r.prompt_len < 30)
        admitted.append([(s, r.uid) for s, r in first + rest])
    assert admitted[0] == admitted[1]
    mine = tsched.Scheduler(2, 48, buckets=tsched.default_buckets(48))
    ref = jsched.Scheduler(2, 48, buckets=jsched.default_buckets(48))
    for n in range(1, 48):
        toks = np.arange(n, dtype=np.int32)
        (a, ia), (b, ib) = mine.pad_prompt(toks), ref.pad_prompt(toks)
        np.testing.assert_array_equal(a, b)
        assert ia == ib and mine.bucket_for(n) == ref.bucket_for(n)


@pytest.mark.parametrize("knob", [
    {"kv_mode": "paged", "mesh": object()}, {"sharding_policy": object()},
    {"faults": [], "mesh": object()}, {"mesh": object()}])
def test_unported_knob_raises_config_error(world, knob):
    _, model, _ = world
    kw = dict(GEOM, **knob)
    with pytest.raises(ConfigError, match="ROADMAP queue 1"):
        ContinuousBatchingEngine(model, **kw)


@pytest.mark.parametrize("knob", [
    {"kv_mode": "paged", "watchdog": object()}, {"faults": []},
    {"snapshot_dir": "snap", "snapshot_every": 3}])
def test_robustness_knob_builds(world, knob):
    """Faults, the watchdog and snapshots are ported: the engine takes
    them (``tests/test_torch_faults.py`` and ``test_torch_snapshot.py``
    hold what they do)."""
    _, model, _ = world
    eng = ContinuousBatchingEngine(model, **dict(GEOM, **knob))
    assert not eng.faults
    assert eng.watchdog is knob.get("watchdog")
    assert eng.snapshot_dir == knob.get("snapshot_dir")
    assert eng.snapshot_every == knob.get("snapshot_every", 1)


def test_temperature_sampling_by_distribution():
    """Neither package reproduces the other's random bits, so sampling is
    held by distribution: 20 000 draws from each against the analytic
    softmax(logits / T)."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((1, 12)).astype(np.float32) * 2.0
    n, temp = 20_000, 0.7
    want = np.exp(logits[0] / temp - (logits[0] / temp).max())
    want /= want.sum()
    mine = sample(torch.from_numpy(np.repeat(logits, n, 0)),
                  torch.Generator().manual_seed(3), temp).numpy()
    theirs = np.asarray(jsampling.sample(jnp.asarray(np.repeat(logits, n, 0)),
                                         jax.random.PRNGKey(3), temp))
    for draws in (mine, theirs):
        freq = np.bincount(draws, minlength=12) / n
        # 5 standard errors of a binomial frequency
        assert np.all(np.abs(freq - want)
                      <= 5 * np.sqrt(want * (1 - want) / n))
    assert (sample(torch.from_numpy(logits), None, 0.0).numpy()
            == logits.argmax(-1)).all()


def test_engine_temperature_reproducible(world):
    _, model, prompts = world
    outs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(model, temperature=0.8,
                                       **_mode("paged"))
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
        res = eng.run(torch.Generator().manual_seed(5))["results"]
        outs.append([res[u].tokens for u in uids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [[], ["--paged-kv", "--kv-dtype", "int8"]])
def test_launcher_continuous_on_cpu(extra, capsys):
    launch_serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--continuous", "--batch", "2", "--prompt-len", "12",
                       "--new-tokens", "4", *extra])
    out = capsys.readouterr().out
    assert "requests: 4" in out
    assert ("paged KV: peak" in out) == bool(extra)
