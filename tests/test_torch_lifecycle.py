"""The port's request lifecycle on the CPU against the JAX package: each
case runs one script of calls — ``submit`` (with ``deadline_s``),
``cancel``, ``RequestHandle.tokens()``, the driver's single-iteration pump,
``run()`` — on the port's continuous engine and on the reference's, on the
same weights, and holds the two to the same finish reasons, tokens
(streamed ones with the iteration that emitted them), ``ServeStats``
(every count field, the lifecycle counters included) and page accounting
(refcounts, the free list in order, conservation with the prefix records'
pins).

Cases: streaming across preemptions (every index exactly once, equal to
``run()``'s tokens); two handles consumed interleaved; a deadline expiring
on a queued request, on an in-flight chunked prefill, on a resident (the
partial tokens kept; in a fused dense epoch, a resident whose deferred
first token is still on the device) and on a warm admission mid-prefill
(its prefix record unpinned, the cache serving the next warm admission);
``cancel`` of a resident (partial tokens, every page back) and of an
unknown uid (a no-op); load shedding on queue depth and on queue delay;
``max_preemptions`` 0 in a pool where the reference preempts; and
``tokens()`` pumped from a caller with grad enabled.

A deadline is made to expire at a chosen iteration by moving it to the
request's submission (``_expire``): both engines then retire it at the
same lifecycle sweep, which wall-clock deadlines would not guarantee.
Weights and reference engines as in ``tests/test_torch_obs.py``."""
import time

import numpy as np
import pytest
import torch

from repro_torch.serve.engine import ContinuousBatchingEngine
from test_torch_obs import (_reference_copies_host_arrays,  # noqa: F401
                            _script, _shared, reference_engines,
                            reference_world)

torch.set_num_threads(2)

STATS = ("prefill_tokens", "decode_tokens", "prefill_chunks",
         "interleaved_steps", "requests_completed", "decode_dispatches",
         "epoch_shrinks", "attn_keep_frac", "kv_saved_fraction",
         "kv_mode", "pages_total", "pages_peak", "preemptions",
         "kv_entries_stored", "kv_entries_dense", "history_hit_rate",
         "prefix_hits", "prefix_misses", "prefix_tokens_saved",
         "prefix_records", "requests_cancelled", "deadline_exceeded",
         "requests_shed", "preempt_budget_exhausted")
GEOM = dict(max_slots=3, max_len=48)
TIGHT = dict(kv_mode="paged", page_size=8, num_pages=7)   # it preempts


@pytest.fixture(scope="module")
def world():
    return reference_world()


@pytest.fixture(scope="module")
def ref_engine(world):
    return reference_engines(world[0])


def _expire(eng, uid):
    """Move ``uid``'s deadline to its submission: it has run out of time
    at the next lifecycle sweep."""
    sched = eng.scheduler
    reqs = list(sched.queue) + [st.req for st in sched.active.values()]
    if sched.prefilling is not None:
        reqs.append(sched.prefilling.req)
    (req,) = [r for r in reqs if r.uid == uid]
    req.deadline_s = 0.0


def _pump_until(eng, cond, limit=200):
    """Pump the driver one iteration at a time until ``cond(eng)``; the
    number of iterations it took."""
    for n in range(limit):
        if cond(eng):
            return n
        assert eng._pump(), "the run ended first"
    raise AssertionError("condition never held")


def _observe(eng, out):
    """What must match: results, stats and page accounting of a run."""
    res = {int(u): (r.tokens.tolist(), r.finish_reason)
           for u, r in out["results"].items()}
    stats = {f: getattr(out["stats"], f) for f in STATS}
    pages = None
    if eng.kv_mode == "paged":
        alloc = eng.allocator
        pins = eng.prefix.page_pins() if eng.prefix is not None else {}
        alloc.check_conservation(pins)
        assert alloc.free_pages == eng.num_pages - len(pins)
        pages = (alloc.refcount.tolist(), list(alloc._free),
                 alloc.fill.tolist())
    return {"results": res, "stats": stats, "pages": pages}


def _both(world, ref_engine, script, **kw):
    """``script(engine)`` on a port engine and a reference engine built
    with ``kw``: the two observations, which must be equal."""
    kw = dict(GEOM, **kw)
    mine = script(ContinuousBatchingEngine(world[1], **kw))
    theirs = script(ref_engine(**kw))
    assert mine == theirs
    return mine


def _streams(handles):
    return {int(h): [(int(t), int(s)) for t, s in h.tokens()]
            for h in handles}


def test_stream_across_preemption(world, ref_engine):
    """Every handle of a preempting pool consumed in turn: each request's
    streamed tokens are its result's, each index once, across its
    preemptions (the watermark survives them)."""
    def script(eng):
        hs = [eng.submit(p, max_new_tokens=n) for p, n in _script(new=12)]
        reqs = list(eng.scheduler.queue)
        streams = _streams(hs)
        obs = _observe(eng, eng.run())
        obs["streams"] = streams
        obs["preempted"] = sorted(r.uid for r in reqs if r.preempt_count)
        obs["done"] = [h.done() for h in hs]
        obs["handle_results"] = [h.result().tokens.tolist() for h in hs]
        return obs

    obs = _both(world, ref_engine, script, **TIGHT)
    assert obs["preempted"] and obs["stats"]["preemptions"] >= 1
    assert all(obs["done"])
    for uid, stream in obs["streams"].items():
        assert [t for t, _ in stream] == obs["handle_results"][uid]
        assert [t for t, _ in stream] == obs["results"][uid][0]


def test_two_handles_interleaved(world, ref_engine):
    """Two handles of a fused dense engine consumed a token at a time in
    turn, then ``run()`` drains the rest: the streams hold each handle's
    tokens, and the tokens equal a plain run's."""
    def script(eng):
        hs = [eng.submit(p, max_new_tokens=n) for p, n in _script(n=4)]
        its = [hs[1].tokens(), hs[2].tokens()]
        got = {int(hs[1]): [], int(hs[2]): []}
        live = list(zip(hs[1:3], its))
        while live:
            for h, it in list(live):
                try:
                    got[int(h)].append(tuple(int(x) for x in next(it)))
                except StopIteration:
                    live.remove((h, it))
        obs = _observe(eng, eng.run())
        obs["streams"] = got
        obs["all"] = {int(h): h.result().tokens.tolist() for h in hs}
        return obs

    obs = _both(world, ref_engine, script, kv_mode="dense", decode_steps=4)
    for uid, stream in obs["streams"].items():
        assert [t for t, _ in stream] == obs["all"][uid]
    plain = ContinuousBatchingEngine(world[1], **GEOM)
    uids = [plain.submit(p, max_new_tokens=n) for p, n in _script(n=4)]
    res = plain.run()["results"]
    assert [res[u].tokens.tolist() for u in uids] == list(obs["all"].values())


def test_deadline_expires_queued_request(world, ref_engine):
    """``deadline_s`` 0 expires at the first sweep, while queued: no tokens,
    reason "deadline", counted; the others unaffected."""
    def script(eng):
        reqs = _script(n=3)
        for p, n in reqs[:2]:
            eng.submit(p, max_new_tokens=n)
        eng.submit(reqs[2][0], max_new_tokens=8, deadline_s=0.0)
        return _observe(eng, eng.run())

    obs = _both(world, ref_engine, script, kv_mode="dense")
    assert obs["results"][2] == ([], "deadline")
    assert obs["stats"]["deadline_exceeded"] == 1
    assert [obs["results"][u][1] for u in (0, 1)] == ["length", "length"]


def test_deadline_expires_inflight_chunked_prefill(world, ref_engine):
    """A 30-token prompt at chunk 8 expired after its first chunk: the
    in-flight prefill is aborted, not requeued, its worst-case pages come
    back; no tokens, reason "deadline"."""
    def script(eng):
        short = _script(n=1, seed=4)[0]
        eng.submit(short[0], max_new_tokens=6)
        (long_p, _), = _script(n=1, seed=5, lo=30, hi=31)
        h = eng.submit(long_p, max_new_tokens=6)
        n = _pump_until(eng, lambda e: e.scheduler.prefilling is not None
                        and e.scheduler.prefilling.req.uid == int(h)
                        and e.scheduler.prefilling.done > 0)
        _expire(eng, int(h))
        obs = _observe(eng, eng.run())
        obs["pumps"] = n
        return obs

    obs = _both(world, ref_engine, script, kv_mode="paged", page_size=8,
                prefill_chunk=8)
    assert obs["results"][1] == ([], "deadline")
    assert obs["results"][0][1] == "length"


@pytest.mark.parametrize("mode", ["dense_fused_pending", "paged"])
def test_deadline_expires_resident(world, ref_engine, mode):
    """A resident expired mid-decode keeps its partial tokens (reason
    "deadline") and, paged, returns its pages.  In a fused dense epoch it
    is expired right after its prefill, while its first token is still on
    the device: the sweep reads that token, so the partial result holds
    the real one."""
    kw = (dict(kv_mode="dense", decode_steps=4) if mode.startswith("dense")
          else dict(kv_mode="paged", page_size=8))
    want = 1 if mode.startswith("dense") else 3

    def script(eng):
        hs = [eng.submit(p, max_new_tokens=n) for p, n in _script(n=3)]
        n = _pump_until(eng, lambda e: any(
            st.req.uid == 1 and len(st.out_tokens) >= want
            for st in e.scheduler.active.values()))
        _expire(eng, int(hs[1]))
        obs = _observe(eng, eng.run())
        obs["pumps"] = n
        return obs

    obs = _both(world, ref_engine, script, **kw)
    toks, reason = obs["results"][1]
    assert reason == "deadline" and want <= len(toks) < 8
    full = ContinuousBatchingEngine(world[1], **GEOM)
    uids = [full.submit(p, max_new_tokens=n) for p, n in _script(n=3)]
    ref = full.run()["results"][uids[1]].tokens.tolist()
    assert toks == ref[:len(toks)]


def test_warm_admission_deadline_releases_pin(world, ref_engine):
    """A warm admission (a 24-token published prefix, a 17-token suffix at
    chunk 8) expired after its first suffix chunk: the record it pinned is
    unpinned, its pages come back (free + pinned = pool), no warm
    admission is left pending; the next run's warm admission of the same
    prompt hits and completes."""
    def script(eng):
        (p1, n1), (p2, _) = _shared(24, (4, 17), 7)
        eng.submit(p1, max_new_tokens=n1)
        first = _observe(eng, eng.run())
        h = eng.submit(p2, max_new_tokens=6)
        n = _pump_until(eng, lambda e: e.scheduler.prefilling is not None
                        and e.scheduler.prefilling.slot in e._warm_pending
                        and e.scheduler.prefilling.done > 24)
        pinned = sum(r.in_use for r in eng.prefix._records.values())
        _expire(eng, int(h))
        second = _observe(eng, eng.run())
        left = (len(eng._warm_pending),
                sum(r.in_use for r in eng.prefix._records.values()))
        eng.submit(p2, max_new_tokens=6)
        third = _observe(eng, eng.run())
        return {"runs": [first, second, third], "pumps": n,
                "pinned": pinned, "left": left}

    obs = _both(world, ref_engine, script, kv_mode="paged", page_size=8,
                prefill_chunk=8, prefix_cache=True, prefix_block=8)
    first, second, third = obs["runs"]
    assert obs["pinned"] == 1 and obs["left"] == (0, 0)
    assert second["results"] == {1: ([], "deadline")}
    assert second["stats"]["prefix_hits"] == 1
    assert third["stats"]["prefix_hits"] == 1
    assert third["results"][2][1] == "length"


def test_cancel_resident_and_unknown_uid(world, ref_engine):
    """``cancel`` of an unknown uid does nothing; ``cancel`` of a resident
    after its 4th streamed token finishes it "cancelled" with its partial
    tokens (a prefix of its uncancelled run) and returns every page."""
    def script(eng):
        eng.cancel(10_000)
        hs = [eng.submit(p, max_new_tokens=10) for p, _ in _script(n=2)]
        it = hs[0].tokens()
        seen = [next(it) for _ in range(4)]
        eng.cancel(hs[0])
        obs = _observe(eng, eng.run())
        obs["seen"] = [(int(t), int(s)) for t, s in seen]
        return obs

    obs = _both(world, ref_engine, script, kv_mode="paged", page_size=8)
    toks, reason = obs["results"][0]
    assert reason == "cancelled" and 4 <= len(toks) < 10
    assert [t for t, _ in obs["seen"]] == toks[:4]
    assert obs["results"][1][1] == "length"
    assert obs["stats"]["requests_cancelled"] == 1
    plain = ContinuousBatchingEngine(world[1], kv_mode="paged", page_size=8,
                                     **GEOM)
    u = [plain.submit(p, max_new_tokens=10) for p, _ in _script(n=2)]
    want = plain.run()["results"][u[0]].tokens.tolist()
    assert toks == want[:len(toks)]


@pytest.mark.parametrize("bound", ["queue_depth", "queue_delay"])
def test_shedding(world, ref_engine, bound):
    """A submission past ``max_queue_depth`` 2, or behind a queue head that
    has waited past ``max_queue_delay_s``, raises ``AdmissionRejected``
    with that reason and is counted; the queued work is served."""
    kw = ({"max_queue_depth": 2} if bound == "queue_depth"
          else {"max_queue_delay_s": 0.05})

    def script(eng):
        reqs = _script(n=3)
        ok = [eng.submit(p, max_new_tokens=4) for p, _ in reqs[:2]]
        time.sleep(0.1)
        with pytest.raises(ValueError) as e:    # either package's
            eng.submit(reqs[2][0], max_new_tokens=4)
        queued = [r.uid for r in eng.scheduler.queue]
        obs = _observe(eng, eng.run())
        obs.update(error=type(e.value).__name__, reason=e.value.reason,
                   uid=e.value.uid, queued=queued, ok=[int(u) for u in ok])
        return obs

    obs = _both(world, ref_engine, script, kv_mode="dense", **kw)
    assert obs["error"] == "AdmissionRejected"
    assert obs["reason"] == bound and obs["uid"] == 2
    assert obs["queued"] == obs["ok"] == [0, 1]
    assert obs["stats"]["requests_shed"] == 1
    assert sorted(obs["results"]) == [0, 1]


def test_preempt_budget(world, ref_engine):
    """``max_preemptions`` 0 in the preempting pool: each request the
    reference evicts finishes "preempt_budget" with its partial tokens
    instead of requeueing; the rest complete."""
    def script(eng):
        for p, n in _script(new=12):
            eng.submit(p, max_new_tokens=n)
        return _observe(eng, eng.run())

    obs = _both(world, ref_engine, script, max_preemptions=0, **TIGHT)
    spent = [u for u, (_, r) in obs["results"].items()
             if r == "preempt_budget"]
    assert spent and obs["stats"]["preempt_budget_exhausted"] == len(spent)
    assert obs["stats"]["preemptions"] == len(spent)
    assert all(len(obs["results"][u][0]) < 12 for u in spent)


def test_tokens_pumped_with_grad_enabled(world, ref_engine, monkeypatch):
    """``tokens()`` pumped by a caller with grad enabled, on weights that
    require grad: every forward runs with grad disabled and no tensor the
    engine keeps (the paged store) requires grad; tokens equal the
    reference's."""
    model = world[1]
    modes = []
    for name in ("prefill", "paged_decode_step"):
        fn = getattr(model, name)

        def spy(*a, _fn=fn, **k):
            modes.append(torch.is_grad_enabled())
            return _fn(*a, **k)
        monkeypatch.setattr(model, name, spy)
    params = list(model.parameters())
    try:
        for p in params:
            p.requires_grad_(True)
        eng = ContinuousBatchingEngine(model, kv_mode="paged", page_size=8,
                                       **GEOM)
        hs = [eng.submit(p, max_new_tokens=n) for p, n in _script(n=2)]
        with torch.enable_grad():
            streams = _streams(hs)
            out = eng.run()
    finally:
        for p in params:
            p.requires_grad_(False)
    assert modes and not any(modes)
    assert not any(t.requires_grad for t in eng._store.values())
    theirs = ref_engine(kv_mode="paged", page_size=8, **GEOM)
    jh = [theirs.submit(p, max_new_tokens=n) for p, n in _script(n=2)]
    assert streams == _streams(jh)
    assert {u: r.tokens.tolist() for u, r in out["results"].items()} == \
        {u: [t for t, _ in s] for u, s in streams.items()}
