"""The port's crash-consistent snapshots on the CPU (``serve/snapshot.py``)
against the JAX package.

The codec: bf16 round-trips bit for bit (its raw 16 bits, NaN payloads
included), int8 codes, fp32 scales, int32 / int64 metadata and nested
lists and dicts as they are, and a generator's state so that draws after
the restore equal the originals.  The store: pruning to 3, the latest and
a given step, a pruned step raising ``FileNotFoundError``, a leftover
``.tmp`` ignored, a shape or dtype off the template raising.

The engine, in all six run loops (as ``tests/test_torch_faults.py``), on
the reference's workload: killed at the same boundary after a snapshot,
the port's ``host.json`` equals the reference's field for field (wall-
clock fields left out): queue, residents, free slots, finished results,
run counters, allocator chains, free list, fills and history arrays.  A
fresh port engine then ``resume()``s and its tokens equal the reference's
clean run's, nothing leaked.  At temperature 0.8 a fused dense run killed
and resumed (the generator restored) gives the uninterrupted run's tokens.
A changed geometry refuses to resume ("fingerprint"); kill and resume with
the prefix cache mirrors ``tests/test_prefix_cache.py``'s (records
dropped, the cache publishing and hitting again); and the launcher's
``--kill-at`` exits with code 3 and ``--resume`` writes the clean run's
``--results-out``."""
import json

import numpy as np
import pytest
import torch

from repro.serve import faults as jfaults
from repro.serve.errors import SimulatedKill as JKill
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import Tracer
from repro_torch.serve import faults as tfaults
from repro_torch.serve import snapshot as snap
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.errors import SimulatedKill
from test_torch_faults import (GEOM, LOOPS, MAX_NEW, WORKLOAD_LENS,
                               assert_no_leaks, prompts)
from test_torch_obs import (_reference_copies_host_arrays,  # noqa: F401
                            CFG, reference_engines, reference_world)

torch.set_num_threads(2)

# the boundary each loop is killed at (after that boundary's snapshot), one
# with requests resident
KILL_AT = {"dense": 6, "paged": 6, "dense_fused": 3, "paged_fused": 3,
           "dense_spec": 3, "paged_spec": 3}
WALL_CLOCK = ("age_s", "run_age_s", "ttft_s", "decode_s", "max_stall_s",
              "max_decode_stall_s")


@pytest.fixture(scope="module")
def world():
    return reference_world()


@pytest.fixture(scope="module")
def ref_engine(world):
    return reference_engines(world[0])


def _tree(g):
    gen = torch.Generator().manual_seed(11)
    bits = torch.from_numpy(g.integers(-2 ** 15, 2 ** 15, (3, 5),
                                       dtype=np.int16))
    return {"kv": [{"k": bits.view(torch.bfloat16),
                    "codes": torch.from_numpy(g.integers(
                        -128, 128, (2, 4, 3), dtype=np.int8)),
                    "scales": torch.from_numpy(
                        g.standard_normal((2, 4)).astype(np.float32))},
                   {"pos": torch.arange(6, dtype=torch.int32),
                    "meta": torch.from_numpy(g.integers(
                        0, 2 ** 40, (4,), dtype=np.int64))}],
            "rng": gen}


def _template(tree):
    def blank(v):
        if isinstance(v, torch.Generator):
            return torch.Generator()
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    return {"kv": [{k: blank(v) for k, v in d.items()} for d in tree["kv"]],
            "rng": blank(tree["rng"])}


def _same(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_codec_round_trip(tmp_path):
    tree = _tree(np.random.default_rng(0))
    snap.save_snapshot(tmp_path, 3, tree, {"note": 1})
    back, host, at = snap.load_snapshot(tmp_path, _template(tree))
    assert at == 3 and host["note"] == 1
    manifest = host["_snapshot"]
    assert manifest["keys"] == ["kv.0.k", "kv.0.codes", "kv.0.scales",
                                "kv.1.pos", "kv.1.meta", "rng"]
    assert manifest["dtypes"]["kv.0.k"] == "bfloat16"
    assert manifest["dtypes"]["rng"] == "generator"
    # raw leaves back to back: bf16 2 B, codes 1 B, scales 4 B, ...
    sizes = [15 * 2, 24, 8 * 4, 6 * 4, 4 * 8,
             tree["rng"].get_state().numel()]
    assert [manifest["offsets"][k] for k in manifest["keys"]] == list(
        np.cumsum([0] + sizes[:-1]))
    assert (tmp_path / "serve_00000003" / "arrays.bin").stat().st_size \
        == sum(sizes)
    for d_in, d_out in zip(tree["kv"], back["kv"]):
        assert list(d_in) == list(d_out)
        for k in d_in:
            assert _same(d_in[k], d_out[k]), k
    # the generator: draws after the restore equal the originals
    want = torch.rand(5, generator=tree["rng"])
    live = {"kv": [{k: torch.zeros_like(v) for k, v in d.items()}
                   for d in tree["kv"]], "rng": torch.Generator()}
    snap.copy_into(live, back)
    assert torch.equal(torch.rand(5, generator=live["rng"]), want)
    for d_in, d_live in zip(tree["kv"], live["kv"]):
        assert all(_same(d_in[k], d_live[k]) for k in d_in)


def test_store_prune_select_and_refuse(tmp_path):
    tree = _tree(np.random.default_rng(1))
    for step in (2, 4, 6, 8):
        snap.save_snapshot(tmp_path, step, tree, {"step": step}, keep=3)
    (tmp_path / "serve_00000009.tmp").mkdir()     # a writer killed midway
    assert snap.list_snapshot_steps(tmp_path) == [4, 6, 8]
    assert snap.latest_snapshot_step(tmp_path) == 8
    _, host, at = snap.load_snapshot(tmp_path, _template(tree), step=6)
    assert at == 6 and host["step"] == 6
    with pytest.raises(FileNotFoundError):
        snap.load_snapshot(tmp_path, _template(tree), step=2)
    with pytest.raises(FileNotFoundError):
        snap.load_snapshot(tmp_path / "none", _template(tree))
    bad = _template(tree)
    bad["kv"][0]["codes"] = torch.empty((2, 4, 4), dtype=torch.int8,
                                        device="meta")
    with pytest.raises(ValueError, match="shape/dtype"):
        snap.load_snapshot(tmp_path, bad)
    bad = _template(tree)
    bad["kv"][1]["meta"] = torch.empty((4,), dtype=torch.int32,
                                       device="meta")
    with pytest.raises(ValueError, match="shape/dtype"):
        snap.load_snapshot(tmp_path, bad)


# ---------------------------------------------------------------------------
# Kill and resume in the six loops, beside the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def killed(world, ref_engine, tmp_path_factory):
    """Per loop, the port's and the reference's runs killed at the same
    boundary, each with its own snapshot directory: (port dir, reference
    dir)."""
    cache = {}

    def get(loop):
        if loop in cache:
            return cache[loop]
        root = tmp_path_factory.mktemp(loop)
        dirs = (str(root / "port"), str(root / "ref"))
        kw = dict(GEOM, **LOOPS[loop])
        mine = ContinuousBatchingEngine(world[1], **kw)
        theirs = ref_engine(**kw)
        for eng, d, mod, kill in ((mine, dirs[0], tfaults, SimulatedKill),
                                  (theirs, dirs[1], jfaults, JKill)):
            eng.snapshot_dir = d
            eng.faults = mod.as_fault_plan([mod.Fault(
                "kill", step=KILL_AT[loop], message="pulled the plug")])
            for p in prompts():
                eng.submit(p, max_new_tokens=MAX_NEW)
            with pytest.raises(kill, match="pulled the plug"):
                eng.run()
            assert eng.metrics.value("snapshots_total") >= 1
        cache[loop] = dirs
        return dirs
    return get


def _host(d):
    step = snap.latest_snapshot_step(d)
    with open(f"{d}/serve_{step:08d}/host.json") as f:
        host = json.load(f)
    host.pop("_snapshot")

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in WALL_CLOCK}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return step, strip(host)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_host_state_matches_reference(killed, loop):
    mine, theirs = (_host(d) for d in killed(loop))
    assert mine[0] == theirs[0] == KILL_AT[loop]
    assert mine[1]["active"], "nothing resident at the kill"
    assert mine == theirs


@pytest.mark.parametrize("loop", list(LOOPS))
def test_kill_resume_matches_reference_clean(world, ref_engine, killed,
                                             loop):
    kw = dict(GEOM, **LOOPS[loop])
    ref = ref_engine(**kw)
    uids = [ref.submit(p, max_new_tokens=MAX_NEW) for p in prompts()]
    out = ref.run()
    want = [out["results"][u].tokens.tolist() for u in uids]
    eng = ContinuousBatchingEngine(world[1], snapshot_dir=killed(loop)[0],
                                   trace=Tracer(), **kw)
    assert eng.resume() == KILL_AT[loop]
    out = eng.run()
    assert out["stats"].resumes == 1
    assert sorted(out["results"]) == list(range(len(WORKLOAD_LENS)))
    assert [out["results"][u].tokens.tolist() for u in uids] == want
    assert all(r.finish_reason == "length"
               for r in out["results"].values())
    assert eng.tracer.open_spans() == {}
    assert_no_leaks(eng)


def test_sampled_kill_resume_restores_generator(world, tmp_path):
    """Fused dense at temperature 0.8: the run killed at boundary 2 and
    resumed by a fresh engine draws what the uninterrupted run drew."""
    kw = dict(GEOM, **LOOPS["dense_fused"], temperature=0.8)

    def go(eng, resume=False):
        if resume:
            eng.resume()
        else:
            for p in prompts():
                eng.submit(p, max_new_tokens=MAX_NEW)
        out = eng.run(torch.Generator().manual_seed(5))
        return {u: r.tokens.tolist() for u, r in out["results"].items()}

    want = go(ContinuousBatchingEngine(world[1], **kw))
    eng = ContinuousBatchingEngine(
        world[1], snapshot_dir=str(tmp_path), **kw,
        faults=[tfaults.Fault("kill", step=2)])
    with pytest.raises(SimulatedKill):
        go(eng)
    got = go(ContinuousBatchingEngine(world[1], snapshot_dir=str(tmp_path),
                                      **kw), resume=True)
    assert got == want


def test_resume_refuses_another_geometry(world, tmp_path):
    eng = ContinuousBatchingEngine(world[1], snapshot_dir=str(tmp_path),
                                   **GEOM)
    for p in prompts():
        eng.submit(p, max_new_tokens=MAX_NEW)
    assert eng.run()["stats"].snapshots >= 1
    other = ContinuousBatchingEngine(world[1], max_slots=3, max_len=48,
                                     snapshot_dir=str(tmp_path))
    with pytest.raises(ValueError, match="fingerprint"):
        other.resume()
    with pytest.raises(ValueError, match="snapshot_dir"):
        ContinuousBatchingEngine(world[1], **GEOM).resume()


def test_kill_resume_with_prefix_cache(world, ref_engine, tmp_path):
    """``tests/test_prefix_cache.py``'s kill/resume on the port: tokens
    equal the reference's clean run's, the restored allocator conserves
    pages (records are not serialized: the resume drops them), and the
    cache publishes, then hits, again."""
    rng = np.random.default_rng(13)
    head = rng.integers(0, CFG.vocab_size, (16,), dtype=np.int32)
    ps = [np.concatenate([head, rng.integers(0, CFG.vocab_size, (t,),
                                             dtype=np.int32)])
          for t in (4, 6, 8)]
    kw = dict(kv_mode="paged", page_size=8, prefix_cache=True,
              prefix_block=8, max_slots=3, max_len=48)
    ref = ref_engine(**kw)
    hs = [ref.submit(p, max_new_tokens=6) for p in ps]
    out = ref.run()
    want = [out["results"][int(h)].tokens.tolist() for h in hs]

    eng = ContinuousBatchingEngine(
        world[1], snapshot_dir=str(tmp_path), **kw,
        faults=[tfaults.Fault("kill", step=6, message="yank")])
    uids = [eng.submit(p, max_new_tokens=6) for p in ps]
    with pytest.raises(SimulatedKill, match="yank"):
        eng.run()
    eng2 = ContinuousBatchingEngine(world[1], snapshot_dir=str(tmp_path),
                                    **kw)
    assert eng2.resume() >= 1
    out = eng2.run()
    assert sorted(out["results"]) == sorted(int(u) for u in uids)
    assert [out["results"][int(u)].tokens.tolist() for u in uids] == want

    def no_leaks(e):
        pins = e.prefix.page_pins()
        e.allocator.check_conservation(pins)
        assert e.allocator.free_pages == e.num_pages - len(pins)

    no_leaks(eng2)
    h = eng2.submit(ps[0], max_new_tokens=4)
    out2 = eng2.run()
    assert out2["results"][int(h)].finish_reason == "length"
    assert out2["stats"].prefix_hits == 0
    h2 = eng2.submit(ps[1], max_new_tokens=4)
    out3 = eng2.run()
    assert out3["stats"].prefix_hits == 1
    assert out3["results"][int(h2)].finish_reason == "length"
    no_leaks(eng2)


def test_launcher_kill_and_resume(tmp_path):
    base = ["--smoke", "--device", "cpu", "--continuous", "--paged-kv",
            "--decode-steps", "4", "--batch", "2", "--prompt-len", "16",
            "--new-tokens", "8"]
    d = str(tmp_path / "snaps")
    clean, resumed = tmp_path / "clean.json", tmp_path / "resumed.json"
    launch_serve.main(base + ["--results-out", str(clean)])
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(base + ["--snapshot-dir", d, "--kill-at", "3"])
    assert ei.value.code == 3
    assert snap.latest_snapshot_step(d) == 3
    launch_serve.main(base + ["--snapshot-dir", d, "--resume",
                              "--results-out", str(resumed)])
    assert json.loads(resumed.read_text()) == json.loads(clean.read_text())
    with pytest.raises(SystemExit, match="--resume requires"):
        launch_serve.main(base + ["--resume"])
    with pytest.raises(SystemExit, match="require --continuous"):
        launch_serve.main(["--smoke", "--device", "cpu", "--kill-at", "2"])
