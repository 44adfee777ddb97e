"""Crash-consistent engine snapshots: serialize a running
``ContinuousBatchingEngine`` at a step boundary, survive a host kill, and
``resume()`` with bit-identical survivor tokens (after the JAX package's
``serve/snapshot.py``, which cannot be imported without JAX).

Two properties carry the design:

* **atomic publish** — the snapshot is written to ``serve_XXXXXXXX.tmp``,
  its files fsynced, then the directory renamed; a writer killed
  mid-snapshot never corrupts the latest good snapshot;
* **template restore** — the device tensors (the dense slot pool or the
  paged store, and the run's ``torch.Generator`` state) go through a
  tensor codec of this module's own (``write_leaves`` / ``decode_tree``):
  nested dicts and lists flattened under stable dotted keys, bf16 stored
  as its raw 16 bits (numpy has no bf16, and a round trip through fp32
  would cost twice the bytes), every other dtype (int8 / int4 page codes,
  fp32 scales, int32 / int64 metadata) as it is, a generator as its
  ``get_state()`` bytes.  The leaves are written back to back, raw, into
  one file whose offsets the manifest holds (no archive, no checksum
  pass: a 1 GB pool is written at the disk's rate, staged through one
  pinned buffer from the card).  A restore is checked leaf by leaf
  against a template (shape and dtype, or a mismatch raises), and the
  engine copies the restored tensors into its own live ones, so anything
  built over their addresses (a captured CUDA graph) stays valid.

Layout (one directory per boundary)::

    snapshot_dir/serve_00000012.tmp/  -> written, fsynced, renamed to
    snapshot_dir/serve_00000012/
        host.json      scheduler queue/active/free, allocator chains,
                       finished results, lifecycle ages, fingerprint,
                       the leaves' keys, shapes, dtypes and offsets
        arrays.bin     KV pool or store leaves + the generator state

**What a snapshot means.**  Snapshots are taken only at *quiescent* step
boundaries: no prefill chunk in flight, no deferred first token on the
device, no staging cache, and (the port's own) no decode step, epoch or
window dispatched and not yet synced.  At such a boundary the host
structures (scheduler, allocator, per-request token lists) plus the
device KV state and the generator are the *complete* engine state, so a
resumed run re-executes exactly the decode steps the dead process ran
after the boundary: at temperature 0 the tokens are bit-identical, and at
temperature > 0 the restored generator draws what the dead run would
have.  Wall-clock fields are stored as *elapsed* intervals and rebased
onto the resuming process's clock, so queue-age ordering (preemption
fairness, FIFO re-admission) survives the restart.  A snapshot of this
package is not readable by the JAX package, nor the other way round.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.scheduler import ActiveRequest, Request

SNAP_PREFIX = "serve_"
GENERATOR = "generator"          # the manifest's dtype of a generator leaf


# ---------------------------------------------------------------------------
# The tensor codec
# ---------------------------------------------------------------------------

def _leaves(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of a nested dict / list / tuple tree in a stable
    order: list positions and dict keys joined by dots."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _np_dtype(name: str) -> str:
    """The numpy dtype a leaf of manifest dtype ``name`` is stored as."""
    return {"bfloat16": "int16", GENERATOR: "uint8"}.get(name, name)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Generator):
        return GENERATOR
    return str(leaf.dtype).replace("torch.", "")


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host tensor's or a generator's bytes as a numpy array."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)               # the raw 16 bits
    return t.numpy()


def _template_shape(leaf: Any) -> List[int]:
    if isinstance(leaf, torch.Generator):
        return list(leaf.get_state().shape)
    return list(leaf.shape)


def decode_tree(arrays, manifest: Dict[str, Any], template: Any) -> Any:
    """Rebuild ``template``'s structure from ``arrays`` (a mapping of the
    manifest's keys): a tensor leaf becomes a CPU tensor of its dtype
    (bf16 from its bits), a generator leaf its state (a uint8 tensor for
    ``set_state``).  Raises ``ValueError`` when a key is missing or a shape
    or dtype differs from the template's."""
    shapes, dtypes = manifest["shapes"], manifest["dtypes"]

    def restore(key: str, leaf: Any):
        if key not in shapes:
            raise ValueError(f"snapshot has no leaf {key!r}")
        want = (_template_shape(leaf), _dtype_name(leaf))
        got = (list(shapes[key]), dtypes[key])
        if got != want:
            raise ValueError(f"snapshot leaf {key!r}: shape/dtype {got} "
                             f"!= the template's {want}")
        t = torch.from_numpy(np.ascontiguousarray(arrays[key]))
        return t.view(torch.bfloat16) if got[1] == "bfloat16" else t

    def walk(t: Any, prefix: str):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{i}.") for i, v in enumerate(t))
        return restore(prefix[:-1], t)

    return walk(template, "")


def copy_into(dst: Any, src: Any) -> None:
    """Copy a decoded tree into a live one of the same structure, tensor by
    tensor with ``copy_`` (the live tensors keep their addresses); a
    generator takes its restored state."""
    for (_, d), (_, s) in zip(_leaves(dst), _leaves(src)):
        if isinstance(d, torch.Generator):
            d.set_state(s)
        else:
            d.copy_(s)


# ---------------------------------------------------------------------------
# Atomic directory write / template read
# ---------------------------------------------------------------------------

def _fsynced(path: Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def write_leaves(f, tree: Any) -> Dict[str, Any]:
    """Write ``tree``'s leaves to ``f`` back to back, raw (a bf16 tensor's
    bits, a generator's state); a device tensor goes through one pinned
    staging buffer.  Returns the manifest: keys, shapes, dtypes and each
    leaf's byte offset."""
    leaves = list(_leaves(tree))
    cuda = [t for _, t in leaves
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    stage = (torch.empty(max(t.numel() * t.element_size() for t in cuda),
                         dtype=torch.uint8, pin_memory=True)
             if cuda else None)
    manifest = {"keys": [], "shapes": {}, "dtypes": {}, "offsets": {}}
    at = 0
    for key, leaf in leaves:
        if key in manifest["shapes"]:
            raise ValueError(f"duplicate snapshot key {key!r}")
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            n = leaf.numel() * leaf.element_size()
            stage[:n].copy_(leaf.detach().contiguous().reshape(-1).view(
                torch.uint8))
            data, shape = stage[:n].numpy(), list(leaf.shape)
        else:
            a = np.ascontiguousarray(_to_numpy(leaf))
            data, shape = a.reshape(-1).view(np.uint8), list(a.shape)
        f.write(data.data)
        manifest["keys"].append(key)
        manifest["shapes"][key] = shape
        manifest["dtypes"][key] = _dtype_name(leaf)
        manifest["offsets"][key] = at
        at += data.nbytes
    return manifest


class _Stored:
    """The leaves of an ``arrays.bin``, read on demand by key."""

    def __init__(self, f, manifest: Dict[str, Any]):
        self.f, self.m = f, manifest

    def __getitem__(self, key: str) -> np.ndarray:
        shape = self.m["shapes"][key]
        self.f.seek(self.m["offsets"][key])
        return np.fromfile(self.f, dtype=_np_dtype(self.m["dtypes"][key]),
                           count=int(np.prod(shape))).reshape(shape)


def save_snapshot(snap_dir, step: int, device_tree: Any,
                  host_state: Dict[str, Any], keep: int = 3) -> Path:
    """Atomically publish one snapshot; prunes to the newest ``keep``."""
    snap_dir = Path(snap_dir)
    snap_dir.mkdir(parents=True, exist_ok=True)
    final = snap_dir / f"{SNAP_PREFIX}{step:08d}"
    tmp = snap_dir / f"{SNAP_PREFIX}{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {}
    _fsynced(tmp / "arrays.bin",
             lambda f: manifest.update(write_leaves(f, device_tree)))
    host = dict(host_state)
    host["_snapshot"] = {"step": step, **manifest}
    _fsynced(tmp / "host.json", lambda f: f.write(json.dumps(host).encode()))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    if keep:
        for old in list_snapshot_steps(snap_dir)[:-keep]:
            shutil.rmtree(snap_dir / f"{SNAP_PREFIX}{old:08d}",
                          ignore_errors=True)
    return final


def list_snapshot_steps(snap_dir) -> List[int]:
    p = Path(snap_dir)
    if not p.exists():
        return []
    return sorted(int(d.name[len(SNAP_PREFIX):]) for d in p.iterdir()
                  if d.is_dir() and d.name.startswith(SNAP_PREFIX)
                  and not d.name.endswith(".tmp"))


def latest_snapshot_step(snap_dir) -> Optional[int]:
    steps = list_snapshot_steps(snap_dir)
    return steps[-1] if steps else None


def load_snapshot(snap_dir, device_template: Any,
                  step: Optional[int] = None, check=None
                  ) -> Tuple[Any, Dict[str, Any], int]:
    """Restore ``(device_tree, host_state, step)`` from the newest (or the
    given) snapshot, leaf by leaf against ``device_template`` (its tensors
    may be on the ``meta`` device: only shapes and dtypes are read).  The
    tree's tensors are on the CPU; ``copy_into`` puts them in place.
    ``check(host_state)``, when given, runs before any tensor is read."""
    if step is None:
        step = latest_snapshot_step(snap_dir)
        if step is None:
            raise FileNotFoundError(f"no engine snapshot under {snap_dir}")
    d = Path(snap_dir) / f"{SNAP_PREFIX}{step:08d}"
    if not d.is_dir():
        raise FileNotFoundError(f"no engine snapshot {d}")
    with open(d / "host.json") as f:
        host = json.load(f)
    if check is not None:
        check(host)
    with open(d / "arrays.bin", "rb") as f:
        tree = decode_tree(_Stored(f, host["_snapshot"]),
                           host["_snapshot"], device_template)
    return tree, host, step


# ---------------------------------------------------------------------------
# Host-state encode / decode (the engine's scheduler + allocator + results)
# ---------------------------------------------------------------------------

def _encode_request(req: Request, now: float) -> dict:
    return {
        "uid": req.uid,
        "tokens": np.asarray(req.tokens, np.int32).tolist(),
        "max_new_tokens": req.max_new_tokens,
        "stop_token": req.stop_token,
        "age_s": max(0.0, now - req.submit_s) if req.submit_s else 0.0,
        "deadline_s": req.deadline_s,
        "preempt_count": req.preempt_count,
    }


def _decode_request(d: dict, now: float) -> Request:
    return Request(uid=d["uid"],
                   tokens=np.asarray(d["tokens"], np.int32),
                   max_new_tokens=d["max_new_tokens"],
                   stop_token=d["stop_token"],
                   submit_s=now - d["age_s"],
                   deadline_s=d.get("deadline_s"),
                   preempt_count=d.get("preempt_count", 0))


def _encode_active(st: ActiveRequest, now: float) -> dict:
    d = {
        "req": _encode_request(st.req, now),
        "slot": st.slot,
        "pos": st.pos,
        "next_token": st.next_token,
        "out_tokens": [int(t) for t in st.out_tokens],
        "kv_stored": st.kv_stored,
        "kv_dense": st.kv_dense,
        "run_age_s": max(0.0, now - st.submit_s) if st.submit_s else 0.0,
        "ttft_s": (st.first_token_s - st.submit_s
                   if st.first_token_s else -1.0),
        "decode_s": st.decode_s,
        "max_stall_s": st.max_stall_s,
        "pf_gates": None,
    }
    if st.pf_gates is not None:
        # the prompt-phase gate log (a fused dense prefill's still on the
        # device), resolved to 0/1 ints: the accounting only thresholds it
        g = st.pf_gates
        if isinstance(g, torch.Tensor):
            g = g.float().cpu().numpy()
        d["pf_gates"] = (np.asarray(g, np.float32) > 0.5).astype(
            np.int32).tolist()
    return d


def _decode_active(d: dict, now: float) -> ActiveRequest:
    submit_s = now - d["run_age_s"]
    st = ActiveRequest(
        req=_decode_request(d["req"], now),
        slot=d["slot"], pos=d["pos"], next_token=d["next_token"],
        out_tokens=list(d["out_tokens"]),
        kv_stored=d["kv_stored"], kv_dense=d["kv_dense"],
        submit_s=submit_s,
        first_token_s=(submit_s + d["ttft_s"] if d["ttft_s"] >= 0 else 0.0),
        decode_s=d["decode_s"], max_stall_s=d["max_stall_s"],
        # stall tracking restarts at the resume boundary (the dead
        # process's wall time is not comparable)
        last_emit_s=now,
    )
    if d["pf_gates"] is not None:
        st.pf_gates = np.asarray(d["pf_gates"], np.float32)
    return st


def fingerprint(engine) -> Dict[str, Any]:
    """The geometry a snapshot's KV state is only meaningful under."""
    return {
        "cfg": engine.cfg.name,
        "kv_mode": engine.kv_mode,
        "max_slots": engine.max_slots,
        "max_len": engine.max_len,
        "decode_steps": engine.decode_steps,
        "prefill_chunk": engine.prefill_chunk,
        "temperature": engine.temperature,
        "page_size": getattr(engine, "page_size", 0),
        "num_pages": getattr(engine, "num_pages", 0),
        "kv_dtype": getattr(engine, "kv_dtype", None),
    }


def encode_host_state(engine, rs) -> Dict[str, Any]:
    """Everything outside the device tensors that ``resume()`` needs,
    JSON-able.  ``rs`` is the engine's ``_RunState``; requires a quiescent
    boundary (the engine guards this)."""
    now = perf_counter()
    sched = engine.scheduler
    host: Dict[str, Any] = {
        "fingerprint": fingerprint(engine),
        "uid": engine._uid,
        "queue": [_encode_request(r, now) for r in sched.queue],
        "active": {str(s): _encode_active(st, now)
                   for s, st in sched.active.items()},
        "free_slots": list(sched._free),
        "results": {str(uid): {
            "uid": r.uid,
            "tokens": np.asarray(r.tokens, np.int32).tolist(),
            "prompt_len": r.prompt_len,
            "ttft_s": r.ttft_s,
            "decode_s": r.decode_s,
            "finish_reason": r.finish_reason,
            "kv_stored": r.kv_stored,
            "kv_dense": r.kv_dense,
            "max_decode_stall_s": r.max_decode_stall_s,
        } for uid, r in rs.results.items()},
        "rs": {
            "step_idx": rs.step_idx,
            "disp_idx": rs.disp_idx,
            "keep_acc": rs.keep_acc,
            "keep_n": rs.keep_n,
            "run_age_s": max(0.0, now - rs.t_run),
        },
    }
    if engine.kv_mode == "paged":
        alloc = engine.allocator
        host["alloc"] = {
            "free": [int(p) for p in alloc._free],
            "chains": {str(s): [int(p) for p in c]
                       for s, c in alloc._chains.items()},
            "fill": alloc.fill.tolist(),
            "stats": {
                "pages_peak": alloc.stats.pages_peak,
                "entries_appended": alloc.stats.entries_appended,
                "entries_dense": alloc.stats.entries_dense,
            },
        }
        host["hist"] = {
            "fresh": rs.hist._fresh.tolist(),
            "ctx": rs.hist._ctx.tolist(),
            "hits": rs.hist.hits.tolist(),
            "reads": rs.hist.reads.tolist(),
        }
    return host


def check_fingerprint(engine, host: Dict[str, Any]) -> None:
    """Refuse to resume onto an engine whose geometry differs from the one
    that wrote the snapshot (a silent mismatch would corrupt the KV
    interpretation, not just the stats)."""
    fp, mine = host["fingerprint"], fingerprint(engine)
    diffs = {k: (fp.get(k), mine[k]) for k in mine if fp.get(k) != mine[k]}
    if diffs:
        raise ValueError(
            f"snapshot fingerprint mismatch (snapshot vs engine): {diffs}")


def apply_host_state(engine, rs, host: Dict[str, Any]) -> None:
    """Rebuild the scheduler / allocator / accounting from a snapshot's
    host state, rebasing wall-clock ages onto this process's clock."""
    from repro_torch.serve.engine import RequestResult   # local: no cycle
    now = perf_counter()
    sched = engine.scheduler
    # requests submitted to the resuming engine before run() merge into the
    # restored queue in age order (their stamps are later than every
    # rebased snapshot age, so they land at the tail)
    fresh = list(sched.queue)
    sched.queue.clear()
    for d in host["queue"]:
        sched.queue.append(_decode_request(d, now))
    for req in fresh:
        sched.requeue(req)
    sched.active = {int(s): _decode_active(d, now)
                    for s, d in host["active"].items()}
    sched._free = list(host["free_slots"])
    sched._prefilling = None
    engine._uid = max(engine._uid, host["uid"])
    rs.results.update({int(uid): RequestResult(**d)
                       for uid, d in host["results"].items()})
    for r in rs.results.values():
        r.tokens = np.asarray(r.tokens, np.int32)
    h = host["rs"]
    rs.step_idx = h["step_idx"]
    rs.disp_idx = h["disp_idx"]
    rs.keep_acc = h["keep_acc"]
    rs.keep_n = h["keep_n"]
    rs.t_run = now - h["run_age_s"]
    if engine.kv_mode == "paged":
        alloc = engine.allocator
        if engine.prefix is not None:
            # prefix records from this engine's pre-resume life pin pages
            # of the allocator state about to be replaced: drop them against
            # the OLD state first.  Record pins are never serialized (a
            # snapshot's pages are owned by slot chains only), so the
            # restored cache starts cold and the dead engine's record-only
            # pages return to the free list below.
            for w in engine._warm_pending.values():
                engine.prefix.unpin(w.rec)
            engine._warm_pending.clear()
            engine.prefix.clear()
        a = host["alloc"]
        alloc._chains = {int(s): list(c) for s, c in a["chains"].items()}
        alloc.fill = np.asarray(a["fill"], np.int32)
        alloc.block_table[:] = 0
        # refcounts rebuild from chain membership alone (shared prefix
        # pages sit in several chains; record pins are forgotten)
        alloc.refcount[:] = 0
        chained = set()
        for s, chain in alloc._chains.items():
            for j, page in enumerate(chain):
                alloc.block_table[s, j] = page
                alloc.refcount[page] += 1
                chained.add(page)
        # free list = the snapshot's stack order, then any page the dead
        # engine's prefix records were keeping off it
        stored = [int(p) for p in a["free"]]
        seen = set(stored) | chained
        alloc._free = stored + [p for p in range(alloc.num_pages)
                                if p not in seen]
        alloc.stats.pages_in_use = alloc.num_pages - len(alloc._free)
        alloc.stats.pages_peak = a["stats"]["pages_peak"]
        alloc.stats.entries_appended = a["stats"]["entries_appended"]
        alloc.stats.entries_dense = a["stats"]["entries_dense"]
        rs.hist._fresh = np.asarray(host["hist"]["fresh"], np.int64)
        rs.hist._ctx = np.asarray(host["hist"]["ctx"], np.int64)
        rs.hist.hits = np.asarray(host["hist"]["hits"], np.int64)
        rs.hist.reads = np.asarray(host["hist"]["reads"], np.int64)
