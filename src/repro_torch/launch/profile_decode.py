"""Where a decode step's time goes: ``torch.profiler`` over a window of
teacher-forced decode steps of one model, in bf16 weights and the same
weights quantized to int4-BFP, one after the other in one process (a
Mamba stack, whose int4 weights are not served yet, in bf16 only); with
``--paged``, teacher-forced paged decode steps of the bf16 weights over a
store packed from the prefill, in bf16, int8 and int4 pages; with
``--prefill``, one lock-step prefill of the bf16 weights instead (with
``--prefill-chunk C``, one request's prompt in chunks of C, as the
continuous engine prefills it; with ``--prefix warm|cold``, one admission
of the paged engine with the prefix cache on or off); with
``--decode-steps N``, fused N-step decode epochs (``model.DecodeEpoch``: on
the card a CUDA graph of one decode iteration, replayed) beside the eager
steps, in the same process; with ``--spec-k K``, steady windows of the
speculative continuous engine (the dense pool, or ``--paged`` bf16 pages),
split into draft, verify and commit.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --batch 4 --prompt-len 512 --steps 8   # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --paged                                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch mamba2-2.7b                                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch mamba2-2.7b --prefill                             # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --prefill --gather                      # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --prefill --prefill-chunk 128 --batch 1 # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --prefill --prefix warm --prompt-len 1024 \
      --prefix-tail 64 --batch 1                               # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --decode-steps 8                        # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --spec-k 4 [--paged] [--draft-keep 0.5] # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch gemma3-12b --prompt-len 1536 --decode-steps 8     # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch stablelm-3b --paged --decode-steps 8              # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch deepseek-coder-33b --decode-steps 8               # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch grok-1-314b --num-layers 4 --decode-steps 8       # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch arctic-480b --num-layers 2 --prefill              # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --smoke --device cpu [--paged]          # plain versions

``--arch gemma3-12b`` (LOCAL ring caches) takes every mode but ``--paged``,
``--prefill-chunk``, ``--prefix`` and ``--spec-k``, which raise the
engine's errors for it, as its serving does.  ``--arch stablelm-3b`` (the
unfused LayerNorm path, head dim 80) and ``--arch deepseek-coder-33b``
(G 7, ~66.7 GB of bf16) take every mode; the int4 weights are drawn from
the same seed and quantized layer by layer once the bf16 ones are freed.
``--num-layers N`` cuts the stack to its first N layers at full widths
(grok-1-314b at 4 layers, ~42.6 GB of bf16, and arctic-480b at 2, ~55.4
GB, fit one card).  An MoE stack's eager and prefill lines add, from
the trace (``_moe_split``), the experts' products (``aten::bmm``), the
rest of the busy time and the ``aten::`` operators with the most device
time of their own, which name the dispatch glue; its int4 weights keep
the experts in bf16 (the rule quantizes 2-D ``w`` leaves only).

Weights are random (seed 0, router biases zeroed so routing skips, as
``chip_smoke.py`` serves them).  After a ``--batch`` × ``--prompt-len``
prefill and two warm-up steps, ``--steps`` decode steps run unprofiled and
then ``--steps`` more under the profiler, each window ending in one
synchronize.  A paged step is ``model.paged_decode_step`` over the prefill's
entries packed into pages of 16 (``paged.pack_prefill``, one
``PageAllocator`` chain per row, as the continuous engine keeps them),
reading the step's attention gates back to the host to append its entries,
as the engine does.  Prints one JSON line per weight or page type: wall ms
per step of both windows (host clock; the profiler's own host cost is the
difference), the host's enqueue ms per step (the profiled loop without its
final synchronize), the device's busy ms per step (the sum of its kernels'
and copies' durations in the trace), the idle share 1 − busy / wall
(against the unprofiled wall), device launches per step, paged
attention's own device ms and launches per step (its kernels' names
start with ``paged_``), the router's (names with ``router_``), and the
kernels with the most device time.

``--prefill`` runs the ``--batch`` × ``--prompt-len`` prefill as the
lock-step engine does (room for 32 new tokens), once to warm up, once
timed on the host clock and once under the profiler, and prints one JSON
line: wall ms, device busy ms (the sum of its kernels' and copies'
durations), idle share 1 − busy / wall, device launches, the SSD scan's
own device ms and launches (kernel names with ``ssd_scan``), the
router's (names with ``router_``), the kernels
with the most device time, and the PyTorch operators (``aten::``) with the
most device time of their own.  On the CPU there is no device trace: busy
and idle are null.

``--prefill --gather`` prints two such lines in one process on the same
weights: the masked prefill's, then the gather-mode prefill's (each routed
submodule on the top ``capacity(T, keep_prob)`` tokens only); each line
names its ``routing`` and the capacity C of T.

``--prefill --prefill-chunk C`` (with ``--batch 1``: the engine's chunks
are one request's) runs the ``--prompt-len`` prompt as the continuous
engine does: a staging cache of max_len (``--prompt-len`` + 32) rounded up
to a chunk multiple, then ``model.prefill_chunk`` per chunk of C tokens,
the final one right-padded (its inputs made on the device beforehand; the
engine copies them through pinned memory).  Warm-up, timed, profiled as
above, and the line adds the chunk count, the host's enqueue ms (the run
without its final synchronize) and per chunk: wall ms, enqueue ms, device
busy ms and launches.  The engine reads back nothing between a prompt's
chunks, so a chunk that is not the last costs its enqueue in ``prefill_s``
and its device time lands in the next decode sync.

``--prefill --prefix warm|cold`` (with ``--batch 1``) profiles one
admission of the paged continuous engine (4 slots, pages and prefix
blocks of 16, max_len the prompt + 32) of a prompt made of a
``--prompt-len``-token shared prefix and a ``--prefix-tail``-token tail of
its own, as a ``run()`` of that one request with one new token (the
prefill's own): ``warm``, with the prefix cache on and the prefix
published beforehand by another request's run, is the warm admission (the
boundary page's copy on write, the staging cache restored from the shared
pages, the suffix forward at its power-of-two width, the suffix's pack,
the republish); ``cold``, the cache off, is the monolithic prefill of the
whole prompt and its pack.  Every admission takes a fresh tail of the
same length, so every warm one hits the same record: a warm-up, three
timed (the median's wall, and its host ms and the ms it was blocked on
the device from ``ServeStats``), one profiled, and one with a
synchronize around each part.  One JSON line: those, prefill ms, device
busy ms, idle share, device launches, the kernels with the most device
time, and each part's wall ms (warm: ``cow``, ``restore``, ``forward``,
``pack``; cold: ``forward``, ``pack``).  One process each: run ``warm``
and ``cold`` as two commands.

``--paged --decode-steps N`` prints, for each page type, the eager paged
line and then a fused line over the same store (every page the epochs can
take reserved up front: one block-table width, one graph).
``--decode-steps N`` prints, for each weight type, the eager line above and
then a fused line: the prefill's cache becomes a dense pool of ``--batch``
slots, every slot active and free of stop tokens, and the epoch runs N
steps of ``decode_loop``'s body (greedy; one warm-up epoch captures the
graph), then ``max(2, --steps // N)`` epochs timed on the host clock and
as many under the profiler, each window ending in one synchronize, and
last one epoch launched onto an idle device: wall ms a step, host enqueue
ms a token (launching the profiled window's epochs, without its
synchronize, over its tokens: once the launch queue fills, the host waits
on the device, so this reads back-pressure), the last epoch's launch ms
on the host and a token of it (the host's own cost), device busy ms a
step and idle share as above, the timed window's device time on CUDA
events a step, graph replays and device launches a step, decode tok/s
(batch / wall a step) and the top kernels.  The eager line's tok/s is
batch / its wall a step too.

``--spec-k K`` (``--draft-keep``, ``--paged``) serves ``--batch``
requests of ``--prompt-len`` tokens (48 new tokens each, admitted
together) through the speculative engine and prints one JSON line of its
steady windows (``profile_spec``): window 2 timed (wall ms, the host's
enqueue ms up to the window's sync and each part's), window 3 traced as
it runs (device busy ms, idle share against window 2's wall, launches,
top kernels), window 4 traced with a synchronize after each part (each
part's wall, busy ms and launches); parts ``draft``, ``verify``,
``commit`` (paged) and ``other``; and the run's acceptance rate and
tokens a window.
"""
import argparse
import json
import time


def _profile_windows(model, step, steps: int, top: int, rec: dict) -> dict:
    """Two warm-up steps, ``steps`` unprofiled, ``steps`` profiled (``step(s)``
    runs decode step s); fills rec's timing and trace fields."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    cuda = dev.type == "cuda"

    def window(lo, hi):
        """Decode steps lo..hi-1: (seconds to enqueue, seconds to finish)."""
        t0 = time.perf_counter()
        for s in range(lo, hi):
            step(s)
        t1 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(dev)
        return t1 - t0, time.perf_counter() - t0

    window(0, 2)                                        # warm-up
    _, plain_s = window(2, steps + 2)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        enq_s, prof_s = window(steps + 2, 2 * steps + 2)
    rec.update({"steps": steps, "wall_ms_per_step": plain_s * 1e3 / steps,
                "decode_tok_per_s": rec["batch"] * steps / plain_s,
                "profiled_wall_ms_per_step": prof_s * 1e3 / steps,
                "host_enqueue_ms_per_step": enq_s * 1e3 / steps,
                "device_busy_ms_per_step": None, "idle_share": None,
                "device_launches_per_step": None,
                "paged_attention_ms_per_step": None,
                "paged_attention_launches_per_step": None,
                "router_ms_per_step": None,
                "router_launches_per_step": None,
                "top_kernels": None})
    by_name = _kernel_times(prof)
    if by_name:
        paged = [(us, cnt) for name, (us, cnt) in by_name.items()
                 if "paged_" in name]
        router = [(us, cnt) for name, (us, cnt) in by_name.items()
                  if "router_" in name]
        rec.update(_step_summary(by_name, steps, rec["wall_ms_per_step"],
                                 top),
                   paged_attention_ms_per_step=sum(
                       us for us, _ in paged) / 1e3 / steps,
                   paged_attention_launches_per_step=sum(
                       cnt for _, cnt in paged) / steps,
                   router_ms_per_step=sum(us for us, _ in router) / 1e3
                   / steps,
                   router_launches_per_step=sum(
                       cnt for _, cnt in router) / steps)
        if model.cfg.num_experts:
            rec["moe_per_step"] = _moe_split(
                prof, rec["device_busy_ms_per_step"] * steps, steps)
    return rec


def _kernel_times(prof) -> dict:
    """{kernel name: (device µs, launches)} of a profiled window (empty
    without a device trace)."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    return by_name


def _step_summary(by_name: dict, steps: int, wall_ms: float,
                  top: int) -> dict:
    """Busy ms a step, idle share against ``wall_ms`` a step, launches a
    step and the kernels with the most device time."""
    busy = sum(us for us, _ in by_name.values()) / 1e3 / steps
    return {"device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_launches_per_step": sum(
                cnt for _, cnt in by_name.values()) / steps,
            "top_kernels": [
                {"name": name[:80], "ms_per_step": us / 1e3 / steps,
                 "per_step": cnt / steps}
                for name, (us, cnt) in sorted(
                    by_name.items(), key=lambda kv: -kv[1][0])[:top]]}


def profile_fused(model, batch: int, prompt_len: int, n_steps: int,
                  epochs: int, top: int = 8, paged: bool = False,
                  kv_dtype=None) -> dict:
    """Fused decode epochs over a dense pool seeded by one ``batch`` ×
    ``prompt_len`` prefill (``paged``: over the paged store the prefill
    packs, in ``kv_dtype`` pages, every page the epochs can append to
    reserved up front, so one block-table width and one graph): one
    warm-up epoch (on the card: the eager warm-up iteration and the
    capture), ``epochs`` timed, ``epochs`` profiled, one launched onto an
    idle device."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import DecodeEpoch

    cfg, dev = model.cfg, model.device
    cuda = dev.type == "cuda"
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    max_len = prompt_len + (2 * epochs + 2) * n_steps + 1
    with torch.no_grad():
        if paged:
            logits, store, alloc = _paged_prefill(
                model, toks, max_len - prompt_len, kv_dtype)
            epoch = DecodeEpoch(model.params(), store, cfg, slots=batch,
                                n_max=n_steps, max_len=max_len, paged=True)
            extra = dict(fill=alloc.fill, block_table=alloc.block_table)
        else:
            logits, pool, _ = model.prefill(toks, pad_to=max_len)
            epoch = DecodeEpoch(model.params(), pool, cfg, slots=batch,
                                n_max=n_steps, max_len=max_len)
            extra = {}
        epoch.load(logits.argmax(-1), torch.full((batch,), prompt_len),
                   torch.ones((batch,), dtype=torch.bool),
                   torch.full((batch,), max_len), torch.full((batch,), -1),
                   **extra)

    def window(k):
        """k epochs: (seconds to enqueue, seconds to finish, event ms)."""
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if cuda else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        with torch.no_grad():
            for _ in range(k):
                epoch.run(n_steps)       # continues from its own carry
        if ev:
            ev[1].record()
        t1 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(dev)
        return (t1 - t0, time.perf_counter() - t0,
                ev[0].elapsed_time(ev[1]) if ev else None)

    window(1)                                           # warm-up + capture
    steps = epochs * n_steps
    r0 = epoch.replays
    _, plain_s, event_ms = window(epochs)
    replays = epoch.replays - r0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        enq_s, prof_s, _ = window(epochs)
    launch_s, _, _ = window(1)                  # the device idle before it
    wall_ms = plain_s * 1e3 / steps
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": batch,
           "prompt_len": prompt_len, "fused": True, "paged": paged,
           "kv_dtype": (kv_dtype or cfg.dtype) if paged else None,
           "decode_steps": n_steps,
           "epochs": epochs, "steps": steps, "wall_ms_per_step": wall_ms,
           "profiled_wall_ms_per_step": prof_s * 1e3 / steps,
           "host_enqueue_ms_per_token": enq_s * 1e3 / (steps * batch),
           "epoch_launch_ms": launch_s * 1e3,
           "epoch_launch_ms_per_token": launch_s * 1e3 / (n_steps * batch),
           "decode_tok_per_s": batch * 1e3 / wall_ms,
           "event_ms_per_step": (None if event_ms is None
                                 else event_ms / steps),
           "graph_replays_per_step": replays / steps,
           "graphs_captured": epoch.captures,
           "device_busy_ms_per_step": None, "idle_share": None,
           "device_launches_per_step": None, "top_kernels": None}
    by_name = _kernel_times(prof)
    if by_name:
        rec.update(_step_summary(by_name, steps, wall_ms, top))
    return rec


def _device_time_us(avg) -> float:
    """An operator's own device time in the profiler's averages (the
    attribute's name differs between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return float(getattr(avg, name))
    return 0.0


def _moe_split(prof, busy_ms: float, per: int, top: int = 16) -> dict:
    """An MoE stack's device time in a profiled window, over ``per`` (its
    steps, or 1): ``expert_bmm_ms`` (``aten::bmm``, the experts' products:
    nothing else of the port runs a batched product on the card),
    ``other_ms`` (the rest of the busy time: attention, the linears, the
    routers and the dispatch glue) and the ``aten::`` operators with the
    most device time of their own (the glue's: the expert choice's
    ``softmax`` and ``sort``, the positions' ``cumsum``, the dispatch's
    ``index_copy_``, the combine's ``index_select``)."""
    ops = [(a.key, _device_time_us(a) / 1e3 / per, a.count / per)
           for a in prof.key_averages() if a.key.startswith("aten::")]
    bmm = sum(ms for k, ms, _ in ops if k == "aten::bmm")
    return {"expert_bmm_ms": bmm, "other_ms": busy_ms / per - bmm,
            "top_ops": [{"op": k, "self_device_ms": ms, "calls": n}
                        for k, ms, n in sorted(ops, key=lambda o: -o[1])
                        if ms > 0][:top]}


def profile_prefill(model, batch: int, prompt_len: int, top: int = 8,
                    new_tokens: int = 32) -> dict:
    """One lock-step prefill of ``batch`` × ``prompt_len`` seeded tokens
    (cache room for ``new_tokens`` more, as ``ServeEngine`` gives it):
    warm-up, timed, profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = model.cfg, model.device
    cuda = dev.type == "cuda"
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)), device=dev)

    def run():
        t0 = time.perf_counter()
        with torch.no_grad():
            model.prefill(toks, pad_to=prompt_len + new_tokens)
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    run()                                               # warm-up
    wall_s = run()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        prof_s = run()
    from repro_torch.core.routing import capacity
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": batch,
           "prompt_len": prompt_len, "prefill": True,
           "routing": cfg.skip.mode,
           "capacity": (capacity(prompt_len, cfg.skip.keep_prob)
                        if cfg.skip.mode == "gather" else prompt_len),
           "wall_ms": wall_s * 1e3,
           "profiled_wall_ms": prof_s * 1e3, "device_busy_ms": None,
           "idle_share": None, "device_launches": None, "ssd_scan_ms": None,
           "ssd_scan_launches": None, "router_ms": None,
           "router_launches": None, "top_kernels": None, "top_ops": None}
    by_name = _kernel_times(prof)
    if by_name:
        busy = sum(us for us, _ in by_name.values()) / 1e3
        ssd = [(us, cnt) for name, (us, cnt) in by_name.items()
               if "ssd_scan" in name]
        router = [(us, cnt) for name, (us, cnt) in by_name.items()
                  if "router_" in name]
        ops = [(a.key, _device_time_us(a), a.count)
               for a in prof.key_averages() if a.key.startswith("aten::")]
        rec.update(
            device_busy_ms=busy, idle_share=1.0 - busy / rec["wall_ms"],
            device_launches=sum(cnt for _, cnt in by_name.values()),
            ssd_scan_ms=sum(us for us, _ in ssd) / 1e3,
            ssd_scan_launches=sum(cnt for _, cnt in ssd),
            router_ms=sum(us for us, _ in router) / 1e3,
            router_launches=sum(cnt for _, cnt in router),
            top_kernels=[{"name": name[:80], "ms": us / 1e3, "launches": cnt}
                         for name, (us, cnt) in sorted(
                             by_name.items(), key=lambda kv: -kv[1][0])[:top]],
            top_ops=[{"op": k, "self_device_ms": us / 1e3, "calls": n}
                     for k, us, n in sorted(ops, key=lambda o: -o[1])[:top]])
        if cfg.num_experts:
            rec["moe"] = _moe_split(prof, busy, 1)
    return rec


def profile_prefill_chunks(model, prompt_len: int, chunk: int,
                           top: int = 8, new_tokens: int = 32) -> dict:
    """One request's ``prompt_len`` seeded tokens prefilled ``chunk`` at a
    time through a staging cache, as the continuous engine runs them:
    warm-up, timed, profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as model_mod

    cfg, dev = model.cfg, model.device
    cuda = dev.type == "cuda"
    n = -(-prompt_len // chunk)
    cap = -(-(prompt_len + new_tokens) // chunk) * chunk
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, n * chunk)), device=dev)
    starts = [torch.tensor([i * chunk], dtype=torch.int32, device=dev)
              for i in range(n)]
    lasts = [torch.tensor([min(chunk, prompt_len - i * chunk) - 1],
                          device=dev) for i in range(n)]

    def run():
        t0 = time.perf_counter()
        with torch.no_grad():
            cache = model_mod.init_chunk_cache(cfg, 1, cap, dev)
            for i in range(n):
                _, cache, _ = model.prefill_chunk(
                    cache, toks[:, i * chunk:(i + 1) * chunk], starts[i],
                    last_index=lasts[i])
        enqueue = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, enqueue

    run()                                               # warm-up
    wall_s, enq_s = run()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        prof_s, _ = run()
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": 1,
           "prompt_len": prompt_len, "prefill_chunk": chunk, "chunks": n,
           "staging_rows": cap, "wall_ms": wall_s * 1e3,
           "enqueue_ms": enq_s * 1e3, "profiled_wall_ms": prof_s * 1e3,
           "wall_ms_per_chunk": wall_s * 1e3 / n,
           "enqueue_ms_per_chunk": enq_s * 1e3 / n,
           "device_busy_ms": None, "device_busy_ms_per_chunk": None,
           "idle_share": None, "device_launches_per_chunk": None,
           "top_kernels": None}
    by_name = _kernel_times(prof)
    if by_name:
        busy = sum(us for us, _ in by_name.values()) / 1e3
        rec.update(
            device_busy_ms=busy, device_busy_ms_per_chunk=busy / n,
            idle_share=1.0 - busy / rec["wall_ms"],
            device_launches_per_chunk=sum(
                cnt for _, cnt in by_name.values()) / n,
            top_kernels=[{"name": name[:80], "ms_per_chunk": us / 1e3 / n,
                          "per_chunk": cnt / n}
                         for name, (us, cnt) in sorted(
                             by_name.items(), key=lambda kv: -kv[1][0])[:top]])
    return rec


def profile_prefix(model, prefix_len: int, tail: int, warm: bool,
                   top: int = 8, new_tokens: int = 32) -> dict:
    """One warm (or cold) admission of a ``prefix_len`` + ``tail`` prompt
    through the paged engine: warm-up, timed, profiled, and one more with
    its parts synchronized and timed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kvcache import paged
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cfg, dev = model.cfg, model.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(np.int32)

    def prompt():
        return np.concatenate([head, rng.integers(
            0, cfg.vocab_size, (tail,)).astype(np.int32)])

    eng = ContinuousBatchingEngine(
        model, kv_mode="paged", max_slots=4, page_size=16, prefix_block=16,
        prefix_cache=warm, max_len=prefix_len + tail + new_tokens)
    eng.submit(prompt(), max_new_tokens=1)
    eng.run()                                   # publishes the prefix

    def admit():
        eng.submit(prompt(), max_new_tokens=1)
        t0 = time.perf_counter()
        out = eng.run()
        return time.perf_counter() - t0, out["stats"]

    admit()                                             # warm-up
    timed = sorted((admit() for _ in range(3)), key=lambda r: r[0])
    wall_s, st = timed[1]                               # the median
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        prof_s, _ = admit()
    parts = {}

    def part(label, fn):
        def timed(*a, **k):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if cuda:
                torch.cuda.synchronize(dev)
            parts[label] = parts.get(label, 0.0) + (
                time.perf_counter() - t0) * 1e3
            return out
        return timed

    names = (("cow", paged, "copy_page_masked"),
             ("restore", paged, "views_from_pages"),
             ("restore", paged, "chunk_cache_from_views"),
             ("forward", model, "prefill_chunk" if warm else "prefill"),
             ("pack", paged, "pack_prefill"))
    saved = [(obj, attr, getattr(obj, attr)) for _, obj, attr in names]
    for (label, obj, attr), (_, _, fn) in zip(names, saved):
        setattr(obj, attr, part(label, fn))
    try:
        admit()
    finally:
        for obj, attr, fn in saved:
            if obj is model:
                delattr(model, attr)
            else:
                setattr(obj, attr, fn)
    if st.prefix_hits != int(warm):
        raise RuntimeError(f"--prefix {'warm' if warm else 'cold'}: "
                           f"{st.prefix_hits} warm admissions in a run")
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": 1,
           "prefix": "warm" if warm else "cold", "prefix_len": prefix_len,
           "tail": tail, "prompt_len": prefix_len + tail,
           "wall_ms": wall_s * 1e3,
           "wall_ms_timed": [w * 1e3 for w, _ in timed],
           "host_ms": st.host_s * 1e3,
           "blocked_ms": st.device_s * 1e3, "prefill_ms": st.prefill_s * 1e3,
           "profiled_wall_ms": prof_s * 1e3, "parts_ms": parts,
           "prefix_tokens_saved": st.prefix_tokens_saved,
           "device_busy_ms": None, "idle_share": None,
           "device_launches": None, "top_kernels": None}
    by_name = _kernel_times(prof)
    if by_name:
        busy = sum(us for us, _ in by_name.values()) / 1e3
        rec.update(
            device_busy_ms=busy, idle_share=1.0 - busy / rec["wall_ms"],
            device_launches=sum(cnt for _, cnt in by_name.values()),
            top_kernels=[{"name": name[:80], "ms": us / 1e3, "launches": cnt}
                         for name, (us, cnt) in sorted(
                             by_name.items(), key=lambda kv: -kv[1][0])[:top]])
    return rec


SPEC_TIMED, SPEC_PROFILED, SPEC_SPLIT = 2, 3, 4   # window indices


def profile_spec(model, batch: int, prompt_len: int, spec_k: int,
                 draft_keep, paged: bool, top: int = 8,
                 new_tokens: int = 48) -> dict:
    """Steady windows of the speculative continuous engine (``batch``
    slots, ``batch`` requests of ``prompt_len`` tokens admitted together,
    ``new_tokens`` each): window SPEC_TIMED timed (wall, the host's enqueue
    up to the sync, each part's enqueue), SPEC_PROFILED traced as it runs
    (busy, idle, launches), SPEC_SPLIT traced with a synchronize after each
    part (each part's wall, busy ms and launches: the kernels that start
    inside the part's ``record_function`` range).  Parts: ``draft`` (the
    draft epoch: on the card graph replays), ``verify`` (the verify chunk
    forward, paged: with the staging cache's restore), ``commit`` (paged:
    ``commit_verified``), ``other`` (the rest up to the sync: argmax, the
    greedy accept on the device, transfers)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cfg, dev = model.cfg, model.device
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    eng = ContinuousBatchingEngine(
        model, kv_mode="paged" if paged else "dense", max_slots=batch,
        max_len=prompt_len + new_tokens, page_size=16, spec_k=spec_k,
        draft_keep=draft_keep)
    rng = np.random.default_rng(0)
    for _ in range(batch):
        eng.submit(rng.integers(0, cfg.vocab_size, (prompt_len,)).astype(
            np.int32), max_new_tokens=new_tokens)
    st = {"win": -1, "t0": 0.0, "enqueue": {}, "split_ms": {}, "prof": None}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def part(name, fn):
        def run(*a, **k):
            w = st["win"]
            if w == SPEC_SPLIT:
                sync()
                t0 = time.perf_counter()
                with record_function(f"spec_{name}"):
                    out = fn(*a, **k)
                    sync()
                st["split_ms"][name] = (st["split_ms"].get(name, 0.0)
                                        + (time.perf_counter() - t0) * 1e3)
                return out
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if w == SPEC_TIMED:
                st["enqueue"][name] = (st["enqueue"].get(name, 0.0)
                                       + (time.perf_counter() - t0) * 1e3)
            return out
        return run

    inputs, keep, fetch = eng._spec_inputs, eng._spec_bookkeep, \
        engine_mod._fetch

    def window_start():
        st["win"] += 1
        if st["win"] in (SPEC_PROFILED, SPEC_SPLIT):
            sync()
            st["prof"] = profile(activities=acts)
            st["prof"].start()
        st["t0"] = time.perf_counter()
        return inputs()

    def fetched(*a):
        if st["win"] == SPEC_TIMED:
            st["sync_at_ms"] = (time.perf_counter() - st["t0"]) * 1e3
        return fetch(*a)

    def bookkeep(rs, cur, gamma, plan_emit, accepted, gates, window_s,
                 *a, **k):
        w = st["win"]
        if w == SPEC_TIMED:
            st["wall_ms"], st["gamma"] = window_s * 1e3, gamma
        elif w in (SPEC_PROFILED, SPEC_SPLIT):
            st["prof"].stop()
            st[w] = (st["prof"], window_s * 1e3, gamma)
        return keep(rs, cur, gamma, plan_emit, accepted, gates, window_s,
                    *a, **k)

    verify = "paged_verify_chunk" if paged else "verify_chunk"
    commit = model_mod.commit_verified
    eng._spec_inputs, eng._spec_bookkeep = window_start, bookkeep
    eng._draft = part("draft", eng._draft)
    setattr(model, verify, part("verify", getattr(model, verify)))
    engine_mod._fetch = fetched
    model_mod.commit_verified = part("commit", commit)
    try:
        out = eng.run()
    finally:
        engine_mod._fetch, model_mod.commit_verified = fetch, commit
        delattr(model, verify)
    s = out["stats"]
    if st["win"] < SPEC_SPLIT:
        raise RuntimeError(f"--spec-k: only {st['win'] + 1} windows ran; "
                           "raise the new tokens")
    enq = dict(st["enqueue"])
    enq["other"] = st["sync_at_ms"] - sum(enq.values())
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": batch,
           "prompt_len": prompt_len, "kv": "paged" if paged else "dense",
           "spec_k": spec_k, "draft_keep": eng.draft_keep,
           "gamma": st["gamma"], "wall_ms": st["wall_ms"],
           "host_enqueue_ms": st["sync_at_ms"], "enqueue_ms_parts": enq,
           "tokens_per_window": None,
           "acceptance_rate": s.spec_acceptance_rate,
           "spec_windows": s.spec_windows, "graphs_captured": s.compiles,
           "device_busy_ms": None, "idle_share": None,
           "device_launches": None, "top_kernels": None,
           "split_wall_ms": st["split_ms"], "split_busy_ms": None,
           "split_launches": None}
    rec["tokens_per_window"] = (s.decode_tokens - batch) / s.spec_windows
    prof, prof_wall, _ = st[SPEC_PROFILED]
    by_name = _kernel_times(prof)
    if by_name:
        busy = sum(us for us, _ in by_name.values()) / 1e3
        rec.update(
            profiled_wall_ms=prof_wall, device_busy_ms=busy,
            idle_share=1.0 - busy / rec["wall_ms"],
            device_launches=sum(cnt for _, cnt in by_name.values()),
            top_kernels=[{"name": name[:80], "ms": us / 1e3, "launches": cnt}
                         for name, (us, cnt) in sorted(
                             by_name.items(), key=lambda kv: -kv[1][0])[:top]])
        rec.update(_split(st[SPEC_SPLIT][0]))
    return rec


def _split(prof) -> dict:
    """Per part of a window traced with a synchronize after each part: the
    device ms and launches of the kernels that start inside the part's
    ``record_function`` range (the rest under ``other``; the ranges' own
    device-side annotations are no kernels and are left out)."""
    from torch.autograd import DeviceType
    events = prof.events()
    ranges = [(e.name[len("spec_"):], e.time_range.start, e.time_range.end)
              for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("spec_")]
    busy, launches = {}, {}
    for e in events:
        # the device side of a record_function range is a CUDA event too
        if e.device_type != DeviceType.CUDA or e.name.startswith("spec_"):
            continue
        at = e.time_range.start
        name = next((n for n, lo, hi in ranges if lo <= at <= hi), "other")
        busy[name] = busy.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        launches[name] = launches.get(name, 0) + 1
    return {"split_busy_ms": busy, "split_launches": launches}


def _weights(model) -> str:
    """int4 where the lm head or the blocks' linears hold codes (a tied
    head, as gemma3-12b's, stays the embedding's transpose), else the
    dtype."""
    from repro_torch.quant import int4_head, int4_linears
    p = model.params()
    return ("int4" if int4_head(p) or int4_linears(p)
            else model.cfg.dtype)


def profile_steps(model, batch: int, prompt_len: int, steps: int,
                  top: int = 8) -> dict:
    import numpy as np
    import torch

    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, prompt_len)), device=dev)
    n = 2 * steps + 2
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n)),
                           device=dev)
    _, cache, _ = model.prefill(toks, pad_to=prompt_len + n)
    state = {"cache": cache}

    def step(s):
        _, state["cache"], _ = model.decode_step(
            state["cache"], feed[:, s:s + 1], prompt_len + s)

    return _profile_windows(model, step, steps, top, {
        "arch": cfg.name, "weights": _weights(model), "batch": batch,
        "prompt_len": prompt_len})


def _paged_prefill(model, toks, new: int, kv_dtype=None,
                   page_size: int = 16):
    """The prefill of ``toks`` [B, T] packed into a paged store of
    ``kv_dtype`` pages (None = the model's dtype), one allocator chain per
    row with room for ``new`` more tokens whose every entry is fresh; each
    chain's pages for them reserved.  Returns (the prefill's logits, the
    store, the allocator)."""
    import torch

    from repro_torch.kvcache import paged

    cfg, dev = model.cfg, model.device
    L = cfg.num_layers
    batch, prompt_len = toks.shape
    cap = (prompt_len + new + 1) * L               # every entry fresh
    per_slot = -(-cap // page_size)
    store = paged.init_store(cfg, batch * per_slot, page_size,
                             kv_dtype=kv_dtype, device=dev)
    alloc = paged.PageAllocator(batch * per_slot, page_size, batch,
                                slot_entry_capacity=cap)
    logits, cache, st = model.prefill(toks)
    gates = st["attn_gate"]                        # [L, B, T]
    for b in range(batch):
        g = gates[:, b]
        k = paged.prefill_entry_count(g.cpu().numpy(), prompt_len, True)
        alloc.ensure(b, k + L)
        paged.pack_prefill(store, [{n_: c[n_][b:b + 1] for n_ in ("k", "v")}
                                   for c in cache], g, prompt_len,
                           torch.as_tensor(alloc.block_table[b], device=dev),
                           cfg, kv_dtype=kv_dtype)
        alloc.append(b, k, L * prompt_len)
        alloc.ensure(b, k + new * L)
    return logits, store, alloc


def profile_paged_steps(model, batch: int, prompt_len: int, steps: int,
                        kv_dtype=None, page_size: int = 16,
                        top: int = 8) -> dict:
    """As ``profile_steps``, over ``model.paged_decode_step``: the prefill's
    entries packed into pages of ``kv_dtype`` (None = the model's dtype),
    one allocator chain per row (``_paged_prefill``)."""
    import numpy as np
    import torch

    cfg, dev = model.cfg, model.device
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, prompt_len)), device=dev)
    n = 2 * steps + 2
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n)),
                           device=dev)
    _, store, alloc = _paged_prefill(model, toks, n, kv_dtype, page_size)
    state = {"store": store}

    def step(s):
        for b in range(batch):
            alloc.ensure(b, int(alloc.fill[b]) + L)
        _, state["store"], st = model.paged_decode_step(
            state["store"], feed[:, s:s + 1], prompt_len + s,
            torch.as_tensor(alloc.block_table), torch.as_tensor(alloc.fill))
        g = st["attn_gate"].cpu()                  # [L, B]
        for b in range(batch):
            alloc.append(b, int(1 + g[1:, b].sum()), L)

    return _profile_windows(model, step, steps, top, {
        "arch": cfg.name, "weights": _weights(model), "batch": batch,
        "prompt_len": prompt_len, "paged": True,
        "kv_dtype": kv_dtype or cfg.dtype, "page_size": page_size})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="paged decode steps in bf16, int8 and int4 pages "
                         "(with --decode-steps: and fused epochs over them)")
    ap.add_argument("--prefill", action="store_true",
                    help="one lock-step prefill of the bf16 weights")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --prefill: one request's prompt in chunks "
                         "of C (needs --batch 1)")
    ap.add_argument("--gather", action="store_true",
                    help="with --prefill: the masked prefill's line, then "
                         "the gather-mode prefill's, on the same weights")
    ap.add_argument("--prefix", choices=("warm", "cold"), default=None,
                    help="with --prefill: one admission of the paged "
                         "engine with the prefix cache on (warm, the "
                         "--prompt-len prefix published) or off (cold)")
    ap.add_argument("--prefix-tail", type=int, default=64,
                    help="with --prefix: the prompt's own tail past the "
                         "shared --prompt-len prefix")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="also fused epochs of N decode steps (CUDA graphs "
                         "on the card) beside the eager steps")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="steady windows of the speculative continuous "
                         "engine instead (dense pool, or --paged bf16 "
                         "pages), split into draft, verify and commit")
    ap.add_argument("--draft-keep", type=float, default=None,
                    help="with --spec-k: the draft pass's keep lever")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the stack to its first N layers, widths "
                         "kept (a model whose weights do not fit one card)")
    args = ap.parse_args(argv)
    if args.spec_k < 0 or (args.spec_k and (args.prefill
                                            or args.decode_steps)):
        raise SystemExit("--spec-k takes K >= 1 and neither --prefill nor "
                         "--decode-steps")
    if args.draft_keep is not None and not args.spec_k:
        raise SystemExit("--draft-keep requires --spec-k")
    if args.decode_steps < 0 or (args.decode_steps and args.prefill):
        raise SystemExit("--decode-steps takes N >= 1 and no --prefill")
    if args.prefill_chunk and (args.prefill_chunk < 0 or not args.prefill
                               or args.batch != 1):
        raise SystemExit("--prefill-chunk takes C >= 1 with --prefill and "
                         "--batch 1")
    if args.prefix and (not args.prefill or args.batch != 1
                        or args.prefill_chunk or args.prefix_tail < 1):
        raise SystemExit("--prefix takes --prefill, --batch 1, no "
                         "--prefill-chunk and --prefix-tail >= 1")

    if args.gather and (not args.prefill or args.prefill_chunk
                        or args.prefix):
        raise SystemExit("--gather takes --prefill, without "
                         "--prefill-chunk or --prefix (gather-mode "
                         "capacity depends on the whole prompt)")

    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models import transformer
    from repro_torch.models.model import LanguageModel

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    model = LanguageModel(cfg, device=args.device, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=args.device)
    if args.spec_k:
        print(json.dumps(profile_spec(
            model, args.batch, args.prompt_len, args.spec_k,
            args.draft_keep, args.paged)), flush=True)
        return
    if args.prefix:
        print(json.dumps(profile_prefix(
            model, args.prompt_len, args.prefix_tail,
            args.prefix == "warm")), flush=True)
        return
    if args.prefill:
        rec = (profile_prefill_chunks(model, args.prompt_len,
                                      args.prefill_chunk)
               if args.prefill_chunk else
               profile_prefill(model, args.batch, args.prompt_len))
        print(json.dumps(rec), flush=True)
        if args.gather:
            gather = LanguageModel(dataclasses.replace(
                cfg, skip=dataclasses.replace(cfg.skip, mode="gather")),
                model.params(), device=args.device)
            print(json.dumps(profile_prefill(gather, args.batch,
                                             args.prompt_len)), flush=True)
        return
    if args.paged:
        if transformer.is_ssm_stack(cfg):
            raise SystemExit("--paged: a Mamba stack keeps no KV pages")
        from repro_torch.kvcache import paged
        if not paged.can_page(cfg):      # LOCAL ring layers (gemma3-12b)
            raise ValueError(
                f"{cfg.name}: paged KV requires an all-global-attention "
                "stack with masked-mode routing — use kv_mode='dense'")
        for kd in (None, "int8", "int4"):
            print(json.dumps(profile_paged_steps(
                model, args.batch, args.prompt_len, args.steps, kd)),
                flush=True)
            if args.decode_steps:
                print(json.dumps(profile_fused(
                    model, args.batch, args.prompt_len, args.decode_steps,
                    max(2, args.steps // args.decode_steps), paged=True,
                    kv_dtype=kd)), flush=True)
        return
    def lines(m):
        print(json.dumps(profile_steps(m, args.batch, args.prompt_len,
                                       args.steps)), flush=True)
        if args.decode_steps:
            print(json.dumps(profile_fused(
                m, args.batch, args.prompt_len, args.decode_steps,
                max(2, args.steps // args.decode_steps))), flush=True)

    lines(model)
    if transformer.is_ssm_stack(cfg):
        return                      # int4 Mamba weights: ROADMAP item 13b
    # the same seed quantized layer by layer as drawn (the tree
    # quantize_params gives the bf16 one), once the bf16 weights are
    # freed: deepseek-coder-33b's would not fit beside its codes
    del model
    if args.device != "cpu":
        torch.cuda.empty_cache()
    q = LanguageModel(cfg, device=args.device, seed=0, int4=True)
    q = LanguageModel(cfg, neutral_router_bias(q.params()),
                      device=args.device)
    lines(q)


if __name__ == "__main__":
    main()
