"""Where a decode step's time goes: ``torch.profiler`` over a window of
teacher-forced decode steps of one model, in bf16 weights and the same
weights quantized to int4-BFP, one after the other in one process (a
Mamba stack, whose int4 weights are not served yet, in bf16 only); with
``--paged``, teacher-forced paged decode steps of the bf16 weights over a
store packed from the prefill, in bf16, int8 and int4 pages; with
``--prefill``, one lock-step prefill of the bf16 weights instead (with
``--prefill-chunk C``, one request's prompt in chunks of C, as the
continuous engine prefills it); with ``--decode-steps N``, fused N-step decode epochs (``model.DecodeEpoch``: on
the card a CUDA graph of one decode iteration, replayed) beside the eager
steps, in the same process.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --batch 4 --prompt-len 512 --steps 8   # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --paged                                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch mamba2-2.7b                                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch mamba2-2.7b --prefill                             # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --prefill --prefill-chunk 128 --batch 1 # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --decode-steps 8                        # on the card
  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      --arch llama2-7b --smoke --device cpu [--paged]          # plain versions

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
                  epochs: int, top: int = 8) -> dict:
    """Fused decode epochs over a dense pool seeded by one ``batch`` ×
    ``prompt_len`` prefill: one warm-up epoch (on the card: the eager
    warm-up iteration and the capture), ``epochs`` timed, ``epochs``
    profiled, one launched onto an idle device."""
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
        logits, pool, _ = model.prefill(toks, pad_to=max_len)
        epoch = DecodeEpoch(model.params(), pool, cfg, slots=batch,
                            n_max=n_steps, max_len=max_len)
        epoch.load(logits.argmax(-1), torch.full((batch,), prompt_len),
                   torch.ones((batch,), dtype=torch.bool),
                   torch.full((batch,), max_len), torch.full((batch,), -1))

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
           "prompt_len": prompt_len, "fused": True, "decode_steps": n_steps,
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
    rec = {"arch": cfg.name, "weights": _weights(model), "batch": batch,
           "prompt_len": prompt_len, "prefill": True, "wall_ms": wall_s * 1e3,
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


def _weights(model) -> str:
    return ("int4" if "w_int" in model.params().get("lm_head", {})
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


def profile_paged_steps(model, batch: int, prompt_len: int, steps: int,
                        kv_dtype=None, page_size: int = 16,
                        top: int = 8) -> dict:
    """As ``profile_steps``, over ``model.paged_decode_step``: the prefill's
    entries packed into pages of ``kv_dtype`` (None = the model's dtype),
    one allocator chain per row."""
    import numpy as np
    import torch

    from repro_torch.kvcache import paged

    cfg, dev = model.cfg, model.device
    L = cfg.num_layers
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, prompt_len)), device=dev)
    n = 2 * steps + 2
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n)),
                           device=dev)
    cap = (prompt_len + n + 1) * L                 # every entry fresh
    per_slot = -(-cap // page_size)
    store = paged.init_store(cfg, batch * per_slot, page_size,
                             kv_dtype=kv_dtype, device=dev)
    alloc = paged.PageAllocator(batch * per_slot, page_size, batch,
                                slot_entry_capacity=cap)
    _, cache, st = model.prefill(toks)
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
    del cache
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
                    help="paged decode steps in bf16, int8 and int4 pages")
    ap.add_argument("--prefill", action="store_true",
                    help="one lock-step prefill of the bf16 weights")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --prefill: one request's prompt in chunks "
                         "of C (needs --batch 1)")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="also fused epochs of N decode steps (CUDA graphs "
                         "on the card) beside the eager steps")
    args = ap.parse_args(argv)
    if args.decode_steps < 0 or (args.decode_steps
                                 and (args.paged or args.prefill)):
        raise SystemExit("--decode-steps takes N >= 1 and neither --paged "
                         "nor --prefill")
    if args.prefill_chunk and (args.prefill_chunk < 0 or not args.prefill
                               or args.batch != 1):
        raise SystemExit("--prefill-chunk takes C >= 1 with --prefill and "
                         "--batch 1")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models import transformer
    from repro_torch.models.model import LanguageModel
    from repro_torch.quant import quantize_params

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = LanguageModel(cfg, device=args.device, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=args.device)
    if args.prefill:
        print(json.dumps(
            profile_prefill_chunks(model, args.prompt_len, args.prefill_chunk)
            if args.prefill_chunk else
            profile_prefill(model, args.batch, args.prompt_len)), flush=True)
        return
    if args.paged:
        if transformer.is_ssm_stack(cfg):
            raise SystemExit("--paged: a Mamba stack keeps no KV pages")
        for kd in (None, "int8", "int4"):
            print(json.dumps(profile_paged_steps(
                model, args.batch, args.prompt_len, args.steps, kd)),
                flush=True)
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
    q = LanguageModel(cfg, quantize_params(
        model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
        device=args.device)
    del model
    if q.device.type == "cuda":
        torch.cuda.empty_cache()
    lines(q)


if __name__ == "__main__":
    main()
