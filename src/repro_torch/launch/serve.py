"""Serving launcher of the port: lock-step batched generation, or continuous
batching over the dense slot pool or the paged §4.4 KV store.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --batch 4 --prompt-len 512 --new-tokens 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu                                 # plain versions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu --continuous --paged-kv --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --int4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --batch 4 --prompt-len 512 --continuous            # dense slot pool
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --decode-steps 8                # CUDA graph epochs
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --batch 4 --prompt-len 512 --continuous --prefill-chunk 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --paged-kv --prefix-cache        # shared prompt prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --spec-k 4 [--draft-keep 0.5]    # self-speculative
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --trace-out trace.json --metrics-out metrics.prom
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --deadline-s 2 --max-queue-depth 6 --max-preemptions 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --paged-kv --decode-steps 8 --snapshot-dir snaps \
      --kill-at 6                                 # exits with code 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --continuous --paged-kv --decode-steps 8 --snapshot-dir snaps --resume
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --batch 4 --prompt-len 512 --gather              # compacted prefill
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --continuous --paged-kv                          # qk-norm, GQA
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
      --batch 2 --prompt-len 1536 --continuous --decode-steps 8  # LOCAL rings
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
      --continuous --paged-kv --kv-dtype int4        # LayerNorm, dh 80
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-coder-33b --int4 --continuous  # GQA 7, ~34 GB

``--arch`` defaults to llama2-7b (also: qwen3-8b, gemma3-12b, stablelm-3b,
deepseek-coder-33b, grok-1-314b, arctic-480b, mamba2-2.7b).  grok-1-314b
and arctic-480b are top-2 MoE stacks (8 GeGLU experts; 128 SwiGLU experts
beside a dense residual MLP), served in every loop llama2-7b is; at their
published depth (~633 GB and ~954 GB of bf16) neither fits one card, so
serve them ``--smoke``, or at full widths with ``--num-layers N`` (their
first N layers: grok-1-314b at 4, ~42.6 GB, and arctic-480b at 2, ~55.4 GB,
fit one 80 GB card).  ``--int4`` leaves their experts in bf16.
stablelm-3b (LayerNorm, head dim 80,
partial rotary) runs the unfused path in every loop llama2-7b runs;
deepseek-coder-33b (56 query heads over 8 kv heads) is llama-arch at
~66.7 GB of bf16 weights.  gemma3-12b (5 sliding-window LOCAL layers a global one,
head dim 256, GeGLU) serves lock-step and from the dense pool (single-step
and ``--decode-steps``); ``--paged-kv``, ``--prefill-chunk``, ``--spec-k``
and ``--prefix-cache`` raise the reference's errors for it.  Weights
are random, drawn from seed 0 on the chosen device.  ``--gather`` runs
gather-mode routing, as the reference's launcher does: each routed
submodule of a prefill runs on the top-capacity tokens by router score
only (``capacity(T, keep_prob)`` of T), decode steps stay masked; it
serves lock-step and from the dense pool, and ``--paged-kv``,
``--prefill-chunk`` and ``--spec-k`` raise the reference's errors for it.
``--int4``
quantizes every linear weight of the model (all layers and the lm head) to
int4 codes with the config's group size and power-of-2 scales, layer by
layer as the weights are drawn (the dense tree is never whole on the
card), served by the int4-BFP kernels (the int4 matmul on the unfused
path).  With ``--continuous`` the engine serves 2·batch
requests of mixed prompt lengths (prompt_len/4 to prompt_len) over
``--batch`` slots; ``--decode-steps N`` > 1 decodes in device-resident
epochs of up to N steps, one host sync each (on CUDA one captured graph
of a decode iteration, replayed); ``--prefill-chunk C`` > 0 prefills C
tokens an iteration, interleaved with the residents' decode steps.
``--spec-k K`` decodes in self-speculative windows: up to K draft
iterations under router biases raised by ``--draft-keep`` (a captured
graph on CUDA), one verify chunk of the full model, the accepted prefix
and a correction emitted per slot.
``--prefix-cache`` (with ``--paged-kv``) shares published prompt prefixes
as refcounted pages; the requests then open with one shared system prompt
of half their length, so every request after the first is admitted warm.
``--trace-out FILE`` writes the run's Chrome trace (host-time spans:
``step`` ⊃ plan / prefill / dispatch / sync / bookkeep, one track per
request; ``tools/trace_summary.py FILE`` summarizes it), ``--metrics-out
FILE`` its metrics registry (``.prom``: Prometheus text, else JSON) and
``--results-out FILE`` each request's tokens and finish reason as JSON.
``--deadline-s`` gives every request a wall-clock budget (past it:
finish reason "deadline", partial tokens kept), ``--max-queue-depth`` /
``--max-queue-delay-s`` shed submissions (counted, not served) and
``--max-preemptions`` retires a request preempted more often (finish
reason "preempt_budget").  ``--snapshot-dir DIR`` publishes a
crash-consistent snapshot every ``--snapshot-every`` boundaries,
``--kill-at N`` injects a host kill at boundary N after its snapshot (the
process exits with code 3), ``--resume`` continues the newest snapshot
under ``--snapshot-dir`` instead of submitting requests (at temperature 0
its requests' tokens are the uninterrupted run's), and
``--watchdog-timeout-s`` aborts a run whose dispatch-to-sync time exceeds
the bound (``HungDispatch``).  These need ``--continuous``.
``mamba2-2.7b`` (attention-free) serves lock-step or
from the dense pool, prefilling at the exact prompt length; ``--paged-kv``
raises for it (no KV to page), and so does ``--int4`` (not ported yet).
"""
import argparse
import dataclasses

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a --batch-slot KV pool "
                         "(mixed prompt lengths)")
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged KV store + history buffer instead of the "
                         "dense slot pool")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size (default: the dense pool's worst "
                         "case)")
    ap.add_argument("--kv-dtype", default=None, choices=("int8", "int4"),
                    help="quantize paged-KV page payloads (per-entry pow2 "
                         "scales; requires --paged-kv)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prompt-prefix sharing with "
                         "copy-on-write pages: warm admissions skip the "
                         "shared prefill (requires --paged-kv)")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix-cache publish granularity in tokens")
    ap.add_argument("--decode-steps", type=int, default=None,
                    help="decode iterations fused into one device-resident "
                         "epoch (default: the config's "
                         "decode_steps_per_dispatch; 1 = single-step; "
                         "requires --continuous)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft this many "
                         "tokens a window with the layer-skip draft pass, "
                         "verify them in one chunk forward (0 = off; "
                         "requires --continuous, incompatible with "
                         "--decode-steps)")
    ap.add_argument("--draft-keep", type=float, default=None,
                    help="draft-pass router keep-rate lever in (0, 1]: "
                         "lower = more aggressively skipped drafts at "
                         "lower acceptance (default: the serve keep rate; "
                         "requires --spec-k)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: process prompts this many "
                         "tokens at a time, interleaved with resident "
                         "decode steps (0 = monolithic; requires "
                         "--continuous)")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the stack to its first N layers, widths "
                         "kept (a model whose weights do not fit one card)")
    ap.add_argument("--int4", action="store_true",
                    help="int4-BFP weights: quantize_params at the config's "
                         "QuantConfig (group size, pow2 scales)")
    ap.add_argument("--gather", action="store_true",
                    help="compacted (gather) prefill execution: each routed "
                         "submodule runs on the top-capacity tokens only")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Chrome trace-event JSON of the run "
                         "(host-time spans; tools/trace_summary.py reads "
                         "it; requires --continuous)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the run's metrics snapshot (.prom suffix "
                         "= Prometheus text format, else JSON; requires "
                         "--continuous)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget from submission; "
                         "past it a request finishes with reason "
                         "'deadline' and releases its slot/pages at the "
                         "next step boundary")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="shed new submissions once the queue is this "
                         "deep")
    ap.add_argument("--max-queue-delay-s", type=float, default=None,
                    help="shed new submissions once the queue head has "
                         "waited past this bound")
    ap.add_argument("--max-preemptions", type=int, default=None,
                    help="per-request eviction retry budget; past it a "
                         "victim keeps its partial tokens (reason "
                         "'preempt_budget') instead of requeueing")
    ap.add_argument("--results-out", default=None, metavar="FILE",
                    help="write per-request results (tokens, finish "
                         "reason) as JSON")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="write crash-consistent engine snapshots at "
                         "quiescent step boundaries (resume with --resume)")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="boundaries between snapshots (default 1)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest snapshot under "
                         "--snapshot-dir instead of submitting fresh "
                         "requests; at temperature 0 the survivors' tokens "
                         "are those of the uninterrupted run")
    ap.add_argument("--kill-at", type=int, default=None, metavar="N",
                    help="inject a SimulatedKill at step boundary N (after "
                         "its snapshot): the process exits with code 3")
    ap.add_argument("--watchdog-timeout-s", type=float, default=None,
                    help="hard bound on one dispatch-to-sync time; past it "
                         "the run aborts with HungDispatch (trace path "
                         "attached)")
    args = ap.parse_args(argv)
    if args.paged_kv and not args.continuous:
        raise SystemExit("--paged-kv requires --continuous")
    if (args.kv_dtype or args.num_pages) and not args.paged_kv:
        raise SystemExit("--kv-dtype/--num-pages require --paged-kv")
    if args.prefix_cache and not args.paged_kv:
        raise SystemExit("--prefix-cache requires --paged-kv")
    if args.decode_steps is not None and not args.continuous:
        raise SystemExit("--decode-steps requires --continuous")
    if args.prefill_chunk and not args.continuous:
        raise SystemExit("--prefill-chunk requires --continuous")
    if args.spec_k and not args.continuous:
        raise SystemExit("--spec-k requires --continuous")
    if args.spec_k and args.decode_steps is not None:
        raise SystemExit("--spec-k and --decode-steps are mutually "
                         "exclusive (both own the decode cadence)")
    if args.draft_keep is not None and not args.spec_k:
        raise SystemExit("--draft-keep requires --spec-k")
    lifecycle = (args.trace_out, args.metrics_out, args.deadline_s,
                 args.max_queue_depth, args.max_queue_delay_s,
                 args.max_preemptions, args.results_out, args.snapshot_dir,
                 args.kill_at, args.watchdog_timeout_s, args.resume or None)
    if any(v is not None for v in lifecycle) and not args.continuous:
        raise SystemExit("--trace-out/--metrics-out/--deadline-s/"
                         "--max-queue-*/--max-preemptions/--results-out/"
                         "--snapshot-dir/--resume/--kill-at/"
                         "--watchdog-timeout-s require --continuous")
    if args.resume and args.snapshot_dir is None:
        raise SystemExit("--resume requires --snapshot-dir")

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.config import (EngineConfig, KVConfig, ObsConfig,
                                          RobustnessConfig, SchedulingConfig,
                                          SpecConfig)
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serve.errors import (AdmissionRejected, ConfigError,
                                          SimulatedKill)
    from repro_torch.serve.faults import Fault, Watchdog

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.gather:
        cfg = dataclasses.replace(
            cfg, skip=dataclasses.replace(cfg.skip, mode="gather"))
    if args.int4 and transformer.is_ssm_stack(cfg):
        raise ConfigError(f"{cfg.name}: int4 weights on a Mamba stack are "
                          "not ported to repro_torch yet (ROADMAP queue 1 "
                          "item 13b)")
    model = LanguageModel(cfg, device=args.device, seed=0, int4=args.int4)
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.new_tokens
    print(f"{cfg.name}: routing: {cfg.skip.mode} (keep "
          f"{cfg.skip.keep_prob}), {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} kv heads, qk-norm {cfg.qk_norm}")
    if args.continuous:
        eng = ContinuousBatchingEngine(model, config=EngineConfig(
            kv=KVConfig(kv_mode="paged" if args.paged_kv else "dense",
                        page_size=args.page_size, num_pages=args.num_pages,
                        kv_dtype=args.kv_dtype,
                        prefix_cache=args.prefix_cache,
                        prefix_block=args.prefix_block),
            scheduling=SchedulingConfig(max_slots=args.batch,
                                        max_len=max_len,
                                        prefill_chunk=args.prefill_chunk,
                                        decode_steps=args.decode_steps),
            spec=SpecConfig(spec_k=args.spec_k, draft_keep=args.draft_keep),
            robustness=RobustnessConfig(
                faults=([Fault("kill", step=args.kill_at)]
                        if args.kill_at is not None else None),
                watchdog=(Watchdog(timeout_s=args.watchdog_timeout_s)
                          if args.watchdog_timeout_s is not None else None),
                snapshot_dir=args.snapshot_dir,
                snapshot_every=args.snapshot_every,
                max_queue_depth=args.max_queue_depth,
                max_queue_delay_s=args.max_queue_delay_s,
                max_preemptions=args.max_preemptions),
            obs=ObsConfig(trace=args.trace_out),
            temperature=args.temperature))
        if args.resume:
            at = eng.resume()
            print(f"resumed from snapshot boundary {at} under "
                  f"{args.snapshot_dir}")
        else:
            _submit_traffic(args, cfg, eng, rng, AdmissionRejected)
        try:
            out = eng.run()
        except SimulatedKill as e:
            print(f"simulated kill: {e}")
            raise SystemExit(3)
        s = out["stats"]
        print(f"prefill: {s.prefill_tokens} tok in {s.prefill_s:.2f}s | "
              f"decode: {s.decode_tok_per_s:.1f} tok/s | "
              f"requests: {s.requests_completed} | "
              f"KV storage saved≈{s.kv_saved_fraction:.1%} (measured)")
        print(f"decode: {s.decode_dispatches} dispatches for "
              f"{s.decode_iterations} steps | graphs captured "
              f"{s.compiles}, replays {s.graph_replays} | host "
              f"{s.host_s:.2f}s, blocked on the device {s.device_s:.2f}s")
        if args.prefill_chunk:
            worst = max(r.max_decode_stall_s for r in out["results"].values())
            print(f"chunked prefill: {s.prefill_chunks} chunks | "
                  f"{s.interleaved_steps} interleaved steps | worst "
                  f"decode stall {worst*1e3:.1f}ms")
        if args.spec_k:
            print(f"speculative: {s.spec_windows} windows | drafted "
                  f"{s.spec_tokens_drafted}, accepted "
                  f"{s.spec_tokens_accepted} (rate "
                  f"{s.spec_acceptance_rate:.1%}) | rolled back "
                  f"{s.spec_entries_rolled_back} paged entries")
        if s.kv_mode == "paged":
            print(f"paged KV: peak {s.pages_peak}/{s.pages_total} pages "
                  f"(×{s.page_size} entries) | live entry saving "
                  f"{s.kv_entries_saved_fraction:.1%} | history hit rate "
                  f"{s.history_hit_rate:.1%} | preemptions "
                  f"{s.preemptions}")
        if args.prefix_cache:
            print(f"prefix cache: {s.prefix_hits} warm / "
                  f"{s.prefix_misses} cold admissions | "
                  f"{s.prefix_tokens_saved} prefill tokens skipped | "
                  f"{s.prefix_records} records resident")
        if args.kv_dtype:
            print(f"quantized KV: {args.kv_dtype} page payloads "
                  "(pow2 per-entry scales)")
        if (s.requests_cancelled or s.deadline_exceeded or s.requests_shed
                or s.preempt_budget_exhausted):
            print(f"lifecycle: deadline {s.deadline_exceeded} | cancelled "
                  f"{s.requests_cancelled} | shed {s.requests_shed} | "
                  f"preempt budget {s.preempt_budget_exhausted}")
        if (s.faults_injected or s.watchdog_strikes or s.snapshots
                or s.resumes):
            print(f"robustness: faults {s.faults_injected} | retries "
                  f"{s.dispatch_retries} | watchdog strikes "
                  f"{s.watchdog_strikes} | snapshots {s.snapshots} | "
                  f"resumes {s.resumes}")
        for uid, r in sorted(out["results"].items()):
            print(f"  req {uid}: T0={r.prompt_len} +{r.decode_tokens} "
                  f"TTFT {r.ttft_s*1e3:.1f}ms ({r.finish_reason})")
        _write_outputs(args, out)
        return
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len), dtype=np.int32)
    eng = ServeEngine(model, max_len=max_len, temperature=args.temperature)
    out = eng.generate(prompts, args.new_tokens)
    s = out["stats"]
    print(f"prefill: {s.prefill_tokens} tok in {s.prefill_s:.2f}s | "
          f"decode: {s.decode_tok_per_s:.1f} tok/s | "
          f"attn keep≈{s.attn_keep_frac:.2f} | "
          f"KV storage saved≈{s.kv_saved_fraction:.1%} (measured; "
          f"analytic≈{s.kv_saved_analytic:.1%})")
    print("sample:", out["tokens"][0, :16])


def _submit_traffic(args, cfg, eng, rng, rejected) -> None:
    """2·batch requests of prompt_len/4 to prompt_len tokens (with
    ``--prefix-cache`` opening with one shared half-length prompt)."""
    shared = (rng.integers(0, cfg.vocab_size, (args.prompt_len // 2,),
                           dtype=np.int32) if args.prefix_cache
              else np.zeros((0,), np.int32))
    for _ in range(2 * args.batch):
        ln = int(rng.integers(max(args.prompt_len // 4, 1),
                              args.prompt_len + 1))
        try:
            eng.submit(np.concatenate([shared, rng.integers(
                0, cfg.vocab_size, (max(ln - len(shared), 1),),
                dtype=np.int32)]), max_new_tokens=args.new_tokens,
                deadline_s=args.deadline_s)
        except rejected as e:
            print(f"shed: {e}")


def _write_outputs(args, out) -> None:
    """--results-out, --metrics-out; the engine saved --trace-out."""
    import json
    import pathlib
    if args.results_out:
        path = pathlib.Path(args.results_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {str(uid): {"tokens": [int(t) for t in r.tokens],
                        "prompt_len": r.prompt_len,
                        "finish_reason": r.finish_reason}
             for uid, r in sorted(out["results"].items())}, indent=1))
        print(f"results written to {args.results_out}")
    if args.trace_out:
        print(f"trace written to {args.trace_out}")
    if args.metrics_out:
        path = pathlib.Path(args.metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".prom":
            path.write_text(out["metrics"].to_prometheus())
        else:
            path.write_text(json.dumps(out["metrics"].snapshot(), indent=2))
        print(f"metrics written to {args.metrics_out}")


if __name__ == "__main__":
    main()
