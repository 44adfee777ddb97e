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

Weights are random, drawn from seed 0 on the chosen device; ``--int4``
quantizes every linear weight of the model (all layers and the lm head) to
int4 codes with the config's group size and power-of-2 scales, served by
the int4-BFP kernels.  With ``--continuous`` the engine serves 2·batch
requests of mixed prompt lengths (prompt_len/4 to prompt_len) over
``--batch`` slots; ``--decode-steps N`` > 1 decodes in device-resident
epochs of up to N steps, one host sync each (on CUDA one captured graph
of a decode iteration, replayed); ``--prefill-chunk C`` > 0 prefills C
tokens an iteration, interleaved with the residents' decode steps.
``mamba2-2.7b`` (attention-free) serves lock-step or
from the dense pool, prefilling at the exact prompt length; ``--paged-kv``
raises for it (no KV to page), and so does ``--int4`` (not ported yet).
"""
import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
    ap.add_argument("--decode-steps", type=int, default=None,
                    help="decode iterations fused into one device-resident "
                         "epoch (default: the config's "
                         "decode_steps_per_dispatch; 1 = single-step; "
                         "requires --continuous)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: process prompts this many "
                         "tokens at a time, interleaved with resident "
                         "decode steps (0 = monolithic; requires "
                         "--continuous)")
    ap.add_argument("--int4", action="store_true",
                    help="int4-BFP weights: quantize_params at the config's "
                         "QuantConfig (group size, pow2 scales)")
    args = ap.parse_args(argv)
    if args.paged_kv and not args.continuous:
        raise SystemExit("--paged-kv requires --continuous")
    if (args.kv_dtype or args.num_pages) and not args.paged_kv:
        raise SystemExit("--kv-dtype/--num-pages require --paged-kv")
    if args.decode_steps is not None and not args.continuous:
        raise SystemExit("--decode-steps requires --continuous")
    if args.prefill_chunk and not args.continuous:
        raise SystemExit("--prefill-chunk requires --continuous")

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.config import (EngineConfig, KVConfig,
                                          SchedulingConfig)
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serve.errors import ConfigError

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.int4 and transformer.is_ssm_stack(cfg):
        raise ConfigError(f"{cfg.name}: int4 weights on a Mamba stack are "
                          "not ported to repro_torch yet (ROADMAP queue 1 "
                          "item 13b)")
    model = LanguageModel(cfg, device=args.device, seed=0)
    if args.int4:
        from repro_torch.quant import quantize_params
        model = LanguageModel(cfg, quantize_params(
            model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
            device=args.device)
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.new_tokens
    if args.continuous:
        eng = ContinuousBatchingEngine(model, config=EngineConfig(
            kv=KVConfig(kv_mode="paged" if args.paged_kv else "dense",
                        page_size=args.page_size, num_pages=args.num_pages,
                        kv_dtype=args.kv_dtype),
            scheduling=SchedulingConfig(max_slots=args.batch,
                                        max_len=max_len,
                                        prefill_chunk=args.prefill_chunk,
                                        decode_steps=args.decode_steps),
            temperature=args.temperature))
        for _ in range(2 * args.batch):
            ln = int(rng.integers(max(args.prompt_len // 4, 1),
                                  args.prompt_len + 1))
            eng.submit(rng.integers(0, cfg.vocab_size, (ln,),
                                    dtype=np.int32),
                       max_new_tokens=args.new_tokens)
        out = eng.run()
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
        if s.kv_mode == "paged":
            print(f"paged KV: peak {s.pages_peak}/{s.pages_total} pages "
                  f"(×{s.page_size} entries) | live entry saving "
                  f"{s.kv_entries_saved_fraction:.1%} | history hit rate "
                  f"{s.history_hit_rate:.1%} | preemptions "
                  f"{s.preemptions}")
        if args.kv_dtype:
            print(f"quantized KV: {args.kv_dtype} page payloads "
                  "(pow2 per-entry scales)")
        for uid, r in sorted(out["results"].items()):
            print(f"  req {uid}: T0={r.prompt_len} +{r.decode_tokens} "
                  f"TTFT {r.ttft_s*1e3:.1f}ms ({r.finish_reason})")
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


if __name__ == "__main__":
    main()
