"""Serving launcher of the port: lock-step batched generation.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --batch 4 --prompt-len 512 --new-tokens 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --smoke --device cpu                                 # plain versions

Weights are random, drawn from seed 0 on the chosen device.
"""
import argparse

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = LanguageModel(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len), dtype=np.int32)
    eng = ServeEngine(model, max_len=args.prompt_len + args.new_tokens,
                      temperature=args.temperature)
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
