"""Lock-step serving engine: prefill, then autoregressive decode with
dynamic routing and cross-layer KV reuse, with the KV-storage saving
*measured* from the per-step execution-gate log.

Counterpart of ``ServeEngine`` in the JAX package's ``serve/engine.py``;
the continuous-batching engine is not ported yet.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_reuse
from repro_torch.models.model import LanguageModel
from repro_torch.serve.sampling import sample


@dataclasses.dataclass
class ServeStats:
    """The fields ``ServeEngine.generate`` fills (names as in the
    reference).  Times are host wall seconds around work that ends in a
    device synchronize.

      prefill_tokens    — prompt tokens prefilled.
      decode_tokens     — tokens emitted (the first, from prefill, included).
      prefill_s / decode_s — wall time of the prefill / the decode loop.
      attn_keep_frac    — mean decode-time keep rate over routed submodules.
      kv_saved_fraction — measured compact-KV storage saving over the decode
                          gate log; ``kv_saved_analytic`` is the
                          configured-keep-rate estimate."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    attn_keep_frac: float = 1.0
    kv_saved_fraction: float = 0.0
    kv_saved_analytic: float = 0.0

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


def analytic_kv_saved(cfg: ModelConfig) -> float:
    """Compact-store saving at the configured keep rate: layer 0 dense +
    keep_prob elsewhere."""
    L = max(len(cfg.attention_layers), 1)
    if not (cfg.skip.enabled and cfg.skip.kv_reuse):
        return 0.0
    return 1.0 - (1.0 + (L - 1) * cfg.skip.keep_prob) / L


def _measured_saved_fraction(gates_per_step: List[np.ndarray],
                             cfg: ModelConfig) -> float:
    """Lock-step gate log [L, B] per step -> measured storage saving."""
    if not gates_per_step or not (cfg.skip.enabled and cfg.skip.kv_reuse):
        return 0.0
    g = torch.from_numpy(np.stack(gates_per_step, axis=-1))  # [L, B, steps]
    return float(kv_reuse.storage_saved_fraction(g))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Lock-step batched engine (one shared decode position).

    ``model`` is a ``LanguageModel`` (its device is the engine's).  Sampling
    at ``temperature > 0`` draws from the ``torch.Generator`` given to
    ``generate``, by default one on that device seeded with 0."""

    def __init__(self, model: LanguageModel, max_len: int = 512,
                 temperature: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.temperature = temperature

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, object]:
        """prompts: [B, T0] int.  Returns {"tokens": [B, max_new_tokens]
        int32, "stats": ServeStats}."""
        cfg, dev = self.cfg, self.model.device
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        B, T0 = prompts.shape
        stats = ServeStats()
        toks = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)

        _sync(dev)
        t0 = perf_counter()
        logits, cache, _ = self.model.prefill(toks, pad_to=self.max_len)
        _sync(dev)
        stats.prefill_s = perf_counter() - t0
        stats.prefill_tokens = B * T0

        out = np.zeros((B, max_new_tokens), np.int32)
        keep_acc, keep_n = 0.0, 0
        gates_per_step: List[np.ndarray] = []
        emitted = 0
        tok = sample(logits, generator, self.temperature)
        t0 = perf_counter()
        for i in range(max_new_tokens):
            out[:, i] = tok.cpu().numpy()
            emitted += B
            pos = T0 + i
            if pos >= self.max_len:
                break
            logits, cache, dstats = self.model.decode_step(
                cache, tok[:, None], pos)
            gates_per_step.append(
                dstats["attn_gate"].float().cpu().numpy())
            keep_acc += float(dstats["keep_frac_sum"])
            keep_n += max(float(dstats["n_routed"]), 1.0)
            tok = sample(logits, generator, self.temperature)
        _sync(dev)
        stats.decode_s = perf_counter() - t0
        stats.decode_tokens = emitted

        stats.attn_keep_frac = keep_acc / max(keep_n, 1.0)
        stats.kv_saved_fraction = _measured_saved_fraction(gates_per_step, cfg)
        stats.kv_saved_analytic = analytic_kv_saved(cfg)
        return {"tokens": out, "stats": stats}
