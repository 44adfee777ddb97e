"""Token sampling (counterpart of ``sample`` in the JAX package's
``serve/sampling.py``).  Random draws come from an explicit
``torch.Generator``; they do not reproduce JAX's bits, so stochastic
sampling is compared by distribution, greedy sampling by token."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, V] -> [B] int64 token ids (greedy at temperature 0).

    At temperature > 0 one categorical draw per row as argmax(p / E) with
    E ~ Exp(1) drawn from ``generator`` (the row's minimum of E_i / p_i is
    index i with probability p_i).  Unlike ``torch.multinomial`` it never
    reads a value back to the host, so a CUDA graph can capture it."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1)
