"""Token sampling (counterpart of ``sample`` in the JAX package's
``serve/sampling.py``).  Random draws come from an explicit
``torch.Generator``; they do not reproduce JAX's bits, so stochastic
sampling is compared by distribution, greedy sampling by token."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, V] -> [B] int64 token ids (greedy at temperature 0)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
