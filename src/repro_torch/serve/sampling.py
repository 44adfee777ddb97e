"""Token sampling (counterpart of the JAX package's ``serve/sampling.py``):
per-step sampling on the device, and the speculative-decoding accept /
resample functions on the host.  Random draws come from an explicit
``torch.Generator``; they do not reproduce JAX's bits, so stochastic
sampling is compared by distribution, greedy sampling by token.

The speculative functions are host numpy, bit for bit the reference's:
the engine runs them once per window after its one sync, on the draft
tokens, the verifier's per-column argmax or logits, and uniforms drawn
from the run's generator."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
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


# -- speculative decoding: accept / resample (host-side, numpy) -----------
#
# One verify window feeds C = k+1 tokens [f0, d_1..d_k] at positions
# t..t+k; column j of the verifier's logits is the target model's
# response to the prefix ending in the j-th fed token, so draft d_{j+1}
# is judged against column j and the correction after accepting ``a``
# drafts comes from column ``a``.

def greedy_verify(target_tokens: np.ndarray, draft_tokens: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy (temperature-0) window acceptance.

    target_tokens: [B, k+1], the per-column argmax of the verify logits;
    draft_tokens: [B, k], the draft loop's proposals.  Returns (accepted
    [B] int, correction [B] int32): ``accepted[b]`` is the length of the
    longest prefix of drafts matching the verifier's argmax chain, and
    ``correction[b] = target_tokens[b, accepted[b]]``, so every window
    emits ``accepted + 1`` tokens, the chain plain greedy decoding gives."""
    target_tokens = np.asarray(target_tokens)
    draft_tokens = np.asarray(draft_tokens)
    match = draft_tokens == target_tokens[:, :-1]
    accepted = np.cumprod(match, axis=1).sum(axis=1).astype(np.int64)
    correction = np.take_along_axis(
        target_tokens, accepted[:, None], axis=1)[:, 0].astype(np.int32)
    return accepted, correction


def softmax_probs(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Numerically stable host softmax over the last axis at the given
    temperature (> 0), in float64."""
    z = np.asarray(logits, np.float64) / float(temperature)
    z -= z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def residual_distribution(p_draft: np.ndarray, p_target: np.ndarray
                          ) -> np.ndarray:
    """Rejection-path distribution ``norm(max(0, p_target - p_draft))``;
    where the residual has no mass (the distributions coincide) it is
    ``p_target``, the correct limit."""
    res = np.maximum(np.asarray(p_target, np.float64)
                     - np.asarray(p_draft, np.float64), 0.0)
    s = res.sum(axis=-1, keepdims=True)
    safe = np.where(s > 0.0, res / np.where(s == 0.0, 1.0, s), p_target)
    return safe


def emitted_distribution(p_draft: np.ndarray, p_target: np.ndarray
                         ) -> np.ndarray:
    """Analytic marginal of the first emitted token under accept with
    probability min(1, pt/pd) and residual resample:

        P(emit v) = min(pd[v], pt[v]) + (1 - Σ_u min(pd[u], pt[u])) · res[v]

    which the speculative-sampling identity makes equal to ``p_target``."""
    mn = np.minimum(np.asarray(p_draft, np.float64),
                    np.asarray(p_target, np.float64))
    res = residual_distribution(p_draft, p_target)
    return mn + (1.0 - mn.sum(axis=-1, keepdims=True)) * res


def inverse_cdf_sample(p: np.ndarray, u: float) -> int:
    """Deterministic categorical draw: the smallest index whose CDF exceeds
    ``u`` (ties broken low, u in [0, 1))."""
    cdf = np.cumsum(np.asarray(p, np.float64))
    return int(np.searchsorted(cdf, u, side="right").clip(0, len(p) - 1))


def speculative_accept_window(draft_tokens: np.ndarray,
                              p_draft: np.ndarray,
                              p_target: np.ndarray,
                              u_accept: np.ndarray,
                              u_final: np.ndarray
                              ) -> Tuple[int, List[int]]:
    """Stochastic (temperature > 0) window acceptance for ONE sequence.

    draft_tokens: [k]; p_draft: [k, V], the draft distribution each was
    drawn from; p_target: [k+1, V], the verifier's per column; u_accept:
    [k] uniforms for the accept tests; u_final: [k+1], ``u_final[j]``
    drives the resample after a rejection at draft j, ``u_final[k]`` the
    all-accept bonus.  Returns (n_accepted, emitted tokens), whose
    marginals equal sampling every token from ``p_target``."""
    draft_tokens = np.asarray(draft_tokens)
    k = draft_tokens.shape[0]
    emitted: List[int] = []
    for j in range(k):
        d = int(draft_tokens[j])
        pd = float(p_draft[j, d])
        pt = float(p_target[j, d])
        ratio = 1.0 if pd <= 0.0 else min(1.0, pt / pd)
        if float(u_accept[j]) < ratio and pt > 0.0:
            emitted.append(d)
            continue
        res = residual_distribution(p_draft[j], p_target[j])
        emitted.append(inverse_cdf_sample(res, float(u_final[j])))
        return j, emitted
    emitted.append(inverse_cdf_sample(p_target[k], float(u_final[k])))
    return k, emitted
