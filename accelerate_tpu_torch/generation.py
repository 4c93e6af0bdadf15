"""Token sampling shared by the serving engine.

Counterpart of ``accelerate_tpu/generation.py``'s ``_sample``. Greedy is
``argmax``, which returns the first maximum in both frameworks, so greedy
tokens agree with the reference given equal logits. Temperature and
top-k sampling draw from the caller's ``torch.Generator`` (one per
request in the engine); its bits differ from ``jax.random``'s, so
sampled tokens are compared by distribution, not token for token.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int]) -> torch.Tensor:
    """logits [N, V] fp32 -> token ids [N] (int64)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
