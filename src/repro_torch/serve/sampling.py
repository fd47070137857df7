"""Token sampling: greedy / temperature / top-k / top-p (port of ``repro/serve/sampling.py``).

Stochastic draws come from an explicit ``torch.Generator``; they cannot
reproduce ``jax.random``'s bits, only its distribution.
"""
from __future__ import annotations

import torch


def filtered_logits(logits: torch.Tensor, *, temperature: float, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled logits with -inf outside the top-k / top-p support
    (temperature, then top-k, then top-p).  Requires ``temperature > 0``."""
    if temperature <= 0.0:
        raise ValueError("filtered_logits is for stochastic sampling (temperature > 0)")
    logits = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        # nucleus: the smallest prefix of the descending ranking whose mass
        # reaches top_p; the first token always survives
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        kth = torch.clamp_min((cum_before < top_p).sum(dim=-1) - 1, 0)
        thr = torch.take_along_dim(sorted_desc, kth[..., None], dim=-1)
        logits = torch.where(logits < thr, -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """logits (..., V) -> int32 token ids (...).  ``temperature == 0`` is greedy
    (``argmax``, the first maximum)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature needs a torch.Generator")
    probs = torch.softmax(filtered_logits(logits, temperature=temperature, top_k=top_k,
                                          top_p=top_p), dim=-1)
    toks = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return toks.reshape(logits.shape[:-1]).to(torch.int32)
