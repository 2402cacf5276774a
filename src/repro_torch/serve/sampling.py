"""Sampling strategies for the serving engine (greedy is the engine default;
these are the stochastic options), the PyTorch counterpart of
`repro.serve.sampling`. Each stochastic sampler draws from an explicit
``torch.Generator`` on the logits' device; the two frameworks' random bits
differ, so only the distributions agree."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (..., V) -> (...) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(generator: torch.Generator, logits: torch.Tensor,
                t: float = 1.0) -> torch.Tensor:
    if t <= 0:
        return greedy(logits)
    probs = torch.softmax(logits.float() / t, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return idx.reshape(probs.shape[:-1]).to(torch.int32)


def top_k(generator: torch.Generator, logits: torch.Tensor, k: int = 40,
          t: float = 1.0) -> torch.Tensor:
    """Sample from the k highest logits."""
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    masked = torch.where(logits < cutoff, -torch.inf, logits)
    return temperature(generator, masked, t)


def top_p(generator: torch.Generator, logits: torch.Tensor, p: float = 0.9,
          t: float = 1.0) -> torch.Tensor:
    """Nucleus sampling: smallest prefix of the sorted distribution with
    cumulative probability >= p."""
    probs = torch.softmax(logits.float() / max(t, 1e-6), dim=-1)
    sorted_probs = torch.flip(torch.sort(probs, dim=-1).values, dims=(-1,))
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = torch.sum(cum < p, dim=-1, keepdim=True) + 1
    thresh = torch.gather(sorted_probs, -1, keep - 1)
    masked = torch.where(probs < thresh, -torch.inf, logits)
    return temperature(generator, masked, 1.0)
