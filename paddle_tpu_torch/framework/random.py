"""Seeded random streams.

Each consumer that draws random numbers owns its own ``torch.Generator``
made here, so two requests (or a request and the model's weight init) never
share a stream and a seed alone reproduces a run."""
from __future__ import annotations

import torch

__all__ = ["seed", "draw", "sample_top_k"]


def seed(s) -> torch.Generator:
    """A CPU generator seeded with ``s`` (None counts as 0)."""
    g = torch.Generator()
    g.manual_seed(0 if s is None else int(s))
    return g


def draw(generator: torch.Generator, n: int) -> torch.Tensor:
    """The n uniforms one sampling step takes from ``generator`` ([n, 1]);
    a replayed step calls it too, so the stream advances alike."""
    return torch.rand(n, 1, generator=generator)


def sample_top_k(logits: torch.Tensor, top_k: int, temperature: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Top-k sampling from f32 logits [n, V]: one uniform per row, inverted
    through the cumulative softmax of the k largest (temperature-scaled)
    logits. Returns token ids [n] (int64, CPU)."""
    vals, idxs = torch.topk(logits / max(temperature, 1e-6), top_k, dim=-1)
    cdf = torch.softmax(vals.float(), dim=-1).cpu().cumsum(-1)
    u = draw(generator, logits.shape[0])
    choice = (cdf < u).sum(-1, keepdim=True).clamp_max(top_k - 1)
    return idxs.cpu().gather(-1, choice)[:, 0]
