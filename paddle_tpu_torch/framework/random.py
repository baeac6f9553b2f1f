"""Seeded random streams.

Each consumer that draws random numbers owns its own ``torch.Generator``
made here, so two requests (or a request and the model's weight init) never
share a stream and a seed alone reproduces a run. A training model owns one
``DropoutRNG`` (the port of ``paddle_tpu/framework/random.py``'s key chain
as its SDPA and dropout draw from it)."""
from __future__ import annotations

import torch

__all__ = ["DropoutRNG", "seed", "draw", "sample_top_k"]


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


class DropoutRNG:
    """The random streams of one model's dropout, all from one seed.

    ``attention_seed()`` draws a fresh int32 seed for each flash-attention
    call from a CPU generator, as the JAX SDPA draws one from its key chain
    per call: a host int, so no device sync, and every step gets a new
    mask. ``generator(device)`` is the generator of hidden-dropout and
    plain-path attention masks on that device (a CUDA generator on the
    card, so a mask never crosses from the host). Layers share the object:
    a deep copy of a layer keeps the same streams."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.host = torch.Generator().manual_seed(self.seed)
        self._devices = {}

    def attention_seed(self) -> int:
        return int(torch.randint(-2**31, 2**31 - 1, (1,),
                                 generator=self.host))

    def generator(self, device) -> torch.Generator:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        g = self._devices.get(dev)
        if g is None:
            # its own stream, apart from the host's seed draws
            g = torch.Generator(device=dev).manual_seed(self.seed + 1)
            self._devices[dev] = g
        return g

    def __deepcopy__(self, memo):
        return self
