"""Layers of the port's models: single-device stand-ins for the JAX
package's tensor-parallel layers (``paddle_tpu/parallel/tp.py``), so the
port's model tree and weight names read as the reference's (tensor
parallelism comes in a later slice), and ``Dropout`` on a model's seeded
streams.

Weights follow PyTorch's convention: a linear stores [out, in] (the JAX
package stores [in, out]; ``convert.py`` transposes).
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from ..framework.random import DropoutRNG
from . import functional as F

__all__ = ["ColumnParallelLinear", "Dropout", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(nn.Linear):
    """Linear whose output features a TP mesh would split."""

    def __init__(self, in_features, out_features, has_bias=True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=has_bias,
                         device=device, dtype=dtype)


class RowParallelLinear(nn.Linear):
    """Linear whose input features a TP mesh would split."""

    def __init__(self, in_features, out_features, has_bias=True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=has_bias,
                         device=device, dtype=dtype)


class VocabParallelEmbedding(nn.Embedding):
    """Embedding table whose vocabulary a TP mesh would split."""


class Dropout(nn.Module):
    """Upscale-in-train dropout (``paddle_tpu.nn.Dropout``) whose masks come
    from ``rng``'s generator on the input's device; needs ``rng`` only when
    it trains with p > 0."""

    def __init__(self, p: float = 0.5, rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.p = float(p)
        self.rng = rng

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.rng is None:
            raise ValueError("Dropout in training needs a DropoutRNG")
        return F.dropout(x, self.p, True, self.rng.generator(x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"
