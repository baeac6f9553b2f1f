"""Single-device stand-ins for the JAX package's tensor-parallel layers
(``paddle_tpu/parallel/tp.py``), so the port's model tree and weight names
read as the reference's. Tensor parallelism comes in a later slice.

Weights follow PyTorch's convention: a linear stores [out, in] (the JAX
package stores [in, out]; ``convert.py`` transposes).
"""
from __future__ import annotations

from torch import nn

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
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
