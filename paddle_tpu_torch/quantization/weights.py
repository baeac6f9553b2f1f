"""Int8 serving weights: per-out-channel absmax scales computed once, at
load, and the weight dequantized on use.

Port of ``paddle_tpu/quantization/weights.py`` in torch's idiom: where the
JAX package swaps leaves of a functional-state dict, ``quantize_linears``
swaps the model's ``ColumnParallelLinear``/``RowParallelLinear`` modules
(attention qkv and proj, MLP fc1 and fc2) for ``QuantizedLinear`` modules
that hold an int8 [out, in] payload and f32 [out, 1] scales. Embeddings,
norms and biases stay fp: a sliver of the bytes, and quantizing the tied
embedding costs disproportionate logit drift.

Layout: the JAX package stores a linear as [in, out] and reduces over axis
0 (scales [1, out]); the port stores [out, in] and reduces over axis -1
(scales [out, 1]). Both take the same absmax per output feature, so the
port's payload is the JAX payload transposed, bit for bit.

Dequantization dtype: the JAX package dequantizes to f32, so a bf16 model
computes those products (and what follows them) in f32. ``QuantizedLinear``
dequantizes to its input's dtype instead: the same f32 product data *
scale, rounded once to bf16 for a bf16 model, written by one kernel per
call. In f32 the two agree.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as torch_F
from torch import nn

from ..nn.layers import ColumnParallelLinear, RowParallelLinear
from ..parallel.comm_compress import quant_absmax

__all__ = ["QuantizedLinear", "linear_weight_names", "params_bytes",
           "quantize_linears", "quantized_bytes_saved"]


class QuantizedLinear(nn.Module):
    """A linear whose weight is an int8 [out, in] payload with f32 [out, 1]
    per-out-channel scales (buffers), dequantized on every call; the bias
    stays fp."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 bias=None):
        super().__init__()
        self.out_features, self.in_features = data.shape
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.bias = bias

    @classmethod
    def from_linear(cls, linear: nn.Linear, bits: int = 8):
        q, s = quant_absmax(linear.weight.detach(), bits=bits, axis=-1)
        return cls(q, s, linear.bias)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The dense [out, in] weight: ``dequant_absmax``'s f32 product
        data * scale, rounded once to ``dtype``, in one kernel (the
        product is taken in f32, the inputs' common type, and cast on
        store)."""
        out = torch.empty(self.data.shape, dtype=dtype,
                          device=self.data.device)
        return torch.mul(self.data, self.scale, out=out)

    def forward(self, x):
        return torch_F.linear(x, self.dequantize(x.dtype), self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


def _linears(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (ColumnParallelLinear, RowParallelLinear))]


def linear_weight_names(model: nn.Module) -> List[str]:
    """Names of the weights worth quantizing: every Column/RowParallel
    linear's ``.weight`` (the JAX package's list, in its naming)."""
    return [f"{name}.weight" for name, _ in _linears(model)]


def quantize_linears(model: nn.Module, bits: int = 8) -> List[str]:
    """Replace every Column/RowParallelLinear of ``model``, in place, with
    a ``QuantizedLinear`` of its weight (scales computed here, once).
    Returns the quantized weights' names; already quantized modules stay."""
    names = []
    for name, lin in _linears(model):
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, QuantizedLinear.from_linear(lin, bits))
        names.append(f"{name}.weight")
    return names


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def params_bytes(model: nn.Module) -> int:
    """Device bytes of a model's parameters and buffers (a quantized
    linear counts its int8 payload and f32 scales)."""
    return _bytes(model.parameters()) + _bytes(model.buffers())


def quantized_bytes_saved(model: nn.Module) -> int:
    """Bytes saved against holding every quantized weight as f32 — what
    the engine reports as ``weight_quant_bytes_saved``."""
    return sum(m.data.numel() * 4 - _bytes((m.data, m.scale))
               for m in model.modules() if isinstance(m, QuantizedLinear))
