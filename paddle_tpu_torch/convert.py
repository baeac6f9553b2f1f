"""Carry a ``paddle_tpu`` model's weights into the port, and the port's
gradients back into the JAX package's layout.

The JAX package stores a linear's weight as [in, out] and applies
``x @ w``; ``torch.nn.Linear`` stores [out, in]. The weights transposed
are those of the port model's ``nn.Linear`` modules; everything else
(embeddings, norms, biases, ERNIE's ``mlm_bias``) carries as it is: the
parameter names already agree.

    sd = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port_model.load_state_dict(from_jax_state(sd, port_model))

Quantized leaves carry too, for comparing payloads: the JAX package's
``QuantizedLinear`` (int8 [in, out], f32 [1, out]) and ``QuantizedKV``
(int8 [NB, BS, H, D], f32 [NB, BS, H, 1]), as numpy ``data``/``scale``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .quantization.kv import QuantizedKV

__all__ = ["from_jax_state", "quantized_kv_from_jax",
           "quantized_linear_from_jax", "to_jax_layout"]


def _transposed(model: nn.Module):
    """Predicate: is this parameter name a linear weight of ``model``?"""
    names = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, nn.Linear)}
    return names.__contains__


def from_jax_state(state: Mapping[str, np.ndarray],
                   model: nn.Module) -> Dict[str, torch.Tensor]:
    """paddle_tpu state dict (name -> numpy array) -> port state dict
    (name -> CPU tensor, same dtype)."""
    is_linear = _transposed(model)
    out = {}
    for name, value in state.items():
        a = np.asarray(value)
        if is_linear(name):
            if a.ndim != 2:
                raise ValueError(f"{name}: linear weight of shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a))  # a writable copy
    return out


def to_jax_layout(tensors: Mapping[str, torch.Tensor],
                  model: nn.Module) -> Dict[str, np.ndarray]:
    """The reverse map, for parameters or their gradients: port name ->
    tensor in, name -> numpy array in the JAX package's layout out."""
    is_linear = _transposed(model)
    return {name: (t.detach().cpu().numpy().T if is_linear(name)
                   else t.detach().cpu().numpy())
            for name, t in tensors.items()}


def quantized_linear_from_jax(data, scale):
    """A JAX ``QuantizedLinear``'s payload and scales ([in, out], [1, out])
    -> the port's ([out, in] int8, [out, 1] f32) CPU tensors."""
    return (torch.from_numpy(np.ascontiguousarray(np.asarray(data).T)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(scale).T)))


def quantized_kv_from_jax(data, scale) -> QuantizedKV:
    """A JAX ``QuantizedKV``'s payload and scales -> a port ``QuantizedKV``
    of CPU tensors (the layouts agree)."""
    return QuantizedKV(torch.from_numpy(np.array(data)),
                       torch.from_numpy(np.array(scale)))
