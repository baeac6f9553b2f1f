"""Carry a ``paddle_tpu`` GPT's weights into the port.

The JAX package stores a linear's weight as [in, out] and applies
``x @ w``; ``torch.nn.Linear`` stores [out, in]. This module transposes the
four linears of every block and keeps everything else as it is (the
parameter names already agree, and the LM head is tied to ``wte`` in both).

    sd = {k: v.numpy() for k, v in jax_model.state_dict().items()}
    port_model.load_state_dict(from_jax_state(sd))
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_state"]

#: parameter-name suffixes of the linears whose weight is transposed
LINEAR_WEIGHTS = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
                  "mlp.fc2.weight")


def from_jax_state(state: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """paddle_tpu state dict (name -> numpy array) -> port state dict
    (name -> CPU tensor, same dtype)."""
    out = {}
    for name, value in state.items():
        a = np.asarray(value)
        if name.endswith(LINEAR_WEIGHTS):
            if a.ndim != 2:
                raise ValueError(f"{name}: linear weight of shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a))  # a writable copy
    return out
