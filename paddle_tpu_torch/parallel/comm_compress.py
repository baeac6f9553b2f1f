"""Symmetric absmax quantization: the one scale codepath of the int8
weights and the int8 KV pools.

Port of ``quant_absmax`` and ``dequant_absmax`` from
``paddle_tpu/parallel/comm_compress.py`` (the quantized collectives there
are not ported yet). The order of operations is the JAX package's, so the
int8 payloads and the f32 scales are bit-identical to its: non-finite
values zeroed, the cast to f32, the absmax along ``axis`` over qmax plus
1e-30, ``round(x / s)`` half to even, the clip, the cast to int8.
"""
from __future__ import annotations

import torch

__all__ = ["dequant_absmax", "quant_absmax"]


def quant_absmax(x: torch.Tensor, bits: int = 8, axis: int = -1):
    """One f32 scale per row reduced along ``axis`` (kept as a size-1
    dim) and ints in [-qmax, qmax]: int8 for bits <= 8, else int16.
    Non-finite elements are zeroed before the absmax, so one bad element
    cannot flatten its row; an all-zero row gets the 1e-30 scale floor and
    rounds to exact zeros."""
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    x = x.to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    s = x.abs().amax(dim=axis, keepdim=True) / qmax + 1e-30
    q = torch.clamp(torch.round(x / s), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int16), s


def dequant_absmax(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quant_absmax``: the int payload times its broadcast
    f32 scales, in f32."""
    return q.to(torch.float32) * s
