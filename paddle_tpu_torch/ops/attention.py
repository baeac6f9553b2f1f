"""Plain attention: softmax(QK^T)V with a general mask.

Port of ``paddle_tpu/ops/attention.py`` (``flash_attention_xla``): the path
``nn.functional.scaled_dot_product_attention`` takes below the flash
kernel's shape gate (sequences shorter than 128, e.g. a decode row over a
contiguous cache) and for masks that are not a [B, 1, 1, Sk] key-padding
row, or that need a gradient. It materialises the scores, which is cheap
at those shapes. Layout [B, S, H, D]. Attention dropout here draws its mask
from an explicit generator: JAX's keys cannot be reproduced, so it agrees
with the JAX package at p = 0 and is deterministic under a fixed generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention"]


def attention(q, k, v, mask: Optional[torch.Tensor] = None,
              causal: bool = False, scale: Optional[float] = None,
              dropout_p: float = 0.0,
              generator: Optional[torch.Generator] = None):
    """Causal rows attend to keys at or before them (aligned to the end
    when Sk > Sq); a bool mask keeps True entries; a float mask is added to
    the scores (broadcast to [B, H, Sq, Sk]). Softmax in f32. dropout_p > 0
    drops probabilities (kept ones scaled by 1 / (1 - p)) by uniforms from
    ``generator``, which must live on q's device."""
    d = q.shape[-1]
    s = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    low = torch.finfo(torch.float32).min
    if causal:
        qlen, klen = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(qlen, klen, dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        scores = scores.masked_fill(~keep, low)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, low)
        else:
            scores = scores + mask.float()
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("attention: dropout_p > 0 needs a generator")
        keep = torch.rand(w.shape, generator=generator,
                          device=w.device) >= dropout_p
        w = torch.where(keep, w / (1.0 - dropout_p), 0.0).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
