"""Attention entry of the port's models.

Port of ``paddle_tpu/nn/functional`` ``scaled_dot_product_attention``:
the same dispatch. Shapes the flash gate admits (sequences of 128 or more)
with no mask or a [B, 1, 1, Sk] key-padding mask go to the flash kernel,
the mask lowered to its kv_bias row (bool -> 0 / -1e9); everything else
takes the plain masked softmax of ``ops/attention.py``. Inference only:
no attention dropout. Layout [batch, seq, heads, head_dim].
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import attention
from ..ops.flash_attention import flash_attention, flash_attention_supported

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False):
    kv_bias_ok = attn_mask is None or (
        attn_mask.dim() == 4 and attn_mask.shape[1] == 1
        and attn_mask.shape[2] == 1)
    if kv_bias_ok and flash_attention_supported(
            tuple(query.shape), tuple(key.shape), is_causal):
        kvb = None
        if attn_mask is not None:
            kvb = attn_mask.reshape(attn_mask.shape[0], attn_mask.shape[-1])
            if kvb.dtype == torch.bool:
                kvb = torch.where(kvb, 0.0, -1e9)
            kvb = kvb.float().expand(query.shape[0], key.shape[1])
            kvb = kvb.contiguous()
        return flash_attention(query.contiguous(), key.contiguous(),
                               value.contiguous(), kv_bias=kvb,
                               causal=is_causal)
    return attention(query, key, value, attn_mask, is_causal)
