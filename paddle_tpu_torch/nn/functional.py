"""Functional ops of the port's models.

Port of the parts of ``paddle_tpu/nn/functional`` the GPT and ERNIE paths
call: activations (exact-erf GELU, ReLU), upscale-in-train dropout, the
attention dispatch, and the fused tied-head cross-entropy.

``scaled_dot_product_attention`` keeps the JAX package's dispatch. Shapes
the flash gate admits (sequences of 128 or more) with no mask, or a
[B, 1, 1, Sk] key-padding mask that takes no gradient, go to the flash
kernels, the mask lowered to its kv_bias row (bool -> 0 / -1e9) and
attention dropout done inside the kernels from a seed drawn per call.
Everything else (general masks, masks that need a gradient, short
sequences) takes the plain masked softmax of ``ops/attention.py``.
Layout [batch, seq, heads, head_dim].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as torch_F

from ..framework.random import DropoutRNG
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention, flash_attention_supported

__all__ = ["dropout", "gelu", "linear_cross_entropy", "relu",
           "scaled_dot_product_attention"]


def gelu(x):
    """GELU, exact erf form (the reference's default)."""
    return torch_F.gelu(x)


def relu(x):
    return torch_F.relu(x)


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout: in training, keep each entry with
    probability 1 - p and divide the kept ones by 1 - p; identity
    otherwise. The mask comes from uniforms of ``generator`` on x's
    device."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def scaled_dot_product_attention(query, key, value,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 rng: Optional[DropoutRNG] = None):
    """Attention on [B, S, H, D]. Dropout applies to the attention
    probabilities when ``training`` and ``dropout_p`` > 0, and then needs
    the caller's ``rng``: the flash path takes a fresh seed per call from
    its host stream, the plain path a mask from its device stream."""
    use_dropout = dropout_p > 0.0 and training
    if use_dropout and rng is None:
        raise ValueError("scaled_dot_product_attention: dropout in training "
                         "needs a DropoutRNG")
    kv_bias_ok = attn_mask is None or (
        attn_mask.dim() == 4 and attn_mask.shape[1] == 1
        and attn_mask.shape[2] == 1 and not attn_mask.requires_grad)
    p = dropout_p if use_dropout else 0.0
    if kv_bias_ok and dropout_p < 1.0 and flash_attention_supported(
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
                               causal=is_causal, dropout_p=p,
                               dropout_seed=rng.attention_seed() if p else None)
    return attention(query, key, value, attn_mask, is_causal, dropout_p=p,
                     generator=rng.generator(query.device) if p else None)


class _LinearCrossEntropy(torch.autograd.Function):
    """Mean cross-entropy of ``x @ W^T + b`` whose [N, V] f32 logits live
    only inside forward and are recomputed in backward, one row block at a
    time (``chunk`` rows, or all): the graph keeps x, W, b and the labels
    only."""

    @staticmethod
    def forward(ctx, x, weight, bias, label, ignore_index, chunk):
        valid = label != ignore_index
        count = valid.sum().clamp_min(1)  # a tensor: no host sync
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo, hi in _blocks(x.shape[0], chunk):
            logp = torch.log_softmax(_logits(x[lo:hi], weight, bias), -1)
            nll = -logp.gather(1, _safe(label[lo:hi])[:, None])[:, 0]
            total = total + torch.where(valid[lo:hi], nll, 0.0).sum()
        ctx.save_for_backward(x, weight, bias, label)
        ctx.ignore_index, ctx.chunk, ctx.count = ignore_index, chunk, count
        return total / count

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, label = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = torch.empty_like(x) if need_x else None
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device) if need_w else None
        db = (torch.zeros(bias.shape, dtype=torch.float32, device=x.device)
              if bias is not None and need_b else None)
        scale = g.float() / ctx.count
        for lo, hi in _blocks(x.shape[0], ctx.chunk):
            lab = label[lo:hi]
            dlog = torch.softmax(_logits(x[lo:hi], weight, bias), -1)
            dlog[torch.arange(hi - lo, device=x.device), _safe(lab)] -= 1.0
            dlog = torch.where((lab != ctx.ignore_index)[:, None], dlog, 0.0)
            dlog = dlog * scale
            if db is not None:
                db += dlog.sum(0)
            dlog = dlog.to(x.dtype)
            if dx is not None:
                dx[lo:hi] = dlog @ weight
            if dw is not None:
                dw += (dlog.t() @ x[lo:hi]).float()
        return (dx, None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype), None, None, None)


def _blocks(n: int, chunk: Optional[int]):
    step = chunk if chunk else n
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _logits(x, weight, bias):
    """f32 logits of one row block: the product in x's dtype, then the
    bias add in f32."""
    logits = (x @ weight.t()).float()
    return logits if bias is None else logits + bias.float()


def _safe(label):
    """Labels usable as indices (ignored rows point at class 0)."""
    return label.clamp(min=0).long()


def linear_cross_entropy(x, weight, bias, label, ignore_index: int = -100,
                         chunk: Optional[int] = None):
    """Fused tied head + mean cross-entropy with recomputed logits.

    x [N, H]; weight [V, H] (the tied-embedding layout); bias [V] or None;
    label [N] ints. The mean is over rows whose label is not
    ``ignore_index``. ``chunk`` caps the transient logits at [chunk, V]."""
    if chunk is not None and (not isinstance(chunk, int) or chunk <= 0):
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    return _LinearCrossEntropy.apply(x, weight, bias, label, ignore_index,
                                     chunk)
