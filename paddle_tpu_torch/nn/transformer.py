"""Transformer encoder layers.

Port of ``paddle_tpu/nn/transformer.py`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``): separate q/k/v/out
projections, attention through ``nn.functional``'s dispatch (the flash
kernels from 128 tokens up, attention dropout inside them), post-LN
blocks (the reference's default, and ERNIE's) whose activation is found
by name in ``nn.functional``. The encoder's norms use LayerNorm's default
eps 1e-5, as the reference's do, whatever eps the model config gives its
own norms.

Every dropout draws from one ``DropoutRNG`` handed down by the model; a
deep copy of a layer shares it.
"""
from __future__ import annotations

import copy
from typing import Optional

from torch import nn

from ..framework.random import DropoutRNG
from . import functional as F
from .layers import Dropout

__all__ = ["MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]


class MultiHeadAttention(nn.Module):
    """Self or cross attention on [B, S, E] inputs."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = float(dropout)
        self.rng = rng
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).view(b, sq, *heads)
        k = self.k_proj(key).view(b, key.shape[1], *heads)
        v = self.v_proj(value).view(b, value.shape[1], *heads)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, rng=self.rng)
        return self.out_proj(out.reshape(b, sq, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a two-layer feed-forward, each followed by a
    residual add and a LayerNorm. ``dropout`` applies to both residual
    branches and the activation, ``attn_dropout`` (default: ``dropout``) to
    the attention probabilities."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            rng=rng)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout, rng)
        self.dropout2 = Dropout(dropout, rng)
        self.dropout_act = Dropout(dropout, rng)
        if not callable(getattr(F, activation, None)):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation

    def forward(self, src, src_mask=None):
        src = self.norm1(src + self.dropout1(self.self_attn(src, src, src,
                                                            src_mask)))
        act = getattr(F, self.activation)
        ffn = self.linear2(self.dropout_act(act(self.linear1(src))))
        return self.norm2(src + self.dropout2(ffn))


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself)."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src
