"""ERNIE / BERT-base encoder for pretraining on the card.

Port of ``paddle_tpu/models/ernie.py``: word + position + token-type
embeddings with a LayerNorm (eps from the config, 1e-12) and dropout, a
post-LN ``TransformerEncoder`` (exact-erf GELU, attention dropout inside the
flash kernels from 128 tokens up), a tanh pooler, and the pretraining heads:
an MLM transform + GELU + LayerNorm whose decoder is tied to the word
embeddings with its own ``mlm_bias``, and the NSP classifier.

``pretraining_loss`` is the training entry: the MLM loss through the fused
``linear_cross_entropy`` (logits recomputed in backward). The pooler and
NSP run only in ``forward``; their parameters get no gradient from the
loss, and the optimizer skips them.

Weights follow PyTorch's layout (linears [out, in]); ``convert.py`` carries
a ``paddle_tpu`` state dict over. Random weights come from a seed, and all
dropout from a ``DropoutRNG`` seeded alike.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..framework import random as fw_random
from ..framework.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForPretraining", "ErniePretrainingCriterion"]


class ErnieConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=512,
                   max_position_embeddings=128)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, rng: fw_random.DropoutRNG):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob, rng)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Module):
    def __init__(self, cfg: ErnieConfig, rng: fw_random.DropoutRNG):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, rng)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, rng=rng)
        self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] 1/0 -> additive mask broadcastable over [B, H, Sq, Sk]
            am = (1.0 - attention_mask.float()) * -1e4
            attention_mask = am[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(nn.Module):
    """MLM + NSP heads (weight-tied MLM decoder). Runs on the CUDA card
    unless ``device`` names another; weights are random from ``seed`` (or
    carried over with ``load_state_dict(convert.from_jax_state(sd,
    model))``), dropout streams from ``DropoutRNG(seed)``."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.rng = fw_random.DropoutRNG(seed)
        with torch.device("meta"):
            self.ernie = ErnieModel(cfg, self.rng)
            self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
            self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size))
            self.nsp = nn.Linear(cfg.hidden_size, 2)
        self.to_empty(device="cpu")
        self._init_weights(fw_random.seed(seed))
        self.to(device=dev, dtype=dtype)

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """The reference's initialisers: Xavier-uniform linears with zero
        biases, N(0, initializer_range) embeddings, unit LayerNorms, a zero
        MLM bias. Every layer draws its own weights."""
        std = self.ernie.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = math.sqrt(6.0 / (mod.in_features + mod.out_features))
                mod.weight.uniform_(-bound, bound, generator=g)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, std, generator=g)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.mlm_bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    def _mlm_hidden(self, input_ids, token_type_ids, position_ids,
                    attention_mask):
        seq_out, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                     attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq_out)))
        return h, pooled

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """(MLM logits [B, S, V], NSP logits [B, 2])."""
        h, pooled = self._mlm_hidden(input_ids, token_type_ids, position_ids,
                                     attention_mask)
        logits = h @ self.ernie.embeddings.word_embeddings.weight.t()
        return logits + self.mlm_bias, self.nsp(pooled)

    def pretraining_loss(self, input_ids, mlm_labels, token_type_ids=None,
                         position_ids=None, attention_mask=None,
                         ignore_index: int = -100):
        """Mean MLM cross-entropy over labels != ignore_index, through the
        fused tied head (bias add and log-softmax in f32; the [tokens,
        vocab] logits are recomputed in backward). NSP is not included."""
        h, _ = self._mlm_hidden(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return F.linear_cross_entropy(
            h.reshape(-1, h.shape[-1]),
            self.ernie.embeddings.word_embeddings.weight, self.mlm_bias,
            mlm_labels.reshape(-1), ignore_index=ignore_index)


class ErniePretrainingCriterion(nn.Module):
    """Mean MLM cross-entropy (ignore_index -100), plus the NSP term when
    NSP labels are given."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels=None):
        loss = torch.nn.functional.cross_entropy(
            mlm_logits.reshape(-1, self.vocab_size).float(),
            mlm_labels.reshape(-1).long(), ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + torch.nn.functional.cross_entropy(
                nsp_logits.float(), nsp_labels.reshape(-1).long())
        return loss
