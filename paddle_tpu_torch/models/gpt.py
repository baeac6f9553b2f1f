"""GPT decoder for serving on the card.

Port of ``paddle_tpu/models/gpt.py`` (inference): learned or rotary
positions, pre-LN blocks with exact-erf GELU, an LM head tied to the token
embedding. Causal attention goes through ``nn.functional``'s dispatch (the
flash kernel from 128 tokens up); the paged decode step goes through the
paged-attention kernel.

Weights follow PyTorch's layout (linears [out, in]); ``convert.py`` carries
a ``paddle_tpu`` state dict over. Random weights come from a seed. The
paged pools may be fp or int8 with scales (``quantization/kv.py``), and the
linears may be int8 (``quantization/weights.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as torch_F
from torch import nn

from ..framework import random as fw_random
from ..framework.device import resolve_device
from ..nn import functional as F
from ..nn.layers import (ColumnParallelLinear, RowParallelLinear,
                         VocabParallelEmbedding)
from ..ops._cuda import padded_head_dim
from ..ops.paged_attention import paged_attention
from ..quantization import kv as kvq

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, ffn_hidden_size=None,
                 max_position_embeddings=1024, dropout=0.1,
                 layer_norm_eps=1e-5, initializer_range=0.02,
                 position_embedding="learned", rope_theta=10000.0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        # kept for config parity; the port serves, so nothing drops out
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range
        # "learned" = a trained position table (wpe); "rope" = rotary
        # embeddings applied to q/k per layer, no position parameters
        if position_embedding not in ("learned", "rope"):
            raise ValueError(f"position_embedding: {position_embedding!r}")
        self.position_embedding = position_embedding
        self.rope_theta = rope_theta


def _apply_rope(x, pos, theta):
    """Rotary position embedding on [B, S, H, D] (interleaved pairs):
    (x[2i], x[2i+1]) rotate by p * theta^(-2i/D) at absolute position p.
    pos is an int (the first row's position, whole batch) or a [B, S]
    tensor of per-row positions (serving: each slot at its own)."""
    s, d = x.shape[1], x.shape[-1]
    f32 = torch.float32
    inv = theta ** (-torch.arange(0, d, 2, dtype=f32, device=x.device) / d)
    if isinstance(pos, torch.Tensor):
        ang = pos.to(f32)[..., None] * inv                # [B, s, d/2]
        sin, cos = ang.sin()[:, :, None, :], ang.cos()[:, :, None, :]
    else:
        steps = torch.arange(s, dtype=f32, device=x.device)
        ang = (float(pos) + steps)[:, None] * inv         # [s, d/2]
        sin, cos = ang.sin()[None, :, None, :], ang.cos()[None, :, None, :]
    sin, cos = sin.to(x.dtype), cos.to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


class PagedRows(NamedTuple):
    """Where the s new rows of each slot live in the paged pools:
    absolute positions [S, s] int32, and the block id and in-block offset
    each row's KV is written to. The same for every layer of a step."""
    pos: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor


def paged_rows(block_table, positions, s: int, block_size: int,
               num_valid=None) -> PagedRows:
    """Row addresses of a slot-batched step: row j of slot i sits at
    positions[i] + j. Rows past the table, and padding rows
    (j >= num_valid[i]), are routed to the null block 0."""
    steps = torch.arange(s, dtype=positions.dtype, device=positions.device)
    pos = positions[:, None] + steps[None, :]                 # [S, s]
    idx = pos // block_size
    nb = block_table.shape[1]
    blk = torch.gather(block_table, 1, idx.clamp_max(nb - 1).long())
    blk = torch.where(idx < nb, blk, 0)
    if num_valid is not None:
        blk = torch.where(steps[None, :] < num_valid[:, None], blk, 0)
    return PagedRows(pos, blk, pos % block_size)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = ColumnParallelLinear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size)
        self.rope = cfg.position_embedding == "rope"
        self.rope_theta = cfg.rope_theta

    def _qkv(self, x):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, self.head_dim)
        return qkv.unbind(2)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None):
        """cache: optional {"k", "v"} [B, L_max, H, D] contiguous cache,
        written in place at [pos, pos + s). Prefill (pos = 0) runs causal
        attention over the new tokens; a later step attends cache[0 .. p]
        for the row at absolute position p."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        if self.rope:
            p0 = 0 if pos is None else int(pos)
            q = _apply_rope(q, p0, self.rope_theta)
            k = _apply_rope(k, p0, self.rope_theta)
        if cache is None or int(pos) == 0:
            if cache is not None:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            p = int(pos)
            cache["k"][:, p:p + s] = k
            cache["v"][:, p:p + s] = v
            L = cache["k"].shape[1]
            cols = torch.arange(L, device=x.device)
            rows = p + torch.arange(s, device=x.device)[:, None]
            bias = torch.where(cols[None, :] <= rows, 0.0, -1e9)  # [s, L]
            mask = bias[None, None].expand(b, 1, s, L)
            out = F.scaled_dot_product_attention(q, cache["k"], cache["v"],
                                                 attn_mask=mask)
        out = self.proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if cache is not None:
            return out, cache
        return out

    def forward_paged(self, x, k_pool, v_pool, block_table, rows: PagedRows,
                      block_size: int):
        """Slot-batched step over the PAGED KV pools: each batch row is an
        independent request slot addressing the shared pools through its
        block table.

        x [S, s, hidden]; k_pool/v_pool [num_blocks, block_size, H, D]
        fp pools or ``QuantizedKV`` (updated in place: the new rows' KV
        goes to rows.blk / rows.off, quantized per row for a quantized
        pool); block_table [S, M] int32 (tail -> null block 0); rows from
        ``paged_rows``. Row j of slot i attends columns [0 .. pos[i, j]],
        through the int8 branch of the paged kernel for a quantized pool.
        Returns (out [S, s, hidden], k_pool, v_pool)."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        if self.rope:
            q = _apply_rope(q, rows.pos, self.rope_theta)
            k = _apply_rope(k, rows.pos, self.rope_theta)
        kvq.write_rows(k_pool, rows.blk, rows.off, k)
        kvq.write_rows(v_pool, rows.blk, rows.off, v)
        if kvq.is_quantized(k_pool):
            out = paged_attention(q.contiguous(), k_pool.data, v_pool.data,
                                  block_table, rows.pos,
                                  block_size=block_size,
                                  k_scale=k_pool.scale, v_scale=v_pool.scale)
        else:
            out = paged_attention(q.contiguous(), k_pool, v_pool,
                                  block_table, rows.pos,
                                  block_size=block_size)
        out = self.proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out, k_pool, v_pool


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.ffn_hidden_size)
        self.fc2 = RowParallelLinear(cfg.ffn_hidden_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(torch_F.gelu(self.fc1(x), approximate="none"))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = GPTMLP(cfg)

    def forward(self, x, cache=None, pos=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache=cache, pos=pos)
            x = x + a
            return x + self.mlp(self.ln2(x)), cache
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def forward_paged(self, x, k_pool, v_pool, block_table, rows: PagedRows,
                      block_size: int):
        a, k_pool, v_pool = self.attn.forward_paged(
            self.ln1(x), k_pool, v_pool, block_table, rows, block_size)
        x = x + a
        return x + self.mlp(self.ln2(x)), k_pool, v_pool


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.position_embedding == "learned":
            self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                    cfg.hidden_size)
        self.blocks = nn.ModuleList([GPTBlock(cfg)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def _param(self) -> torch.Tensor:
        return self.wte.weight

    def forward_pre(self, input_ids, start_pos: int = 0):
        """Token (+ learned position) embedding."""
        x = self.wte(input_ids)
        if self.cfg.position_embedding == "rope":
            return x  # positions enter per layer through q/k
        s = input_ids.shape[1]
        pos = torch.arange(start_pos, start_pos + s, device=x.device)
        return x + self.wpe(pos)[None]

    def forward(self, input_ids, caches: Optional[List[dict]] = None,
                pos: Optional[int] = None):
        x = self.forward_pre(input_ids, start_pos=int(pos or 0))
        if caches is not None:
            for i, blk in enumerate(self.blocks):
                x, caches[i] = blk(x, cache=caches[i], pos=pos)
            return self.ln_f(x), caches
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    def _kv_shape(self, lead: Tuple[int, int]):
        cfg = self.cfg
        return (*lead, cfg.num_heads, cfg.hidden_size // cfg.num_heads)

    def init_caches(self, batch_size: int, max_len: int) -> List[dict]:
        """Per-layer contiguous KV caches [B, max_len, H, D] in the model's
        dtype, on its device."""
        w = self._param()
        shape = self._kv_shape((batch_size, max_len))
        return [{"k": torch.zeros(shape, dtype=w.dtype, device=w.device),
                 "v": torch.zeros(shape, dtype=w.dtype, device=w.device)}
                for _ in range(self.cfg.num_layers)]

    def init_kv_pools(self, num_blocks: int, block_size: int):
        """Per-layer paged KV pools [num_blocks, block_size, H, Dp] in the
        model's dtype, on its device, all zeros. Dp is the head dim, or the
        next one the paged kernel is built for (the extra columns stay
        zero: writes pad the rows). Block 0 is the reserved null block:
        idle slots and padded table tails address it; it is never
        allocated to a sequence. Returns (k_pools, v_pools)."""
        w = self._param()
        *lead, d = self._kv_shape((num_blocks, block_size))
        shape = (*lead, padded_head_dim(d))

        def pools():
            return [torch.zeros(shape, dtype=w.dtype, device=w.device)
                    for _ in range(self.cfg.num_layers)]

        return pools(), pools()

    def forward_pre_paged(self, input_ids, positions):
        """Embedding with PER-SLOT positions (serving decode)."""
        x = self.wte(input_ids)
        if self.cfg.position_embedding == "rope":
            return x
        s = input_ids.shape[1]
        steps = torch.arange(s, dtype=positions.dtype, device=x.device)
        return x + self.wpe(positions[:, None] + steps[None, :])

    def forward_paged(self, input_ids, k_pools, v_pools, block_table,
                      positions, block_size: int, num_valid=None):
        """Slot-batched paged forward through every layer: input_ids
        [S, s], per-layer pools (updated in place), block_table [S, M] and
        positions [S] int32, optional num_valid [S] (rows j >=
        num_valid[i] are padding). Returns (hidden, k_pools, v_pools)."""
        x = self.forward_pre_paged(input_ids, positions)
        # the rows' pool addresses are the same in every layer
        rows = paged_rows(block_table, positions, input_ids.shape[1],
                          block_size, num_valid)
        for i, blk in enumerate(self.blocks):
            x, k_pools[i], v_pools[i] = blk.forward_paged(
                x, k_pools[i], v_pools[i], block_table, rows, block_size)
        return self.ln_f(x), k_pools, v_pools


class GPTForCausalLM(nn.Module):
    """The serving model. Runs on the CUDA card unless ``device`` names
    another; weights are random from ``seed`` (or carried over with
    ``load_state_dict(convert.from_jax_state(sd, model))``). Inference only:
    parameters take no gradient."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.gpt = GPTModel(cfg)
        self.to_empty(device="cpu")
        self._init_weights(fw_random.seed(seed))
        self.to(device=dev, dtype=dtype)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """The reference's initialisers: Xavier-uniform linears with zero
        biases, N(0, initializer_range) embeddings, unit LayerNorms."""
        std = self.gpt.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = math.sqrt(6.0 / (mod.in_features + mod.out_features))
                mod.weight.uniform_(-bound, bound, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, std, generator=g)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids):
        return self.forward_head(self.gpt(input_ids))

    def forward_head(self, h):
        """LM head tied to the token embedding."""
        return torch_F.linear(h, self.gpt.wte.weight)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 temperature: float = 1.0, top_k: int = 0, seed=None,
                 eos_token_id=None) -> torch.Tensor:
        """Autoregressive decode with a contiguous KV cache. Greedy when
        top_k == 0, else top-k sampling from a generator seeded with
        ``seed``. Returns [B, S + T] int32 ids on the CPU, T <=
        max_new_tokens: with eos_token_id a row finishes once it emits eos
        (finished rows pad with eos) and the loop stops when every row is
        done — the engine's per-request EOS rule."""
        cfg = self.gpt.cfg
        ids = torch.as_tensor(input_ids).to(device="cpu", dtype=torch.int64)
        B, S = ids.shape
        total = S + max_new_tokens
        if (cfg.position_embedding == "learned"
                and total > cfg.max_position_embeddings):
            raise ValueError(f"generate: {total} tokens exceed "
                             f"max_position_embeddings="
                             f"{cfg.max_position_embeddings}")
        g = fw_random.seed(seed)
        caches = self.gpt.init_caches(B, total)
        h, caches = self.gpt(ids.to(self.device), caches=caches, pos=0)
        out_ids = [ids]
        finished = torch.zeros(B, dtype=torch.bool)
        cur = None
        for step in range(max_new_tokens):
            if cur is None:
                logits = self.forward_head(h[:, -1:])
            else:
                h, caches = self.gpt(cur.to(self.device), caches=caches,
                                     pos=S + step - 1)
                logits = self.forward_head(h)
            lg = logits[:, -1].float()
            if top_k and top_k > 0:
                nxt = fw_random.sample_top_k(lg, top_k, temperature, g)
            else:
                nxt = lg.argmax(-1).cpu()
            if eos_token_id is not None:
                nxt = torch.where(finished, int(eos_token_id), nxt)
            cur = nxt[:, None]
            out_ids.append(cur)
            if eos_token_id is not None:
                finished |= nxt == eos_token_id
                if bool(finished.all()):
                    break
        return torch.cat(out_ids, dim=1).to(torch.int32)
