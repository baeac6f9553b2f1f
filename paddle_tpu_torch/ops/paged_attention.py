"""Paged attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/paged_attention.py`` for fp pools. Layout
contract (the serving pools'):

  q           [B, s, H, D]   new-token queries (s = 1 decode)
  k/v_pool    [NB, BS, H, D] pools shared by every sequence; block 0 is the
                             reserved null block
  block_table [B, M] int32   per-slot block ids (tail -> null block 0)
  positions   [B, s] int32   absolute position of each query row; the row
                             attends logical columns [0 .. pos], where
                             column t lives at (block_table[b, t // BS],
                             t % BS). pos = -1 rows give zeros.

``paged_attention`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; ``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._cuda import DTYPE_CODES, HEAD_DIMS, CudaKernel
from .flash_attention import NEG_INF

__all__ = ["paged_attention", "paged_attention_plain", "KERNEL"]

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("paged_attention.cu", "paged_attention",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])


def paged_attention_plain(q, k_pool, v_pool, block_table, positions, *,
                          block_size: int, scale: Optional[float] = None):
    """Gather every slot's blocks into its logical cache, mask
    ``col <= pos``, softmax in f32. Vectorised; returns q's shape and
    dtype."""
    B, s, H, D = q.shape
    M = block_table.shape[1]
    L = M * int(block_size)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    table = block_table.long()
    keys = k_pool[table].reshape(B, L, H, D).float()
    vals = v_pool[table].reshape(B, L, H, D).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys) * sc
    cols = torch.arange(L, device=q.device)
    visible = cols[None, None, :] <= positions.long()[:, :, None]  # [B,s,L]
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    m = scores.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vals)
    return out.to(q.dtype)


def paged_attention(q, k_pool, v_pool, block_table, positions, *,
                    block_size: int, scale: Optional[float] = None):
    """Paged attention over [B, s, H, D] queries; returns the same shape in
    q's dtype. CUDA tensors launch the kernel (or raise); CPU tensors take
    ``paged_attention_plain``."""
    B, s, H, D = q.shape
    NB, BS = k_pool.shape[0], k_pool.shape[1]
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or tuple(k_pool.shape[2:]) != (H, D) or BS != int(block_size)):
        raise ValueError(f"paged attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} must be [NB, {block_size}, "
                         f"{H}, {D}]")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"paged attention: block_table "
                         f"{tuple(block_table.shape)} must be [{B}, M]")
    if tuple(positions.shape) != (B, s):
        raise ValueError(f"paged attention: positions "
                         f"{tuple(positions.shape)} must be [{B}, {s}]")
    devices = {t.device for t in (q, k_pool, v_pool, block_table, positions)}
    if len(devices) != 1:
        raise ValueError(f"paged attention: tensors on {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     positions, block_size=block_size,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {dev}")
    if (not (q.dtype == k_pool.dtype == v_pool.dtype)
            or q.dtype not in DTYPE_CODES):
        raise ValueError(f"paged attention kernel: q {q.dtype}, pools "
                         f"{k_pool.dtype}/{v_pool.dtype} (takes one of "
                         "float32, bfloat16 for all three)")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {D} "
                         f"(takes {HEAD_DIMS})")
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("paged attention kernel: block_table and "
                         "positions must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("positions", positions)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_table.data_ptr(), positions.data_ptr(),
                  out.data_ptr(), B, s, H, D, NB, block_table.shape[1],
                  int(block_size), sc, DTYPE_CODES[q.dtype], stream)
    return out
