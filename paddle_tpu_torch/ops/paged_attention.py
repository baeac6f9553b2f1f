"""Paged attention: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``, fp pools and int8
pools with scales. Layout contract (the serving pools'):

  q           [B, s, H, D]   new-token queries (s = 1 decode)
  k/v_pool    [NB, BS, H, Dp] pools shared by every sequence; block 0 is
                             the reserved null block. q's dtype, or int8
                             with k/v_scale [NB, BS, H, 1] f32 (one absmax
                             scale per pool row and head; the row
                             dequantizes as pool * scale)
  block_table [B, M] int32   per-slot block ids (tail -> null block 0)
  positions   [B, s] int32   absolute position of each query row; the row
                             attends logical columns [0 .. pos], where
                             column t lives at (block_table[b, t // BS],
                             t % BS). pos = -1 rows give zeros.

Dp is D, or a wider head dim whose extra columns hold zeros (pools of a
head dim the kernel is not built for are allocated at the next one; see
``models/gpt.py``): q is then zero-padded to Dp, the scale stays
1 / sqrt(D) and the output is sliced back to D.

``paged_attention`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; ``KERNEL.launches`` counts the fp pools'
launches and ``INT8_KERNEL.launches`` the int8 pools'.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._cuda import DTYPE_CODES, HEAD_DIMS, CudaKernel
from .flash_attention import NEG_INF

__all__ = ["paged_attention", "paged_attention_plain", "KERNEL",
           "INT8_KERNEL"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
KERNEL = CudaKernel("paged_attention.cu", "paged_attention",
                    [_P] * 6 + _TAIL)
INT8_KERNEL = CudaKernel("paged_attention.cu", "paged_attention_int8",
                         [_P] * 8 + _TAIL)


def paged_attention_plain(q, k_pool, v_pool, block_table, positions, *,
                          block_size: int, scale: Optional[float] = None,
                          k_scale=None, v_scale=None):
    """Gather every slot's blocks into its logical cache (dequantized as
    ``pool * scale`` in f32 when scales are given), mask ``col <= pos``,
    softmax in f32. Vectorised; q and the pools share the head dim;
    returns q's shape and dtype."""
    B, s, H, D = q.shape
    M = block_table.shape[1]
    L = M * int(block_size)
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    table = block_table.long()

    def logical(pool, pool_scale):
        rows = pool[table].reshape(B, L, H, D).float()
        if pool_scale is None:
            return rows
        return rows * pool_scale[table].reshape(B, L, H, 1)

    keys, vals = logical(k_pool, k_scale), logical(v_pool, v_scale)
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


def _check_scales(k_pool, v_pool, k_scale, v_scale):
    """Int8 pools need both scale pools, fp pools take none."""
    quantized = k_pool.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged attention: pass both k_scale and v_scale, "
                         "or neither")
    if quantized != (k_scale is not None) or (
            v_pool.dtype == torch.int8) != quantized:
        raise ValueError(f"paged attention: pools {k_pool.dtype}/"
                         f"{v_pool.dtype} with"
                         f"{'' if k_scale is not None else 'out'} scales "
                         "(int8 pools take k_scale and v_scale, fp pools "
                         "take none)")
    if quantized:
        want = (*k_pool.shape[:3], 1)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"paged attention: {name} "
                                 f"{tuple(t.shape)} {t.dtype} must be "
                                 f"float32 {want}")
    return quantized


def paged_attention(q, k_pool, v_pool, block_table, positions, *,
                    block_size: int, scale: Optional[float] = None,
                    k_scale=None, v_scale=None):
    """Paged attention over [B, s, H, D] queries; returns the same shape in
    q's dtype. ``k_scale``/``v_scale`` given: the pools are int8 payloads
    dequantized in-register (the ``QuantizedKV`` layout). CUDA tensors
    launch the kernel (or raise); CPU tensors take
    ``paged_attention_plain``."""
    B, s, H, D = q.shape
    NB, BS = k_pool.shape[0], k_pool.shape[1]
    Dp = k_pool.shape[-1] if k_pool.dim() == 4 else D
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 4
            or tuple(k_pool.shape[2:3]) != (H,) or Dp < D
            or BS != int(block_size)):
        raise ValueError(f"paged attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} must be [NB, {block_size}, "
                         f"{H}, >= {D}]")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"paged attention: block_table "
                         f"{tuple(block_table.shape)} must be [{B}, M]")
    if tuple(positions.shape) != (B, s):
        raise ValueError(f"paged attention: positions "
                         f"{tuple(positions.shape)} must be [{B}, {s}]")
    quantized = _check_scales(k_pool, v_pool, k_scale, v_scale)
    tensors = (q, k_pool, v_pool, block_table, positions) + (
        (k_scale, v_scale) if quantized else ())
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"paged attention: tensors on {devices}")
    dev = devices.pop()
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if Dp != D:  # the pools' extra columns are zeros
        out = paged_attention(
            torch.nn.functional.pad(q, (0, Dp - D)), k_pool, v_pool,
            block_table, positions, block_size=block_size, scale=sc,
            k_scale=k_scale, v_scale=v_scale)
        return out[..., :D]
    if dev.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     positions, block_size=block_size,
                                     scale=sc, k_scale=k_scale,
                                     v_scale=v_scale)
    if dev.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {dev}")
    if q.dtype not in DTYPE_CODES or not (
            quantized or q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError(f"paged attention kernel: q {q.dtype}, pools "
                         f"{k_pool.dtype}/{v_pool.dtype} (takes q in one of "
                         "float32, bfloat16, float16, and pools in q's "
                         "dtype or int8 with scales)")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {D} "
                         f"(takes {HEAD_DIMS})")
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("paged attention kernel: block_table and "
                         "positions must be int32")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_table", block_table), ("positions", positions)]
    if quantized:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (out.data_ptr(), B, s, H, D, NB, block_table.shape[1],
            int(block_size), sc, DTYPE_CODES[q.dtype], stream)
    if quantized:
        INT8_KERNEL.launch(q.data_ptr(), k_pool.data_ptr(),
                           v_pool.data_ptr(), k_scale.data_ptr(),
                           v_scale.data_ptr(), block_table.data_ptr(),
                           positions.data_ptr(), *tail)
    else:
        KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      block_table.data_ptr(), positions.data_ptr(), *tail)
    return out
