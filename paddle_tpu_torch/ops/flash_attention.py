"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version.

Port of the forward half of ``paddle_tpu/ops/pallas/flash_attention.py``.
Layout [batch, seq, heads, head_dim] at the API. ``kv_bias`` is an additive
[batch, kv_len] f32 term (key-padding masks). The TPU wrapper's block
picking and ragged-tail padding have no counterpart here: the kernel's
64-row tiles mask the ragged edge in place.

``flash_attention_fwd`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; there is no other fallback. A row whose
every entry is masked gives zeros (and lse = NEG_INF).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._cuda import DTYPE_CODES, HEAD_DIMS, CudaKernel

__all__ = ["NEG_INF", "flash_attention", "flash_attention_fwd",
           "flash_attention_plain", "flash_attention_supported", "KERNEL"]

NEG_INF = -1e30  # finite floor of the running max (the TPU kernel's sentinel)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flash_fwd.cu", "flash_fwd",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _I, _P])


def flash_attention_supported(q_shape, k_shape, causal: bool = False) -> bool:
    """Shape gate for the kernel path (else callers use the plain masked
    softmax of ops/attention.py) — the same gate as the TPU package's:
    sequences of at least 128 on both sides, and square when causal."""
    Sq, D = q_shape[1], q_shape[3]
    Sk = k_shape[1]
    if Sq < 128 or Sk < 128:
        return False
    if D > 512:
        return False
    if causal and Sq != Sk:
        return False
    return True


def flash_attention_plain(q, k, v, kv_bias=None, causal: bool = False,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax attention in f32, vectorised over every axis.
    Returns (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)."""
    D = q.shape[-1]
    Sq, Sk = q.shape[1], k.shape[1]
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if kv_bias is not None:
        scores = scores + kv_bias.float()[:, None, None, :]
    if causal:
        band = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~band, float("-inf"))
    m = scores.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)  # masked entries: exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.transpose(1, 2)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def _check(q, k, v, kv_bias):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "[B, S, H, D] with k and v alike")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError("flash attention: q and k disagree on B, H or D")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash attention: q, k, v dtypes differ")
    if kv_bias is not None and tuple(kv_bias.shape) != (B, k.shape[1]):
        raise ValueError(f"flash attention: kv_bias {tuple(kv_bias.shape)} "
                         f"must be [B, Sk] = {(B, k.shape[1])}")


def flash_attention_fwd(q, k, v, kv_bias=None, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B, H, Sq] f32). CUDA tensors launch the
    kernel (or raise); CPU tensors take ``flash_attention_plain``."""
    _check(q, k, v, kv_bias)
    devices = {q.device, k.device, v.device}
    if kv_bias is not None:
        devices.add(kv_bias.device)
    if len(devices) != 1:
        raise ValueError(f"flash attention: tensors on {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, kv_bias, causal, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {dev}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash attention kernel: dtype {q.dtype} "
                         "(takes float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} "
                         f"(takes {HEAD_DIMS})")
    if causal and Sq != Sk:
        raise ValueError("flash attention kernel: causal needs Sq == Sk")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if kv_bias is not None:
        if kv_bias.dtype != torch.float32 or not kv_bias.is_contiguous():
            raise ValueError("flash attention kernel: kv_bias must be "
                             "contiguous float32")
    s = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if kv_bias is None else kv_bias.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, D, s,
                  int(bool(causal)), DTYPE_CODES[q.dtype], stream)
    return out, lse


def flash_attention(q, k, v, kv_bias=None, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on [B, S, H, D] inputs; returns [B, Sq, H, D]."""
    return flash_attention_fwd(q, k, v, kv_bias, causal, scale)[0]
