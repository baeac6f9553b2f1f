"""Flash attention: the hand-written CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), their plain PyTorch versions, and the autograd
function that joins them.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Layout
[batch, seq, heads, head_dim] at the API. ``kv_bias`` is an additive
[batch, kv_len] f32 term (key-padding masks) that takes no gradient.
``dropout_p`` drops attention probabilities by a hash of the absolute
(batch, head, row, col) position and an int seed (``dropout_keep``), so the
backward regenerates the forward's mask and kernel, plain version and JAX
package draw the same mask bit for bit. ``window`` (with ``causal``) lets
row r see columns [r - window, r]. The TPU wrapper's block picking and
ragged-tail padding have no counterpart here: the kernels' 64-row tiles
mask the ragged edge in place. A head dim the kernels are not built for
(up to 128) is zero-padded to the next one by ``flash_attention``, at the
unpadded scale, and the results are sliced back.

``flash_attention_fwd`` / ``flash_attention_bwd`` launch the kernels for
CUDA tensors and take the plain versions for CPU tensors; there is no
other fallback. A row whose every entry is masked gives zeros (and
lse = NEG_INF) and zero gradients.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._cuda import DTYPE_CODES, HEAD_DIMS, CudaKernel, padded_head_dim

__all__ = ["NEG_INF", "FlashAttentionFunction", "dropout_keep",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "delta_of",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_plain", "flash_attention_supported", "KERNEL",
           "DKV_KERNEL", "DQ_KERNEL", "probe_dropout_masks"]

NEG_INF = -1e30  # finite floor of the running max (the TPU kernel's sentinel)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# shape, scale, causal, window, dropout (on, seed, thresh, inv_keep), dtype
_TAIL = [_I, _I, _I, _I, _I, _F, _I, _I, _I, _U, _U, _F, _I, _P]
KERNEL = CudaKernel("flash_fwd.cu", "flash_fwd", [_P] * 6 + _TAIL)
DKV_KERNEL = CudaKernel("flash_bwd.cu", "flash_bwd_dkv", [_P] * 9 + _TAIL)
DQ_KERNEL = CudaKernel("flash_bwd.cu", "flash_bwd_dq", [_P] * 8 + _TAIL)

_M32 = 0xFFFFFFFF


def flash_attention_supported(q_shape, k_shape, causal: bool = False) -> bool:
    """Shape gate for the kernel path (else callers use the plain masked
    softmax of ops/attention.py) — the TPU package's gate: sequences of at
    least 128 on both sides, and square when causal; head dims up to the
    largest the kernels are built for (the TPU gate takes up to 512; above
    128 the port takes the plain path, as the TPU package takes XLA's above
    512)."""
    Sq, D = q_shape[1], q_shape[3]
    Sk = k_shape[1]
    if Sq < 128 or Sk < 128:
        return False
    if D > max(HEAD_DIMS):
        return False
    if causal and Sq != Sk:
        return False
    return True


# ------------------------------------------------------------- dropout --
def _dropout_consts(dropout_p: float, seed: int) -> Tuple[int, int, float]:
    """(seed as uint32, keep threshold, 1 / (1 - p)) as the kernels take
    them: a negative int32 seed wraps as numpy's astype(uint32) does, and
    the threshold is computed in doubles as the TPU kernel's is."""
    thresh = min(int(dropout_p * 4294967296.0), 4294967295)
    return int(seed) & _M32, thresh, 1.0 / (1.0 - dropout_p)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c,
    with every intermediate below 2^49 (no int64 overflow)."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_keep(seed: int, dropout_p: float, batch, head, rows,
                 cols) -> torch.Tensor:
    """Keep mask of attention-probability dropout (``_dropout_keep``): a
    murmur3 finalizer over the absolute position and the seed, in uint32
    arithmetic carried in int64. ``batch``, ``head``, ``rows`` and ``cols``
    are int64 tensors (or ints) that broadcast against each other; the
    result has their broadcast shape. True = keep; P(drop) = dropout_p."""
    seed_u, thresh, _ = _dropout_consts(dropout_p, seed)
    t = [torch.as_tensor(a, dtype=torch.int64) for a in (batch, head, rows,
                                                         cols)]
    b, h, r, c = t
    mix = (_mul32(b, 1315423911) + _mul32(h, 2654435761)
           + ((seed_u * 0x9E3779B9) & _M32)) & _M32
    x = ((_mul32(r, 2654435761) ^ _mul32(c, 0x85EBCA6B)) + mix) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= thresh


def _keep_bhqk(seed, dropout_p, B, H, Sq, Sk, device) -> torch.Tensor:
    """[B, H, Sq, Sk] keep mask for a whole attention call."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    return dropout_keep(seed, dropout_p, ar(B)[:, None, None, None],
                        ar(H)[None, :, None, None], ar(Sq)[:, None],
                        ar(Sk)[None, :])


# ------------------------------------------------------ plain versions --
def _scores(q, k, kv_bias, causal, scale, window):
    """f32 scores [B, H, Sq, Sk] with masked entries at -inf."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        band = cols <= rows
        if window:
            band = band & (rows - cols <= window)
        s = s.masked_fill(~band, float("-inf"))
    return s


def _scale(q, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_plain(q, k, v, kv_bias=None, causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_p: float = 0.0, seed: int = 0,
                          window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax attention in f32, vectorised over every axis.
    Returns (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32). With
    dropout the denominator sums every p and the output the kept p
    scaled by 1 / (1 - p); lse is that of the undropped p."""
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    scores = _scores(q, k, kv_bias, causal, _scale(q, scale), window)
    m = scores.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(scores - m)  # masked entries: exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if dropout_p > 0.0:
        keep = _keep_bhqk(seed, dropout_p, B, H, Sq, Sk, q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.transpose(1, 2)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def delta_of(out, dout) -> torch.Tensor:
    """rowsum(dO * O) [B, H, Sq] f32, from the dropped output."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, kv_bias, out, lse, dout,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              dropout_p: float = 0.0, seed: int = 0,
                              window: int = 0):
    """(dq, dk, dv) in the inputs' dtypes, computed in f32 from the
    forward's out and lse as the TPU backward does: p recomputed from lse,
    dP = dO V^T with the regenerated mask, dS = p (dP - delta) scale with
    delta = rowsum(dO * O)."""
    return _bwd_plain(q, k, v, kv_bias, lse, delta_of(out, dout), dout,
                      causal, scale, dropout_p, seed, window)


def _bwd_plain(q, k, v, kv_bias, lse, delta, dout, causal, scale, dropout_p,
               seed, window):
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    s = _scale(q, scale)
    p = torch.exp(_scores(q, k, kv_bias, causal, s, window) - lse[..., None])
    do = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    p_drop = p
    if dropout_p > 0.0:
        keep = _keep_bhqk(seed, dropout_p, B, H, Sq, Sk, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        p_drop = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta[..., None]) * s
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- kernels --
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


def _device(*tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"flash attention: tensors on {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {dev}")
    return dev


def _kernel_checks(q, k, kv_bias, causal, named):
    """What the kernels take: raises on anything else."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[3]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash attention kernel: dtype {q.dtype} "
                         "(takes float32, bfloat16 or float16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} "
                         f"(takes {HEAD_DIMS})")
    if causal and Sq != Sk:
        raise ValueError("flash attention kernel: causal needs Sq == Sk")
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
    if kv_bias is not None:
        if kv_bias.dtype != torch.float32 or not kv_bias.is_contiguous():
            raise ValueError("flash attention kernel: kv_bias must be "
                             "contiguous float32")


def _tail(q, k, scale, causal, window, dropout_p, seed):
    """The kernels' shared trailing arguments (shape .. stream)."""
    B, Sq, H, D = q.shape
    seed_u, thresh, inv = _dropout_consts(dropout_p, seed)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (B, Sq, k.shape[1], H, D, _scale(q, scale), int(bool(causal)),
            int(window), int(dropout_p > 0.0), seed_u, thresh, inv,
            DTYPE_CODES[q.dtype], stream)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, kv_bias=None, causal: bool = False,
                        scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed: int = 0,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B, H, Sq] f32). CUDA tensors launch the
    kernel (or raise); CPU tensors take ``flash_attention_plain``."""
    _check(q, k, v, kv_bias)
    dev = _device(q, k, v, kv_bias)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, kv_bias, causal, scale,
                                     dropout_p, seed, window)
    _kernel_checks(q, k, kv_bias, causal, (("q", q), ("k", k), ("v", v)))
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_bias),
                  out.data_ptr(), lse.data_ptr(),
                  *_tail(q, k, scale, causal, window, dropout_p, seed))
    return out, lse


def flash_attention_bwd(q, k, v, kv_bias, out, lse, dout,
                        causal: bool = False, scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed: int = 0,
                        window: int = 0):
    """(dq, dk, dv). CUDA tensors take delta = rowsum(dO * O) and launch
    ``flash_bwd_dkv`` then ``flash_bwd_dq`` (or raise); CPU tensors take
    ``flash_attention_bwd_plain``."""
    _check(q, k, v, kv_bias)
    dev = _device(q, k, v, kv_bias, out, lse, dout)
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_bias, out, lse, dout,
                                         causal, scale, dropout_p, seed,
                                         window)
    args = (q, k, v, kv_bias, lse.contiguous(), delta_of(out, dout), dout,
            causal, scale, dropout_p, seed, window)
    dk, dv = flash_attention_bwd_dkv(*args)
    return flash_attention_bwd_dq(*args), dk, dv


def _bwd_launch(kernel, outs, q, k, v, kv_bias, lse, delta, dout, causal,
                scale, dropout_p, seed, window):
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash attention backward: dout must match q")
    B, Sq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"flash attention backward: {name} must be "
                             f"contiguous float32 {(B, H, Sq)}")
    _kernel_checks(q, k, kv_bias, causal, (("q", q), ("k", k), ("v", v),
                                           ("dout", dout)))
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_bias),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  *(t.data_ptr() for t in outs),
                  *_tail(q, k, scale, causal, window, dropout_p, seed))


def flash_attention_bwd_dkv(q, k, v, kv_bias, lse, delta, dout,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed: int = 0,
                            window: int = 0):
    """(dk, dv): ``flash_bwd_dkv`` for CUDA tensors (or raise), the plain
    backward for CPU tensors. delta = ``delta_of(out, dout)``."""
    args = (q, k, v, kv_bias, lse, delta, dout, causal, scale, dropout_p,
            seed, window)
    _check(q, k, v, kv_bias)
    if _device(q, k, v, kv_bias, lse, delta, dout).type == "cpu":
        return _bwd_plain(*args)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(DKV_KERNEL, (dk, dv), *args)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, kv_bias, lse, delta, dout,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0, seed: int = 0,
                           window: int = 0):
    """dq: ``flash_bwd_dq`` for CUDA tensors (or raise), the plain backward
    for CPU tensors. delta = ``delta_of(out, dout)``."""
    args = (q, k, v, kv_bias, lse, delta, dout, causal, scale, dropout_p,
            seed, window)
    _check(q, k, v, kv_bias)
    if _device(q, k, v, kv_bias, lse, delta, dout).type == "cpu":
        return _bwd_plain(*args)[0]
    dq = torch.empty_like(q)
    _bwd_launch(DQ_KERNEL, (dq,), *args)
    return dq


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd around the kernels (``_flash_bhsd``'s custom VJP): the
    forward keeps q, k, v, kv_bias, out and lse, and the seed as a host
    int; kv_bias takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale, dropout_p, seed,
                window):
        out, lse = flash_attention_fwd(q, k, v, kv_bias, causal, scale,
                                       dropout_p, seed, window)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (causal, scale, dropout_p, seed, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_bias, out, lse,
                                         dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, kv_bias=None, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    window_size: Optional[int] = None) -> torch.Tensor:
    """Flash attention on [B, S, H, D] inputs; returns [B, Sq, H, D].

    ``dropout_p`` / ``dropout_seed``: attention-probability dropout inside
    the kernel, regenerated from the seed (a host int) in backward.
    ``window_size``: sliding-window attention, row r sees [r - w, r];
    needs ``causal`` and w >= 1. Differentiable in q, k and v. A head dim
    D that is not one of ``HEAD_DIMS`` but below the largest goes in
    zero-padded to the next one: the zero columns add nothing to q.k, the
    scale stays 1 / sqrt(D), and the output (and through autograd dq, dk,
    dv) is sliced back to D."""
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp != D:
        pad = (0, Dp - D)
        out = flash_attention(
            torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), kv_bias, causal,
            1.0 / math.sqrt(D) if scale is None else scale, dropout_p,
            dropout_seed, window_size)
        return out[..., :D]
    if window_size is not None:
        if not causal:
            raise ValueError("window_size (sliding-window attention) "
                             "requires causal=True")
        if int(window_size) < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size} "
                             "(a 0/negative band would silently degenerate)")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_attention: dropout_p must be in [0, 1), got "
                         f"{dropout_p} (p=1 drops everything: use the plain "
                         "attention, which returns zeros)")
    args = (kv_bias, causal, scale, float(dropout_p),
            0 if dropout_seed is None else int(dropout_seed),
            int(window_size or 0))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, *args)
    return flash_attention_fwd(q, k, v, *args)[0]


def probe_dropout_masks(B: int, H: int, S: int, dropout_p: float, seed: int,
                        device, dtype=torch.float32) -> dict:
    """Read back the keep mask that each of the three flash functions
    applies, as [B, H, S, S] bools keyed "fwd", "dkv" and "dq" (on CUDA
    the kernels', on the CPU the plain versions'), from calls in ``dtype``
    (on CUDA, bf16 / f16 take the tensor-core kernels, f32 the CUDA-core
    ones) whose inputs make every score 0 and route one column or row of
    the mask into each output element (64 at a time):

    - fwd: v one-hot over keys [c0, c0 + 64), other keys masked by
      kv_bias, so out[b, row, h, d] = keep(row, c0 + d) / (64 (1 - p));
    - dkv: dO one-hot over rows [c0, c0 + 64), so dV[b, key, h, d] is
      p_drop(c0 + d, key);
    - dq: dO = V = e_0, so dP = 1 before dropout and, with K one-hot over
      keys [c0, c0 + 64), dQ[b, row, h, d] is dS(row, c0 + d).

    Each entry is > 0 where kept and exactly 0 where dropped."""
    D, f32 = 64, torch.float32
    z = torch.zeros(B, S, H, D, dtype=dtype, device=device)
    e0 = z.clone()
    e0[..., 0] = 1.0
    lse = torch.full((B, H, S), math.log(S), dtype=f32, device=device)
    masks = {n: torch.zeros(B, H, S, S, dtype=torch.bool, device=device)
             for n in ("fwd", "dkv", "dq")}
    kw = dict(dropout_p=dropout_p, seed=seed)
    for c0 in range(0, S, D):
        n = min(D, S - c0)
        idx = torch.arange(n, device=device)
        onehot = z.clone()
        onehot[:, c0 + idx, :, idx] = 1.0
        bias = torch.full((B, S), float("-inf"), device=device)
        bias[:, c0:c0 + n] = 0.0
        out, _ = flash_attention_fwd(z, z, onehot, bias, **kw)
        masks["fwd"][..., c0:c0 + n] = (out[..., :n] > 0).transpose(1, 2)
        _, _, dv = flash_attention_bwd(z, z, z, None, z, lse, onehot, **kw)
        masks["dkv"][:, :, c0:c0 + n] = (dv[..., :n] > 0).permute(0, 2, 3, 1)
        dq, _, _ = flash_attention_bwd(z, onehot, e0, None, z, lse, e0, **kw)
        masks["dq"][..., c0:c0 + n] = (dq[..., :n] > 0).transpose(1, 2)
    return masks
