"""paddle_tpu_torch flash-attention forward vs the JAX package's.

The port's wrapper on CPU tensors runs its plain PyTorch version (masked
softmax in f32); it is held against the JAX Pallas forward kernel in
interpret mode, output and row log-sum-exp, on the same numpy inputs in
f32. Tolerance atol = rtol = 1e-5: the same f32 softmax in another
summation order (the kernel's online softmax over KV tiles against one
softmax over the whole row).

Also: the attention dispatch of ``nn.functional`` against the JAX
package's ``scaled_dot_product_attention`` on both sides of its 128-token
gate.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as jF
from paddle_tpu.framework.core import Tensor
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _mk(seed, S, B=2, H=2, D=32, bias=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    kvb = None
    if bias == "padding":  # key-padding rows: batch 0 masks its last 40 keys
        kvb = np.zeros((B, S), np.float32)
        kvb[0, S - 40:] = -1e9
    return q, k, v, kvb


def _jax_fwd(q, k, v, kvb, causal):
    """The JAX forward kernel (interpret mode) with the public wrapper's
    ragged padding, returning (out [B, S, H, D], lse [B, H, S])."""
    B, S, H, D = q.shape
    blk = jfa._pick_block(jfa._ceil_to(S, 128))
    Sp = jfa._ceil_to(S, blk)
    pad = ((0, 0), (0, 0), (0, Sp - S), (0, 0))
    qT, kT, vT = (jnp.pad(jnp.swapaxes(jnp.asarray(a), 1, 2), pad)
                  for a in (q, k, v))
    bias = None
    if Sp != S or kvb is not None:
        tail = jnp.where(jnp.arange(Sp) < S, 0.0, jfa.NEG_INF)
        bias = jnp.broadcast_to(tail, (B, Sp)).astype(jnp.float32)
        if kvb is not None:
            bias = bias + jnp.pad(jnp.asarray(kvb), ((0, 0), (0, Sp - S)))
    out, lse = jfa._fwd(qT, kT, vT, bias, jnp.zeros((1,), jnp.int32), causal,
                        1.0 / math.sqrt(D), blk, blk, True)
    return (np.asarray(jnp.swapaxes(out[:, :, :S], 1, 2)),
            np.asarray(lse[:, :, :S, 0]))


def _port(q, k, v, kvb, causal):
    out, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kvb is None else torch.from_numpy(kvb), causal=causal)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bias", [(128, None), (200, None),
                                    (200, "padding")])
def test_plain_matches_jax_forward_kernel(causal, S, bias):
    q, k, v, kvb = _mk(0, S, bias=bias)
    out, lse = _port(q, k, v, kvb, causal)
    want_out, want_lse = _jax_fwd(q, k, v, kvb, causal)
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse, want_lse, atol=ATOL, rtol=RTOL)
    # the public JAX entry agrees too (it pads and slices the same way)
    pub = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_bias=None if kvb is None else jnp.asarray(kvb), causal=causal,
        interpret=True))
    np.testing.assert_allclose(out, pub, atol=ATOL, rtol=RTOL)


def test_fully_masked_row_gives_zeros():
    """A batch row whose every key carries a -inf bias: zeros out and
    lse = NEG_INF, as the JAX kernel gives (non-causal, where no band mask
    puts its finite sentinel beside the -inf entries)."""
    q, k, v, _ = _mk(1, 160)
    kvb = np.zeros((2, 160), np.float32)
    kvb[1] = -np.inf
    out, lse = _port(q, k, v, kvb, causal=False)
    want_out, want_lse = _jax_fwd(q, k, v, kvb, causal=False)
    assert np.all(out[1] == 0.0) and np.all(want_out[1] == 0.0)
    assert np.all(lse[1] == tfa.NEG_INF)
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse, want_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [64, 160])
@pytest.mark.parametrize("mask", [None, "bool"])
def test_sdpa_dispatch_matches_jax(S, mask):
    """Below 128 tokens the plain masked softmax, from 128 up the flash
    path; a [B, 1, 1, S] bool key-padding mask lowers to kv_bias."""
    q, k, v, _ = _mk(2, S)
    m = None
    if mask == "bool":
        m = np.ones((2, 1, 1, S), bool)
        m[1, ..., S - 9:] = False
    want = jF.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)), Tensor(jnp.asarray(v)),
        attn_mask=None if m is None else Tensor(jnp.asarray(m)),
        is_causal=True, training=False).numpy()
    got = tF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if m is None else torch.from_numpy(m),
        is_causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_supported_gate_matches_jax():
    for qs, ks, causal in (((1, 128, 2, 64), (1, 128, 2, 64), True),
                           ((1, 127, 2, 64), (1, 127, 2, 64), False),
                           ((1, 256, 2, 64), (1, 128, 2, 64), True),
                           ((1, 256, 2, 64), (1, 128, 2, 64), False)):
        assert (tfa.flash_attention_supported(qs, ks, causal)
                == jfa.flash_attention_supported(qs, ks, causal))


@pytest.mark.parametrize("D", [48, 80])
def test_head_dim_outside_the_kernels_pads_at_the_unpadded_scale(D):
    """flash_attention zero-pads a head dim the kernels are not built for
    to the next one (48 -> 64, 80 -> 128), keeps the scale 1 / sqrt(D) and
    slices the output back: the plain version over the padded inputs
    equals the plain versions over the unpadded ones (the autograd
    function's plain forward and backward called at D itself), forward
    and backward (the zero columns add exact zeros; the products are
    summed over more terms, so 1e-6)."""
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 130, 2, D))
                                    .astype(np.float32)) for _ in range(4))
    leaves = [[t.clone().requires_grad_(True) for t in (q, k, v)]
              for _ in range(2)]
    got = tfa.flash_attention(*leaves[0], causal=True)
    want = tfa.FlashAttentionFunction.apply(*leaves[1], None, True, None,
                                            0.0, 0, 0)
    assert got.shape == want.shape == (2, 130, 2, D)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    (got * do).sum().backward()
    (want * do).sum().backward()
    for a, b in zip(*leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)
    # above the largest instantiated head dim the SDPA gate takes the
    # plain path, as the JAX package takes XLA's above 512
    assert tfa.flash_attention_supported((1, 128, 2, 128), (1, 128, 2, 128))
    assert not tfa.flash_attention_supported((1, 128, 2, 160),
                                             (1, 128, 2, 160))
