"""paddle_tpu_torch flash attention with dropout, sliding window and the
backward, against the JAX package's Pallas kernels.

On CPU tensors the port's wrappers run their plain PyTorch versions; they
are held against the JAX kernels in interpret mode (``_fwd``, ``_bwd``,
``_dropout_keep``) on the same numpy inputs in f32:

- the dropout keep mask is an integer hash, so it must be bit-identical;
- forward out and lse: atol = rtol = 1e-5 (the same f32 softmax in another
  summation order);
- dq, dk, dv: atol = rtol = 2e-5 (three f32 products deep, each in another
  order; the gradients are O(1));
- torch autograd through ``flash_attention`` against ``jax.grad`` of the
  JAX ``flash_attention(interpret=True)``: the same tolerance on the
  gradients, atol 1e-4 on the summed loss.

Also: the plain attention path's dropout (p = 0 parity with JAX and
determinism under a fixed generator) and the SDPA gate that sends a mask
needing a gradient to the plain path.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention import flash_attention_xla
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.framework.random import DropoutRNG
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

FWD_TOL = 1e-5
BWD_TOL = 2e-5
B, H, D = 2, 2, 32


def _mk(seed, S, bias=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    kvb = None
    if bias:  # key padding: batch 0 masks its last 40 keys
        kvb = np.zeros((B, S), np.float32)
        kvb[0, S - 40:] = -1e9
    return q, k, v, do, kvb


def _bhsd(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


def _jax_kernels(q, k, v, do, kvb, causal, p, seed, window, blk=64):
    """JAX `_fwd` and `_bwd` in interpret mode, back in [B, S, H, D]."""
    s = 1.0 / math.sqrt(D)
    sd = jnp.asarray([seed], jnp.int32)
    bias = None if kvb is None else jnp.asarray(kvb)
    args = (_bhsd(q), _bhsd(k), _bhsd(v), bias, sd)
    out, lse = jfa._fwd(*args, causal, s, blk, blk, True, p, window)
    dq, dk, dv = jfa._bwd(*args, out, lse, _bhsd(do), causal, s, blk, blk,
                          True, p, window)
    back = lambda a: np.asarray(jnp.swapaxes(a, 1, 2))  # noqa: E731
    return back(out), np.asarray(lse[..., 0]), back(dq), back(dk), back(dv)


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = [  # causal, dropout_p, window, kv_bias
    (False, 0.0, 0, False),
    (True, 0.0, 0, False),
    (False, 0.0, 0, True),
    (False, 0.1, 0, False),
    (True, 0.1, 0, True),
    (True, 0.0, 48, False),
    (True, 0.1, 100, False),
]


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1234, -1, -2**31, 2**31 - 1])
def test_dropout_keep_bit_identical(seed, p):
    """The hash over every (batch, head, row, col) of a 2 x 3 x 128 x 192
    call, against `_dropout_keep` evaluated block by block."""
    Bn, Hn, Sq, Sk, bq, bk = 2, 3, 128, 192, 64, 64
    want = np.zeros((Bn, Hn, Sq, Sk), bool)
    for b in range(Bn):
        for h in range(Hn):
            for iq in range(Sq // bq):
                for ik in range(Sk // bk):
                    want[b, h, iq * bq:(iq + 1) * bq,
                         ik * bk:(ik + 1) * bk] = np.asarray(
                        jfa._dropout_keep(jnp.int32(seed), jnp.int32(b),
                                          jnp.int32(h), iq, ik, p, bq, bk))
    got = tfa._keep_bhqk(seed, p, Bn, Hn, Sq, Sk, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(1.0 - got.mean() - p) < 0.02  # P(drop) = p


@pytest.mark.parametrize("causal,p,window,bias", CASES)
def test_plain_forward_and_backward_match_jax_kernels(causal, p, window,
                                                      bias):
    q, k, v, do, kvb = _mk(3, 256, bias)
    seed = -12345
    w_out, w_lse, w_dq, w_dk, w_dv = _jax_kernels(q, k, v, do, kvb, causal,
                                                  p, seed, window)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), _t(kvb), causal,
                                       None, p, seed, window)
    np.testing.assert_allclose(out.numpy(), w_out, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), w_lse, atol=FWD_TOL, rtol=FWD_TOL)
    grads = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(kvb), out, lse,
                                    _t(do), causal, None, p, seed, window)
    for got, want in zip(grads, (w_dq, w_dk, w_dv)):
        np.testing.assert_allclose(got.numpy(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)


@pytest.mark.parametrize("causal,p,window,bias", CASES[1::2])
def test_autograd_matches_jax_grad(causal, p, window, bias):
    """loss = sum(out * w) through torch autograd and through jax.grad of
    the JAX public flash_attention (ragged S = 200: JAX pads, the port
    masks in place)."""
    q, k, v, w, kvb = _mk(4, 200, bias)
    seed = 77
    kw = dict(causal=causal, dropout_p=p, dropout_seed=seed,
              window_size=window or None)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, None if kvb is None
                                  else jnp.asarray(kvb), interpret=True, **kw)
        return jnp.sum(out * jnp.asarray(w))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, _t(kvb), **kw)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    # a sum of 25,600 f32 products of O(1) terms, in another order
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-4)
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=BWD_TOL, rtol=BWD_TOL)


def test_autograd_launches_nothing_on_cpu_and_kv_bias_takes_no_grad():
    q, k, v, _, kvb = _mk(5, 128, bias=True)
    before = (tfa.KERNEL.launches, tfa.DKV_KERNEL.launches,
              tfa.DQ_KERNEL.launches)
    tq = torch.from_numpy(q).requires_grad_()
    bias = torch.from_numpy(kvb).requires_grad_()
    tfa.flash_attention(tq, _t(k), _t(v), bias, dropout_p=0.1,
                        dropout_seed=3).sum().backward()
    assert tq.grad is not None and bias.grad is None
    assert before == (tfa.KERNEL.launches, tfa.DKV_KERNEL.launches,
                      tfa.DQ_KERNEL.launches)


def test_public_validation_matches_jax():
    q = torch.zeros(1, 128, 1, 32)
    for kw in (dict(window_size=8), dict(causal=True, window_size=0),
               dict(dropout_p=1.0), dict(dropout_p=-0.1)):
        with pytest.raises(ValueError):
            tfa.flash_attention(q, q, q, **kw)
        with pytest.raises(ValueError):
            jfa.flash_attention(jnp.zeros((1, 128, 1, 32)),
                                jnp.zeros((1, 128, 1, 32)),
                                jnp.zeros((1, 128, 1, 32)), **kw)


def test_plain_attention_dropout_parity_at_zero_and_determinism():
    """Below the 128 gate: p = 0 equals the JAX XLA path; p > 0 repeats
    bit for bit under equal generators and drops about p of the
    probabilities (the kept ones scaled by 1 / (1 - p))."""
    q, k, v, _, _ = _mk(6, 48)
    want = np.asarray(flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=True))
    got = tatt.attention(_t(q), _t(k), _t(v), causal=True, dropout_p=0.0)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    runs = [tatt.attention(_t(q), _t(k), _t(v), causal=True, dropout_p=0.3,
                           generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], got)
    with pytest.raises(ValueError, match="generator"):
        tatt.attention(_t(q), _t(k), _t(v), dropout_p=0.3)


def test_sdpa_sends_a_mask_that_needs_a_gradient_to_the_plain_path(
        monkeypatch):
    """A [B, 1, 1, Sk] float mask with requires_grad takes the plain path
    and gets its gradient (JAX: `mask_t.stop_gradient` gate); the same mask
    without a gradient goes to the flash kernels."""
    q, k, v, w, _ = _mk(7, 160)
    rng = np.random.default_rng(8)
    m = (rng.standard_normal((B, 1, 1, 160)) * 0.5).astype(np.float32)
    calls = []
    real = tF.flash_attention
    monkeypatch.setattr(tF, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tm = torch.from_numpy(m).requires_grad_()
    out = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v), attn_mask=tm)
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == []
    jg = jax.grad(lambda mm: jnp.sum(flash_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mm)
        * jnp.asarray(w)))(jnp.asarray(m))
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jg),
                               atol=BWD_TOL, rtol=BWD_TOL)
    tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                    attn_mask=torch.from_numpy(m))
    assert calls == [1]


def test_sdpa_dropout_needs_an_rng_and_draws_a_seed_per_call(monkeypatch):
    q, k, v, _, _ = _mk(9, 128)
    with pytest.raises(ValueError, match="DropoutRNG"):
        tF.scaled_dot_product_attention(_t(q), _t(k), _t(v), dropout_p=0.1)
    seeds = []
    real = tF.flash_attention
    monkeypatch.setattr(tF, "flash_attention", lambda *a, **kw: seeds.append(
        kw["dropout_seed"]) or real(*a, **kw))
    rng = DropoutRNG(5)
    outs = [tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                            dropout_p=0.1, rng=rng)
            for _ in range(2)]
    assert len(set(seeds)) == 2 and all(-2**31 <= s < 2**31 for s in seeds)
    assert not torch.equal(outs[0], outs[1])  # a new mask per call
    again = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                            dropout_p=0.1, rng=DropoutRNG(5))
    assert torch.equal(again, outs[0])
    # eval mode: no dropout, no seed drawn
    tF.scaled_dot_product_attention(_t(q), _t(k), _t(v), dropout_p=0.1,
                                    training=False)
    assert seeds[-1] is None


def test_mask_probe_reads_back_the_plain_versions_masks():
    """probe_dropout_masks (what chip_smoke.py holds the kernels to) reads
    the plain forward's and backward's masks back as dropout_keep draws
    them, ragged S included."""
    masks = tfa.probe_dropout_masks(2, 2, 130, 0.3, -7, "cpu")
    want = tfa._keep_bhqk(-7, 0.3, 2, 2, 130, 130, "cpu")
    for name, got in masks.items():
        assert torch.equal(got, want), name
