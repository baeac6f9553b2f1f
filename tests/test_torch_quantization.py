"""paddle_tpu_torch's int8 pieces vs paddle_tpu's: the absmax quantizer,
the quantized KV pool helpers, and one attention layer's paged step over
int8 pools (the int8 branch of paged attention alone:
tests/test_torch_paged_attention.py).

The same seeded numpy inputs go through both packages on the CPU.
Quantized payloads and scales are held BIT-IDENTICAL (the port keeps the
JAX package's order of operations). Floating results that come out of
products are held at atol = rtol = 1e-5 (the same f32 arithmetic summed
in another order, see test_torch_paged_attention.py). No JAX model or
serving engine is built here (tests/test_torch_quantized_serving.py holds
the model, its int8 weights and the engine), and nothing changes a
paddle_tpu module
global.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models.gpt import GPTAttention as JGPTAttention
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.parallel import comm_compress as jcc
from paddle_tpu.quantization import kv as jkv
from paddle_tpu_torch.convert import from_jax_state, quantized_kv_from_jax
from paddle_tpu_torch.models.gpt import GPTAttention, GPTConfig, paged_rows
from paddle_tpu_torch.parallel import comm_compress as tcc
from paddle_tpu_torch.quantization import kv as tkv

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _rows_with_edge_cases(dtype, seed=0):
    """[6, 40] values: normal rows, one with inf, one with NaN and -inf,
    an all-zero row, one exact half-step row (ties round to even)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 40)) * 3).astype(np.float32)
    x[1, 3] = np.inf
    x[2, 5], x[2, 7] = np.nan, -np.inf
    x[3] = 0.0
    x[4] = np.arange(40) - 19.5  # absmax 20.5: many exact .5 quotients
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_absmax_bit_identical(dtype, axis, bits):
    x = _rows_with_edge_cases(dtype)
    jq, js = jcc.quant_absmax(jnp.asarray(x), bits=bits, axis=axis)
    tq, ts = tcc.quant_absmax(torch.from_numpy(x), bits=bits, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcc.dequant_absmax(tq, ts).numpy(),
        np.asarray(jcc.dequant_absmax(jq, js)))
    if axis == -1:  # the all-zero row: scale floor, exact zeros
        assert not tq[3].any() and ts[3, 0] == np.float32(1e-30)


def _pool(rng, NB=6, BS=4, H=2, D=8):
    return rng.standard_normal((NB, BS, H, D)).astype(np.float32)


def _jax_pool(pool):
    return jkv.quantize_pool(jnp.asarray(pool))


def _assert_same(tpool, jpool):
    """A port pool (fp or QuantizedKV) bit-equal to a JAX one."""
    if tkv.is_quantized(tpool):
        np.testing.assert_array_equal(tpool.data.numpy(),
                                      np.asarray(jpool.data))
        np.testing.assert_array_equal(tpool.scale.numpy(),
                                      np.asarray(jpool.scale))
    else:
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))


def test_kv_pool_helpers_bit_identical():
    """quantize_pool, write_rows, set_block_rows, gather_blocks,
    copy_block, rows_to_host and the byte counts on an int8 pool (the fp
    pool's: tests/test_torch_gpt.py::test_kv_pool_ops_match_jax)."""
    rng = np.random.default_rng(11)
    pool = _pool(rng)
    j = _jax_pool(pool)
    t = tkv.quantize_pool(torch.from_numpy(pool))
    assert tkv.is_quantized(t) and jkv.is_quantized(j)
    _assert_same(t, j)
    blk = np.array([[1, 3], [5, 2]], np.int32)
    off = np.array([[0, 3], [1, 2]], np.int32)
    vals = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    vals[0, 1, 1] = 0.0  # an all-zero row: scale floor, zero payload
    tkv.write_rows(t, torch.from_numpy(blk), torch.from_numpy(off),
                   torch.from_numpy(vals))
    j = jkv.write_rows(j, jnp.asarray(blk), jnp.asarray(off),
                       jnp.asarray(vals))
    _assert_same(t, j)
    table = np.array([4, 1], np.int32)
    rows = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    tkv.set_block_rows(t, torch.from_numpy(table), torch.from_numpy(rows))
    j = jkv.set_block_rows(j, jnp.asarray(table), jnp.asarray(rows))
    _assert_same(t, j)
    gtab = np.array([[4, 1], [3, 0]], np.int32)
    np.testing.assert_array_equal(
        tkv.gather_blocks(t, torch.from_numpy(gtab)).numpy(),
        np.asarray(jkv.gather_blocks(j, jnp.asarray(gtab))))
    tkv.copy_block(t, 4, 2)
    j = jkv.copy_block(j, 4, 2)
    _assert_same(t, j)
    host_t = tkv.rows_to_host(t, torch.from_numpy(table))
    host_j = jkv.rows_to_host(j, jnp.asarray(table))
    for k in ("data", "scale"):
        np.testing.assert_array_equal(host_t[k], host_j[k])
    assert tkv.pool_bytes(t) == jkv.pool_bytes(j)
    assert tkv.pool_block_bytes(t) == jkv.pool_block_bytes(j)


@pytest.mark.parametrize("pool_kind,payload_kind", [
    ("quantized", "quantized"), ("quantized", "fp"), ("fp", "quantized"),
    ("fp", "fp")])
def test_set_rows_from_host_bit_identical(pool_kind, payload_kind):
    """Handoff adopt across a mixed fleet: verbatim int8 copy, requantize,
    dequantize, plain scatter — each as the JAX package does it."""
    rng = np.random.default_rng(12)
    pool = _pool(rng)
    src = _jax_pool(_pool(rng))
    table = np.array([3, 5], np.int32)
    payload = (jkv.rows_to_host(src, jnp.asarray(table))
               if payload_kind == "quantized"
               else rng.standard_normal((2, 4, 2, 8)).astype(np.float32))
    j = _jax_pool(pool) if pool_kind == "quantized" else jnp.asarray(pool)
    t = (tkv.quantize_pool(torch.from_numpy(pool))
         if pool_kind == "quantized" else torch.from_numpy(pool.copy()))
    j = jkv.set_rows_from_host(j, jnp.asarray(table), payload)
    tkv.set_rows_from_host(t, torch.from_numpy(table), payload)
    _assert_same(t, j)


def test_quantized_kv_carries_from_jax():
    j = _jax_pool(_pool(np.random.default_rng(13)))
    t = quantized_kv_from_jax(np.asarray(j.data), np.asarray(j.scale))
    _assert_same(t, j)
    assert t.data.dtype == torch.int8 and t.scale.shape == (6, 4, 2, 1)


BS = 4


def test_quantized_layer_forward_paged_matches_jax():
    """One attention layer's paged step over int8 pools (hidden 128, 4
    heads): three slots (one with a null table tail) write their new rows
    quantized and attend through the int8 branch — the JAX package's
    Pallas kernel in interpret mode, the port's plain version — with the
    JAX layer's weights carried into the port's."""
    paddle.seed(0)
    cfg = dict(vocab_size=64, hidden_size=128, num_layers=1, num_heads=4)
    jattn = JGPTAttention(JGPTConfig(**cfg))
    tattn = GPTAttention(GPTConfig(**cfg))
    tattn.load_state_dict(from_jax_state(
        {k: v.numpy() for k, v in jattn.state_dict().items()}, tattn))
    rng = np.random.default_rng(21)
    NB, H, D = 12, 4, 32
    kq = _jax_pool(_pool(rng, NB, BS, H, D))
    vq = _jax_pool(_pool(rng, NB, BS, H, D))
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [9, 10, 0, 0]], np.int32)
    positions = np.array([9, 13, 4], np.int32)
    x = rng.standard_normal((3, 1, 128)).astype(np.float32)
    def jax_step(x_, k_, v_):
        with paddle.no_grad():
            out, k_, v_ = jattn.forward_paged(
                Tensor(x_), k_, v_, jnp.asarray(table),
                jnp.asarray(positions), BS)
        return out._value, k_, v_

    jout, jk, jv = jax.jit(jax_step)(x, kq, vq)
    tk = quantized_kv_from_jax(kq.data, kq.scale)
    tv = quantized_kv_from_jax(vq.data, vq.scale)
    rows = paged_rows(torch.from_numpy(table), torch.from_numpy(positions),
                      1, BS)
    with torch.inference_mode():
        tout, _, _ = tattn.forward_paged(
            torch.from_numpy(x), tk, tv, torch.from_numpy(table), rows, BS)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
    for t, j in ((tk, jk), (tv, jv)):
        # the new rows come out of a product summed in another order, and
        # XLA compiles the scale's / 127 as * (1 / 127): a scale may be one
        # ulp apart and a value on a rounding boundary one int8 step
        assert np.abs(t.data.numpy().astype(int)
                      - np.asarray(j.data).astype(int)).max() <= 1
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=RTOL, atol=0)
