"""paddle_tpu_torch paged attention vs the JAX package's.

The port's wrapper on CPU tensors runs its plain PyTorch version; it is
held against the JAX Pallas kernel in interpret mode (as
tests/test_paged_attention.py runs it) and against the kernel's pure-JAX
reference, on the same numpy inputs in f32 — over fp pools, and over int8
pools with f32 scales (the int8 branch, ``k_scale``/``v_scale``) quantized
by the JAX package. Tolerance atol = rtol = 1e-5:
both sides compute an f32 softmax over the same scores, in another
summation order (the kernel walks page tiles with an online softmax, the
plain version does one softmax over the gathered cache), which moves the
last few bits of f32 only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quantization import kv as jkv
from paddle_tpu_torch.convert import quantized_kv_from_jax
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.quantization import kv as tkv

torch.set_num_threads(1)

BS = 4
ATOL = RTOL = 1e-5


def _mk(seed, scenario, s, B=3, H=2, D=32, NB=12, M=5):
    """Seeded numpy inputs. scenarios: positions mid-table; a row that
    overruns the table (columns past M * BS); a table whose tail points at
    the null block 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    table = rng.integers(1, NB, (B, M)).astype(np.int32)
    start = rng.integers(BS, (M - 1) * BS - s, (B,))
    if scenario == "overrun":
        start[0] = M * BS - 2  # rows past the last page of the table
    if scenario == "null_tail":
        table[:, 3:] = 0       # unused tail -> null block, masked by pos
        start[:] = rng.integers(0, 3 * BS - s, (B,))
    pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    return q, kp, vp, table, pos


def _port(q, kp, vp, table, pos):
    return tpa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(pos),
        block_size=BS).numpy()


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("scenario", ["mid", "overrun", "null_tail"])
def test_plain_matches_jax_kernel_and_reference(s, scenario):
    q, kp, vp, table, pos = _mk(3, scenario, s)
    got = _port(q, kp, vp, table, pos)
    kern = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), block_size=BS, interpret=True))
    ref = np.asarray(jax.jit(lambda q_, k_, v_, p_: jpa.paged_attention_reference(
        q_, k_, v_, table, p_, block_size=BS))(q, kp, vp, pos))
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_pos_minus_one_rows_are_zero():
    """A row at pos = -1 sees no column and gives zeros. (The JAX kernel's
    finite -1e30 sentinel turns such a row into a uniform average over the
    pages it visited instead — a value its callers slice off or ignore —
    so the port's rows are held to zeros and every other row to JAX.)"""
    q, kp, vp, table, pos = _mk(5, "mid", 4)
    pos[1, 2:] = -1
    got = _port(q, kp, vp, table, pos)
    assert np.all(got[1, 2:] == 0.0)
    kern = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), block_size=BS, interpret=True))
    live = pos >= 0
    np.testing.assert_allclose(got[live], kern[live], atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    q, kp, vp, table, pos = _mk(7, "mid", 1)
    before = tpa.KERNEL.launches
    got = _port(q, kp, vp, table, pos)
    want = tpa.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(pos), block_size=BS)
    np.testing.assert_array_equal(got, want.numpy())
    assert tpa.KERNEL.launches == before


@pytest.mark.parametrize("quantized", [False, True])
def test_pools_at_a_padded_head_dim_give_the_unpadded_result(quantized):
    """Pools allocated at the next head dim the kernel is built for (here
    24 -> 32, extra columns zero) with q at 24: the wrapper pads q, keeps
    the scale 1 / sqrt(24) and slices the output back, equal to the
    unpadded call. Zero columns leave each row's absmax, so an int8
    pool's payload and scales, unchanged."""
    q, kp, vp, table, pos = _mk(9, "mid", 2, D=24)
    pad = ((0, 0),) * 3 + ((0, 8),)
    args = [torch.from_numpy(table), torch.from_numpy(pos)]
    pools = [torch.from_numpy(kp), torch.from_numpy(vp)]
    wide = [torch.from_numpy(np.pad(a, pad)) for a in (kp, vp)]
    kw = {}
    if quantized:
        pools = [tkv.quantize_pool(p) for p in pools]
        wide = [tkv.quantize_pool(p) for p in wide]
        for p, w in zip(pools, wide):
            assert torch.equal(w.data[..., :24], p.data)
            assert torch.equal(w.scale, p.scale)
        kw = lambda ps: dict(k_scale=ps[0].scale, v_scale=ps[1].scale)  # noqa: E731
        data = lambda ps: [p.data for p in ps]  # noqa: E731
    else:
        kw = lambda ps: {}  # noqa: E731
        data = lambda ps: ps  # noqa: E731
    qt = torch.from_numpy(q)
    got = tpa.paged_attention(qt, *data(wide), *args, block_size=BS,
                              **kw(wide))
    want = tpa.paged_attention(qt, *data(pools), *args, block_size=BS,
                               **kw(pools))
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def _int8_pool(rng, NB, H, D):
    """An int8 pool quantized from normal rows by the JAX package."""
    return jkv.quantize_pool(jnp.asarray(
        rng.standard_normal((NB, BS, H, D)).astype(np.float32)))


def _paged_inputs(seed, s, B=3, H=2, D=32, NB=12, M=5):
    """Seeded q and int8 pools (quantized from normal rows by the JAX
    package); row 0 overruns the table, slot 2's last row sits at -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kq = _int8_pool(rng, NB, H, D)
    vq = _int8_pool(rng, NB, H, D)
    table = rng.integers(1, NB, (B, M)).astype(np.int32)
    table[1, 3:] = 0  # null tail
    start = np.array([M * BS - 2, rng.integers(0, 3 * BS - s), 6])
    pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    pos[2, -1] = -1
    return q, kq, vq, table, pos


@pytest.mark.parametrize("s", [1, 3])
def test_int8_paged_plain_matches_jax_reference(s):
    """The int8 branch: the plain version over int8 pools with scales
    against ``paged_attention_reference(..., k_scale, v_scale)`` under
    jax.jit with a host table; both dequantize the same payloads."""
    q, kq, vq, table, pos = _paged_inputs(s, s)
    want = np.asarray(jax.jit(
        lambda q_, kd, ks, vd, vs, p_: jpa.paged_attention_reference(
            q_, kd, vd, table, p_, block_size=BS, k_scale=ks, v_scale=vs))(
        q, kq.data, kq.scale, vq.data, vq.scale, pos))
    tk = quantized_kv_from_jax(kq.data, kq.scale)
    tv = quantized_kv_from_jax(vq.data, vq.scale)
    before = tpa.INT8_KERNEL.launches
    got = tpa.paged_attention(
        torch.from_numpy(q), tk.data, tv.data, torch.from_numpy(table),
        torch.from_numpy(pos), block_size=BS, k_scale=tk.scale,
        v_scale=tv.scale).numpy()
    assert tpa.INT8_KERNEL.launches == before  # CPU: the plain version
    live = pos >= 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)
    # pos = -1 sees nothing: zeros (the JAX sentinel gives an average)
    assert np.all(got[~live] == 0.0)


def test_paged_attention_rejects_mismatched_scales():
    q = torch.zeros(1, 1, 2, 32)
    pool = torch.zeros(3, BS, 2, 32)
    qpool = tkv.quantize_pool(pool)
    table = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    kw = dict(block_size=BS)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention(q, qpool.data, qpool.data, table, pos, **kw)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_attention(q, pool, pool, table, pos, k_scale=qpool.scale,
                            v_scale=qpool.scale, **kw)
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(q, qpool.data, qpool.data, table, pos,
                            k_scale=qpool.scale, **kw)
