"""paddle_tpu_torch paged attention vs the JAX package's.

The port's wrapper on CPU tensors runs its plain PyTorch version; it is
held against the JAX Pallas kernel in interpret mode (as
tests/test_paged_attention.py runs it) and against the kernel's pure-JAX
reference, on the same numpy inputs in f32. Tolerance atol = rtol = 1e-5:
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
from paddle_tpu_torch.ops import paged_attention as tpa

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
