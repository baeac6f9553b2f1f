"""paddle_tpu_torch GPT vs paddle_tpu's, with weights carried by convert.py.

A tiny GPT (2 layers, hidden 128, 4 heads) is built in the JAX package, its
parameters are carried into the port, and the same seeded numpy inputs go
through both in f32: forward logits, the paged decode step (outputs and
the pools it writes), and greedy generate tokens, for learned and rotary
positions. Tolerance atol = rtol = 1e-4 on logits: the same f32 arithmetic
in another order through two layers (matmuls, layer norms, softmax); the
observed gap is ~1e-6. Greedy tokens must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.quantization import kv as jkv
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.quantization import kv as kv_pool

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
TINY = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            max_position_embeddings=256)


def make_pair(position_embedding="learned", seed=0):
    """(JAX model, port model with the JAX model's weights), both eval."""
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(position_embedding=position_embedding,
                                    **TINY))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(position_embedding=position_embedding,
                                  **TINY), device="cpu")
    tm.load_state_dict(from_jax_state(
        {k: v.numpy() for k, v in jm.state_dict().items()}, tm))
    return jm, tm


@pytest.fixture(scope="module", params=["learned", "rope"])
def pair(request):
    return make_pair(request.param)


def test_state_dict_names_and_shapes_agree(pair):
    jm, tm = pair
    jsd = jm.state_dict()
    tsd = tm.state_dict()
    assert set(jsd) == set(tsd)
    for name, w in jsd.items():
        shape = tuple(w.shape)
        if name.endswith(("qkv.weight", "proj.weight", "fc1.weight",
                          "fc2.weight")):
            shape = shape[::-1]
        assert tuple(tsd[name].shape) == shape, name
    # functional_state()'s raw jax arrays carry over the same way
    params, _ = jm.functional_state()
    for name, w in from_jax_state(params, tm).items():
        assert torch.equal(w, tsd[name]), name


@pytest.mark.parametrize("S", [37, 160])
def test_forward_logits_match(pair, S):
    """37 tokens take the plain attention path, 160 the flash path."""
    jm, tm = pair
    ids = np.random.default_rng(S).integers(0, 1024, (2, S)).astype(np.int32)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s,num_valid", [(1, None), (3, [3, 1, 2])])
def test_forward_paged_outputs_and_pools_match(pair, s, num_valid):
    """A slot-batched step over random pools: three slots at different
    positions (one a padded window), block tables with null tails."""
    jm, tm = pair
    rng = np.random.default_rng(s)
    NB, BS, M = 16, 4, 6
    H, D = 4, 32
    kpools = [rng.standard_normal((NB, BS, H, D)).astype(np.float32)
              for _ in range(2)]
    vpools = [rng.standard_normal((NB, BS, H, D)).astype(np.float32)
              for _ in range(2)]
    table = np.array([[1, 2, 3, 0, 0, 0], [4, 5, 6, 7, 8, 0],
                      [9, 10, 0, 0, 0, 0]], np.int32)
    positions = np.array([9, 17, 4], np.int32)
    ids = rng.integers(0, 1024, (3, s)).astype(np.int32)
    nv = None if num_valid is None else np.asarray(num_valid, np.int32)
    with paddle.no_grad():
        h, jk, jv = jm.gpt.forward_paged(
            Tensor(jnp.asarray(ids)), [jnp.asarray(p) for p in kpools],
            [jnp.asarray(p) for p in vpools], jnp.asarray(table),
            jnp.asarray(positions), BS,
            num_valid=None if nv is None else jnp.asarray(nv))
        want = jm.forward_head(h).numpy()
    tk = [torch.from_numpy(p.copy()) for p in kpools]
    tv = [torch.from_numpy(p.copy()) for p in vpools]
    with torch.inference_mode():
        th, tk, tv = tm.gpt.forward_paged(
            torch.from_numpy(ids), tk, tv, torch.from_numpy(table),
            torch.from_numpy(positions), BS,
            num_valid=None if nv is None else torch.from_numpy(nv))
        got = tm.forward_head(th).numpy()
    rows = (np.ones((3, s), bool) if nv is None
            else np.arange(s)[None, :] < nv[:, None])
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=RTOL)
    for i in range(2):
        # block 0 takes the padding rows' writes in no fixed order
        np.testing.assert_allclose(tk[i][1:].numpy(), np.asarray(jk[i])[1:],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv[i][1:].numpy(), np.asarray(jv[i])[1:],
                                   atol=ATOL, rtol=RTOL)


def test_generate_greedy_tokens_identical(pair):
    jm, tm = pair
    ids = np.random.default_rng(5).integers(0, 1024, (2, 11)).astype(np.int32)
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=8).numpy()
    got = tm.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_eos_stops_like_jax(pair):
    jm, tm = pair
    ids = np.random.default_rng(6).integers(0, 1024, (1, 9)).astype(np.int32)
    free = tm.generate(ids, max_new_tokens=6).numpy()
    eos = int(free[0, 9 + 2])  # the third greedy token
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=6,
                       eos_token_id=eos).numpy()
    got = tm.generate(ids, max_new_tokens=6, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 9 + 3


def test_kv_pool_ops_match_jax():
    rng = np.random.default_rng(9)
    pool = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    blk = np.array([[1, 3], [5, 2]], np.int32)
    off = np.array([[0, 3], [1, 2]], np.int32)
    vals = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    table = np.array([4, 1], np.int32)
    rows = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    t = torch.from_numpy(pool.copy())
    kv_pool.write_rows(t, torch.from_numpy(blk), torch.from_numpy(off),
                       torch.from_numpy(vals))
    j = jkv.write_rows(jnp.asarray(pool), jnp.asarray(blk), jnp.asarray(off),
                       jnp.asarray(vals))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    kv_pool.set_block_rows(t, torch.from_numpy(table), torch.from_numpy(rows))
    j = jkv.set_block_rows(j, jnp.asarray(table), jnp.asarray(rows))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        kv_pool.gather_blocks(t, torch.from_numpy(table)).numpy(),
        np.asarray(jkv.gather_blocks(j, jnp.asarray(table))))
    kv_pool.copy_block(t, 4, 2)
    j = jkv.copy_block(j, 4, 2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        kv_pool.rows_to_host(t, torch.from_numpy(table)),
        jkv.rows_to_host(j, jnp.asarray(table)))
    assert kv_pool.pool_bytes(t) == jkv.pool_bytes(j)
    assert kv_pool.pool_block_bytes(t) == jkv.pool_block_bytes(j)
