"""paddle_tpu_torch ERNIE pretraining vs paddle_tpu's, with weights carried
by convert.py.

``ErnieConfig.tiny()`` (2 layers, hidden 128, 2 heads of 64, vocab 1024)
with hidden and attention dropout 0 is built in the JAX package, its
parameters are carried into the port, and the same seeded numpy ids and
labels go through both in f32:

- MLM and NSP logits of ``forward``, and ``pretraining_loss``: atol = rtol
  = 1e-4 on logits (two layers of f32 products, norms and softmax in
  another order), rtol 1e-5 on the loss;
- the gradients of ``pretraining_loss`` for every parameter the loss
  reaches (the pooler and NSP get none in the port and zeros in JAX):
  rtol 1e-4, atol 1e-6 (the loss's gradients are ~1e-3..1e-1, and the
  logits' softmax is recomputed in backward in another order);
- the fused head ``linear_cross_entropy`` alone, whole and in row
  chunks: the same tolerances as the loss and its gradients;
- the ``ernie_tiny`` loss trajectory of BASELINE_curves.json (batch 4, seq
  64, lr 1e-4, seed 1234, AdamW) for 10 steps, and a seq-128 variant whose
  attention goes through the flash path (the Pallas kernels in interpret
  mode on the JAX side), step by step: rtol 1e-5.

Seq 64 takes the plain attention path on both sides, seq 128 the flash
path (a 2-D padding mask lowers to the kernels' kv_bias row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor, no_grad
from paddle_tpu.nn import functional as jF
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu.models.ernie import \
    ErniePretrainingCriterion as JCriterion
from paddle_tpu_torch import AdamW, ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.convert import from_jax_state, to_jax_layout
from paddle_tpu_torch.models.ernie import ErniePretrainingCriterion
from paddle_tpu_torch.nn import functional as tF

torch.set_num_threads(1)

ATOL = RTOL = 1e-4


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def port_of(jm):
    """A port model (dropout 0) holding the JAX model's weights."""
    tm = ErnieForPretraining(_no_dropout(ErnieConfig.tiny()), device="cpu")
    tm.load_state_dict(from_jax_state(
        {k: v.numpy() for k, v in jm.state_dict().items()}, tm))
    return tm


def make_pair(seed=0):
    """(JAX model, port model with the JAX model's weights), dropout 0."""
    paddle.seed(seed)
    jm = JErnie(_no_dropout(JErnieConfig.tiny()))
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=1234)  # the ernie_tiny oracle's seed


def _batch(seed, B, S, vocab=1024):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return ids, labels


def test_state_dict_names_and_shapes_agree(pair):
    jm, tm = pair
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert set(jsd) == set(tsd)
    back = to_jax_layout(tsd, tm)
    for name, w in jsd.items():
        np.testing.assert_array_equal(back[name], w.numpy(), err_msg=name)


def _jax_forward(jm, ids, labels, am):
    """JAX forward logits, pretraining_loss and the criterion's loss, in
    one jitted call (eval mode)."""
    params, buffers = jm.functional_state()

    def f(p, i, l, m):
        def fwd(i_, l_, *m_):
            mask = m_[0] if m_ else None
            mlm, nsp = jm(i_, attention_mask=mask)
            loss = jm.pretraining_loss(i_, l_, attention_mask=mask)
            return mlm, nsp, loss, JCriterion(1024)(mlm, nsp, l_)

        ins = (i, l) if m is None else (i, l, m)
        with no_grad():
            outs, _ = jm.functional_call(p, buffers, *ins, training=False,
                                         forward_fn=fwd)
        return [o._value for o in outs]

    am = None if am is None else jnp.asarray(am)
    return [np.asarray(o) for o in jax.jit(f)(
        params, jnp.asarray(ids), jnp.asarray(labels), am)]


@pytest.mark.parametrize("S,masked", [(64, False), (128, True)])
def test_forward_and_pretraining_loss_match(pair, S, masked):
    """Seq 64 takes the plain attention path, seq 128 the flash path with
    batch 1's last 30 tokens padded by the 2-D mask (its kv_bias row)."""
    jm, tm = pair
    ids, labels = _batch(S, 2, S)
    labels[0, :5] = -100  # ignored rows
    am = None
    if masked:
        am = np.ones((2, S), np.float32)
        am[1, S - 30:] = 0.0
    jmlm, jnsp, jloss, jcrit = _jax_forward(jm, ids, labels, am)
    tam = None if am is None else torch.from_numpy(am)
    tids, tlab = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    tm.eval()
    with torch.no_grad():
        tmlm, tnsp = tm(tids, attention_mask=tam)
        tloss = tm.pretraining_loss(tids, tlab, attention_mask=tam)
        tcrit = ErniePretrainingCriterion(1024)(tmlm, tnsp, tlab)
    np.testing.assert_allclose(tmlm.numpy(), jmlm, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tnsp.numpy(), jnsp, atol=ATOL, rtol=RTOL)
    for got, want in ((tloss, jloss), (tcrit, jcrit), (tloss, jcrit)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def _jax_loss_and_grads(jm, ids, labels):
    params, buffers = jm.functional_state()

    def loss_fn(p):
        with no_grad():
            loss, _ = jm.functional_call(
                p, buffers, Tensor(jnp.asarray(ids)),
                Tensor(jnp.asarray(labels)), training=True,
                forward_fn=lambda i, l: jm.pretraining_loss(i, l))
        return loss._value.astype(jnp.float32)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("S", [64, 128])
def test_pretraining_loss_gradients_match(pair, S):
    jm, tm = pair
    ids, labels = _batch(S + 1, 2, S)
    jloss, jgrads = _jax_loss_and_grads(jm, ids, labels)
    tm.train()
    tm.zero_grad(set_to_none=True)
    tloss = tm.pretraining_loss(torch.from_numpy(ids).long(),
                                torch.from_numpy(labels).long())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    named = dict(tm.named_parameters())
    unused = {n for n, p in named.items() if p.grad is None}
    assert unused == {"ernie.pooler.weight", "ernie.pooler.bias",
                      "nsp.weight", "nsp.bias"}
    tgrads = to_jax_layout({n: p.grad for n, p in named.items()
                            if p.grad is not None}, tm)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for name in unused:
        assert not np.any(jgrads[name]), name


def _jax_trajectory(jm, batches, lr):
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=jm.parameters())
    params, buffers = jm.functional_state()
    keys = sorted(params)
    state = opt._functional_init([params[k] for k in keys])

    def step(params, state, ids, labels):
        def loss_fn(p):
            with no_grad():
                loss, _ = jm.functional_call(
                    p, buffers, Tensor(ids), Tensor(labels), training=True,
                    forward_fn=lambda i, l: jm.pretraining_loss(i, l))
            return loss._value.astype(jnp.float32)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new, st = opt._functional_update([params[k] for k in keys],
                                         [grads[k] for k in keys], state,
                                         jnp.float32(lr))
        return loss, dict(zip(keys, new)), st

    jstep = jax.jit(step)
    losses = []
    for ids, labels in batches:
        loss, params, state = jstep(params, state, jnp.asarray(ids),
                                    jnp.asarray(labels))
        losses.append(float(loss))
    return losses


def _port_trajectory(tm, batches, lr):
    opt = AdamW(tm.named_parameters(), learning_rate=lr, device="cpu")
    tm.train()
    losses = []
    for ids, labels in batches:
        opt.zero_grad(set_to_none=True)
        loss = tm.pretraining_loss(torch.from_numpy(ids).long(),
                                   torch.from_numpy(labels).long())
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("steps,B,S", [(10, 4, 64), (3, 2, 128)])
def test_ernie_tiny_trajectory_matches_jax(pair, steps, B, S):
    """The ernie_tiny oracle's settings (BASELINE_curves.json: seed 1234,
    lr 1e-4, ids and labels drawn per step from RandomState(1234)), with
    dropout 0 on both sides, through pretraining_loss and AdamW."""
    jm, _ = pair
    tm = port_of(jm)
    rng = np.random.RandomState(1234)
    batches = [(rng.randint(0, 1024, (B, S)).astype(np.int32),
                rng.randint(0, 1024, (B, S)).astype(np.int32))
               for _ in range(steps)]
    want = _jax_trajectory(jm, batches, 1e-4)
    got = _port_trajectory(tm, batches, 1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]  # it learns


@pytest.mark.parametrize("chunk", [None, 48])
def test_linear_cross_entropy_matches_jax(chunk):
    """The fused head alone: value and gradients of x, W and b against the
    JAX F.linear_cross_entropy (its chunked scan for chunk=48: 130 rows in
    three blocks, the last ragged), with ignored rows."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((130, 32)).astype(np.float32)
    w = (rng.standard_normal((200, 32)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(200) * 0.1).astype(np.float32)
    lab = rng.integers(0, 200, 130).astype(np.int32)
    lab[::7] = -100

    def jloss(x_, w_, b_):
        return jF.linear_cross_entropy(Tensor(x_), Tensor(w_), Tensor(b_),
                                       Tensor(jnp.asarray(lab)),
                                       chunk=chunk)._value

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    loss = tF.linear_cross_entropy(tx, tw, tb, torch.from_numpy(lab).long(),
                                   chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for t, g in zip((tx, tw, tb), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-7)
