"""paddle_tpu_torch AdamW against the JAX package's ``_functional_update``.

Both take the same parameters and the same fixed gradients (numpy, from a
seed) for six steps; the parameters (and, with multi_precision, the f32
masters) are compared after every step. Tolerances:

- f32: rtol 1e-6, atol 1e-7 — the same f32 formula in the same order;
  an update of size ~lr = 1e-2 comes out of XLA's CPU division and sqrt
  a few f32 steps (observed <= 3e-6 relative) from PyTorch's, so 1e-5
  of lr absolute;
- bf16 parameters with bf16 moments: 2^-7 relative (one bf16 step) plus
  1e-6 absolute — XLA may keep f32 between the fused elementwise ops of
  the moment update where PyTorch rounds each to bf16, so a moment can
  differ by one bf16 step;
- bf16 parameters with multi_precision: f32 masters as f32 parameters,
  the bf16 parameters (their rounding) to one bf16 step.

Cases: with and without ``apply_decay_param_fun`` (biases excluded), and a
parameter whose gradient is None, which both sides leave untouched.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

SHAPES = {"fc.weight": (7, 5), "fc.bias": (5,), "emb.weight": (3, 4, 2),
          "unused.weight": (2, 2)}
STEPS = 6
LR = 1e-2


def _decay(name):
    return not name.endswith("bias")


def _data():
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (None if n.startswith("unused") else
                  rng.standard_normal(s).astype(np.float32))
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("decay_fun", [None, _decay])
@pytest.mark.parametrize("dtype,mp", [("float32", False), ("bfloat16", False),
                                      ("bfloat16", True)])
def test_adamw_trajectory_matches_functional_update(dtype, mp, decay_fun):
    params, grads = _data()
    names = list(SHAPES)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                  apply_decay_param_fun=decay_fun,
                                  multi_precision=mp)
    # the JAX AdamW drops multi_precision on its way to Adam.__init__; set
    # it as Adam would, to hold the port to the reference's f32-master
    # arithmetic
    jopt._multi_precision = mp
    jvals = [jnp.asarray(params[n]).astype(jdt) for n in names]
    jstate = jopt._functional_init(
        jvals, params=[SimpleNamespace(name=n) for n in names])
    jstep = jax.jit(jopt._functional_update)

    tparams = {n: torch.nn.Parameter(torch.from_numpy(params[n]).to(tdt))
               for n in names}
    topt = AdamW(list(tparams.items()), learning_rate=LR, weight_decay=0.01,
                 apply_decay_param_fun=decay_fun, multi_precision=mp,
                 device="cpu")
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    atol = 1e-7 if dtype == "float32" else 1e-6

    for g in grads:
        jg = [None if g[n] is None else jnp.asarray(g[n]).astype(jdt)
              for n in names]
        jvals, jstate = jstep(jvals, jg, jstate, jnp.float32(LR))
        for n in names:
            tparams[n].grad = (None if g[n] is None
                               else torch.from_numpy(g[n]).to(tdt))
        topt.step()
        for i, n in enumerate(names):
            got = tparams[n].detach().float().numpy()
            want = np.asarray(jvals[i].astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=n)
            if mp and g[n] is not None:
                np.testing.assert_allclose(
                    topt.state[tparams[n]]["master"].numpy(),
                    np.asarray(jstate["master"][i]), rtol=1e-6, atol=1e-7,
                    err_msg=n)
    np.testing.assert_array_equal(tparams["unused.weight"].detach().float()
                                  .numpy(),
                                  torch.from_numpy(params["unused.weight"])
                                  .to(tdt).float().numpy())
    assert tparams["unused.weight"] not in topt.state
    b1p, b2p = topt.param_groups[0]["beta1_pow"], topt.param_groups[0][
        "beta2_pow"]
    assert b1p == float(jstate["beta1_pow"]) and b2p == float(
        jstate["beta2_pow"])


def test_moments_follow_the_parameter_dtype_unless_multi_precision():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    for mp, want in ((False, torch.bfloat16), (True, torch.float32)):
        opt = AdamW([p], multi_precision=mp, device="cpu")
        p.grad = torch.ones_like(p)
        opt.step()
        assert opt.state[p]["moment1"].dtype == want
        assert (opt.state[p]["master"] is not None) == mp


def test_adamw_refuses_parameters_off_its_device_and_unnamed_decay_fun(
        monkeypatch):
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(ValueError, match="named parameters"):
        AdamW([p], apply_decay_param_fun=_decay, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        AdamW([p], device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdamW([p])
