"""AdamW with the JAX package's arithmetic.

Port of ``paddle_tpu/optimizer/optimizer.py`` ``Adam`` / ``AdamW``
(``_functional_update``), not ``torch.optim.AdamW``: the beta powers are
f32 scalars advanced once per step, and each parameter p with gradient g
takes

    m1 = b1 m1 + (1 - b1) g;   m2 = b2 m2 + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
    upd = cast_p(lr_t m1 / (sqrt(m2) + eps sqrt(1 - b2^t)))
    upd = upd + lr coeff p                  (decoupled decay, when it applies)
    p = p - upd

with the moments in the parameter's dtype (bf16 moments for a bf16 model)
unless ``multi_precision``, which keeps f32 moments and an f32 master copy
of every low-precision parameter. The scalars (lr_t, eps sqrt(1 - b2^t),
lr coeff) are computed on the host in float32, as the reference computes
them in its jitted f32 step, so a step needs no device sync. Products of
an f32 scalar with a bf16 tensor are taken in f32, as JAX promotes them.
Parameters whose grad is None are skipped. Constant learning rate only.

A step works on flat buffers: the parameters that take it are bucketed by
dtype and decay, and each bucket's grads, parameters and moments are
concatenated, updated by one elementwise op after another (the same ops,
in the same order, as per parameter: the same bits) and copied back. That
is ~30 launches per bucket where a loop over parameters takes ~12 per
parameter (~2,400 for ERNIE-base, which made the step host-bound).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..framework.device import resolve_device

__all__ = ["AdamW"]

f32 = np.float32


def _as(t: torch.Tensor, x: float) -> float:
    """The Python scalar x rounded to t's dtype, as JAX rounds a weakly
    typed scalar before it meets a tensor (0.999 is 1.0 in bf16, so bf16
    second moments do not decay: the reference's arithmetic, kept)."""
    return float(torch.tensor(x, dtype=t.dtype))


class AdamW(torch.optim.Optimizer):
    """``parameters``: tensors, or (name, tensor) pairs such as
    ``model.named_parameters()`` — names are what ``apply_decay_param_fun``
    is asked about (True = decay). Every parameter must live on ``device``
    (the CUDA card unless the caller names another)."""

    def __init__(self, parameters, learning_rate: float = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-08, weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 multi_precision: bool = False, device=None):
        dev = resolve_device(device)
        params, self._names = [], {}
        for item in parameters:
            if isinstance(item, tuple):
                name, p = item
                self._names[id(p)] = name
            else:
                p = item
            if p.device != dev:
                raise ValueError(f"AdamW: a parameter lives on {p.device}, "
                                 f"not {dev}")
            params.append(p)
        if apply_decay_param_fun is not None and len(self._names) != len(params):
            raise ValueError("apply_decay_param_fun needs named parameters "
                             "(pass model.named_parameters())")
        defaults = dict(lr=float(learning_rate), beta1=float(beta1),
                        beta2=float(beta2), epsilon=float(epsilon),
                        weight_decay=float(weight_decay),
                        beta1_pow=1.0, beta2_pow=1.0)
        super().__init__(params, defaults)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._multi_precision = bool(multi_precision)

    def _decays(self, p) -> bool:
        fn = self._apply_decay_param_fun
        return True if fn is None else bool(fn(self._names[id(p)]))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            if not live:
                continue
            b1, b2 = group["beta1"], group["beta2"]
            b1p = f32(group["beta1_pow"]) * f32(b1)
            b2p = f32(group["beta2_pow"]) * f32(b2)
            group["beta1_pow"], group["beta2_pow"] = float(b1p), float(b2p)
            lr = f32(group["lr"])
            scalars = dict(
                b1=b1, b2=b2,
                lr_t=float(lr * np.sqrt(f32(1) - b2p) / (f32(1) - b1p)),
                eps_t=float(f32(group["epsilon"]) * np.sqrt(f32(1) - b2p)))
            lr_coeff = float(lr * f32(group["weight_decay"]))
            buckets = {}
            for p in live:
                self._init_state(p)
                decay = self._decays(p)
                buckets.setdefault((p.dtype, decay), []).append(p)
            for (_, decay), params in buckets.items():
                self._update(params, lr_coeff if decay else None, **scalars)
        return loss

    def _init_state(self, p) -> None:
        state = self.state[p]
        if not state:
            wide = self._multi_precision and p.dtype != torch.float32
            mdt = torch.float32 if self._multi_precision else p.dtype
            state["moment1"] = torch.zeros_like(p, dtype=mdt)
            state["moment2"] = torch.zeros_like(p, dtype=mdt)
            state["master"] = p.detach().float() if wide else None

    def _update(self, params, lr_coeff, b1, b2, lr_t, eps_t) -> None:
        """One bucket (one dtype, one decay flag). The working copy pw is
        the f32 master where there is one, else the parameter; moments
        share its dtype."""
        states = [self.state[p] for p in params]
        masters = [st["master"] for st in states]
        works = [p if m is None else m for p, m in zip(params, masters)]
        m1s = [st["moment1"] for st in states]
        m2s = [st["moment2"] for st in states]
        pw = _flat(works)
        g = _flat([p.grad for p in params]).to(pw.dtype)
        m1 = _as(pw, b1) * _flat(m1s) + _as(pw, 1 - b1) * g
        m2 = _as(pw, b2) * _flat(m2s) + _as(pw, 1 - b2) * (g * g)
        upd = (lr_t * m1.float() / (m2.sqrt().float() + eps_t)).to(pw.dtype)
        if lr_coeff is None:
            new = pw - upd
        else:  # f32, as JAX promotes bf16 + f32 scalar * bf16
            new = pw.float() - (upd.float() + lr_coeff * pw.float())
        _unflat(m1s, m1)
        _unflat(m2s, m2)
        if masters[0] is not None:
            _unflat(masters, new.float())
        _unflat(params, new.to(params[0].dtype))


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(tensors, flat) -> None:
    """Copy the flat buffer back into the tensors, in one foreach copy."""
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [x.view_as(t) for x, t in zip(parts, tensors)])
