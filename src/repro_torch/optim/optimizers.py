"""Optax-style optimizers over lists of tensors (port of
``repro/optim/optimizers.py``).

An optimizer is a pair ``(init_fn, update_fn)``:

* ``init_fn(params) -> state``;
* ``update_fn(grads, state, params, step) -> (updates, new_state)``, with
  ``step`` 0-based (the schedule sees ``step + 1``).

``params``, ``grads`` and ``updates`` are sequences of tensors in one
order (``list(model.parameters())``); a state holds one float32 tensor
per parameter. The arithmetic is the JAX package's, in float32; the
schedule's value and the bias corrections stay 0-d CPU tensors, which
PyTorch passes to a device kernel as scalars (no copy, no sync).
:func:`apply_updates` adds the updates to the parameters in place.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

__all__ = ["global_norm", "clip_by_global_norm", "AdamState", "adamw",
           "SGDState", "sgd", "apply_updates"]

Tensors = Sequence[torch.Tensor]


def _as_schedule(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def clip_by_global_norm(tensors: Tensors, max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every tensor by min(1, max_norm / max(‖·‖, 1e-12)); returns
    (scaled tensors, the global norm before scaling)."""
    n = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return [t * scale.to(t.dtype) for t in tensors], n


class AdamState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """AdamW with decoupled weight decay, moments in float32: bias
    correction by ``step + 1``, ``eps`` outside the square root, the decay
    added to the update (``repro/optim/optimizers.py:45-86``)."""
    sched = _as_schedule(lr)

    def init_fn(params: Tensors) -> AdamState:
        return AdamState(
            mu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params],
            nu=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params])

    def update_fn(grads: Tensors, state: AdamState, params: Tensors,
                  step: int):
        t = int(step) + 1
        lr_t = sched(t)
        tf = _f32(t)
        b1c = 1.0 - _f32(b1) ** tf
        b2c = 1.0 - _f32(b2) ** tf
        ups, mus, nus = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = g.detach().float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mh = m / b1c
            vh = v / b2c
            u = -lr_t * (mh / (torch.sqrt(vh) + eps)
                                      + weight_decay * p.detach().float())
            ups.append(u.to(p.dtype))
            mus.append(m)
            nus.append(v)
        return ups, AdamState(mu=mus, nu=nus)

    return init_fn, update_fn


class SGDState(NamedTuple):
    mom: List[torch.Tensor]


def sgd(lr=1e-2, momentum: float = 0.9, nesterov: bool = False):
    sched = _as_schedule(lr)

    def init_fn(params: Tensors) -> SGDState:
        return SGDState(mom=[torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in params])

    def update_fn(grads: Tensors, state: SGDState, params: Tensors,
                  step: int):
        lr_t = sched(int(step) + 1)
        ups, moms = [], []
        for g, m in zip(grads, state.mom):
            g32 = g.detach().float()
            m = momentum * m + g32
            d = g32 + momentum * m if nesterov else m
            ups.append((-lr_t * d).to(g.dtype))
            moms.append(m)
        return ups, SGDState(mom=moms)

    return init_fn, update_fn


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``p += u`` for every pair, in place and outside autograd; returns
    ``params``."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))
    return params
