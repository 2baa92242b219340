"""Train / prefill / decode step builders for the LM stack (port of
``repro/launch/steps.py``, one card: no shardings).

``TrainState(params, mu, nu, step)``: ``params`` is the model (an
:class:`~repro_torch.models.lm.model.LM`), ``mu`` / ``nu`` its float32
AdamW moments, one per parameter in ``model.parameters()`` order, and
``step`` an int. A train step DONATES its input state, as JAX's jitted
step does (``donate_argnums``): the parameters are updated in place and
each moment is replaced in the state's lists as soon as its parameter is
done, so at most one parameter's temporaries exist beside the state.
:func:`state_tree` / :func:`load_state_tree` give the state JAX's
checkpoint layout (``params`` / ``mu`` / ``nu`` as JAX's stacked trees).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..device import DeviceLike
from ..models.lm import model as lm
from ..models.lm.config import ModelConfig
from ..optim import AdamState, adamw, apply_updates, global_norm

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "state_tree",
           "load_state_tree"]


class TrainState(NamedTuple):
    params: lm.LM
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int


def init_state(cfg: ModelConfig, *, seed: int = 0, max_seq: int = 0,
               device: DeviceLike = "cuda") -> TrainState:
    """A new model (``lm.init_params``) with zero float32 moments."""
    model = lm.init_params(cfg, seed=seed, max_seq=max_seq, device=device)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in model.parameters()]
    return TrainState(model, zeros, [torch.zeros_like(z) for z in zeros], 0)


def _split(x: torch.Tensor, microbatch: int) -> torch.Tensor:
    """(mb, B/mb, ...) microbatches of ``x``; vlm positions (3, B, S)
    split on axis 1 (JAX's test: three dims, the first of size 3)."""
    if x.dim() == 3 and x.shape[0] == 3:
        return x.reshape(3, microbatch, -1, x.shape[-1]).transpose(0, 1)
    return x.reshape(microbatch, -1, *x.shape[1:])


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    weight_decay: float = 0.1, clip: float = 1.0,
                    microbatch: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    (mean over ``microbatch`` splits, grads averaged), global-norm
    clipping, AdamW (``optim.adamw``: bf16 params, float32 moments)."""
    _, opt_update = adamw(lr, weight_decay=weight_decay)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        model = state.params
        params = list(model.parameters())
        if microbatch > 1:
            mb = {k: _split(v, microbatch) for k, v in batch.items()}
            grads = [torch.zeros_like(p) for p in params]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for i in range(microbatch):
                li = lm.loss_fn(model, {k: v[i] for k, v in mb.items()})
                gi = torch.autograd.grad(li, params)
                grads = [a + g for a, g in zip(grads, gi)]
                loss = loss + li.detach()
            grads = [g / microbatch for g in grads]
            loss = loss / microbatch
        else:
            loss = lm.loss_fn(model, batch)
            grads = list(torch.autograd.grad(loss, params))
            loss = loss.detach()
        # clip_by_global_norm's scale, applied one parameter at a time
        gnorm = global_norm(grads)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        for i, p in enumerate(params):
            g, grads[i] = grads[i] * scale.to(grads[i].dtype), None
            ups, opt = opt_update([g], AdamState([state.mu[i]],
                                                 [state.nu[i]]),
                                  [p], state.step)
            apply_updates([p], ups)
            state.mu[i], state.nu[i] = opt.mu[0], opt.nu[0]
        return (TrainState(model, state.mu, state.nu, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, tokens, cache, extras):
        return lm.prefill(model, tokens, cache,
                          positions=extras.get("positions"),
                          memory=extras.get("memory"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, token, cache, pos, extras):
        return lm.decode_step(model, token, cache, pos,
                              memory=extras.get("memory"))
    return decode_step


def state_tree(state: TrainState) -> TrainState:
    """The state in JAX's checkpoint layout: JAX's parameter tree of the
    params and of each moment list, and the step as an int32 0-d
    tensor (leaf names ``params.blocks.attn.wq``, ``mu...``, ``step``)."""
    model = state.params
    return TrainState(lm.to_jax_tree(model),
                      lm.to_jax_tree(model, state.mu),
                      lm.to_jax_tree(model, state.nu),
                      torch.tensor(state.step, dtype=torch.int32))


def load_state_tree(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` holding ``tree`` (a :func:`state_tree`, e.g. restored):
    the parameters copied into the model, the moments and step taken."""
    model = state.params
    with torch.no_grad():
        for p, v in zip(model.parameters(), lm.from_jax_tree(model,
                                                             tree.params)):
            p.copy_(v)

    def moments(t):
        return [v.to(device=p.device, dtype=torch.float32) for p, v in
                zip(model.parameters(), lm.from_jax_tree(model, t))]

    return TrainState(model, moments(tree.mu), moments(tree.nu),
                      int(tree.step))
