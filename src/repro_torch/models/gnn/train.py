"""Full-graph GNN training (port of ``repro/models/gnn/train.py:51-111``,
paper Fig. 2).

One step is one forward, the masked cross-entropy, the backward, global
norm clipping and an AdamW update (lr 1e-2, weight decay 5e-4, clip 5.0
by default, as ``make_train_step`` sets them); per-epoch wall time — one
step ending in one host sync for the loss — is the paper's metric.
``strategy`` goes to the app's forward: ``"auto"`` runs the kernels on
the card (B1 forward and on Gᵀ backward for GCN and SAGE with a training
bundle; B3 and B4 both ways for GAT multipass), ``"segment"`` the plain
versions. Dropout draws from one ``torch.Generator`` on the graph's
device, seeded by ``seed``: two runs with one seed drop the same units.

fp32 only: mixed precision is ROADMAP A12. Sampled and partitioned
training are queue A items 4 and 8.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from ...optim import adamw, apply_updates, clip_by_global_norm
from ...substrate.nn import accuracy, cross_entropy_loss

__all__ = ["make_train_step", "train_full_graph"]


def _check_precision(precision) -> None:
    if precision not in (None, "fp32"):
        raise NotImplementedError(
            f"precision {precision!r} is not ported: the port trains in "
            f"fp32 only (mixed precision is ROADMAP A12)")


def make_train_step(forward_fn: Callable, strategy: str = "auto",
                    lr: float = 1e-2, weight_decay: float = 5e-4,
                    clip: float = 5.0, precision=None):
    """Returns ``(opt_init, step)``. ``opt_init(model)`` gives the AdamW
    state of ``model``'s parameters; ``step(model, opt_state, step_i,
    bundle, x, labels, mask, gen)`` updates the parameters in place and
    returns ``(opt_state, loss)`` with ``loss`` a device scalar."""
    _check_precision(precision)
    opt_init, opt_update = adamw(lr, weight_decay=weight_decay)

    def init(model: nn.Module):
        return opt_init(list(model.parameters()))

    def step(model: nn.Module, opt_state, step_i: int, bundle, x, labels,
             mask, gen: torch.Generator):
        params = list(model.parameters())
        logits = forward_fn(model, bundle, x, strategy=strategy, train=True,
                            gen=gen)
        loss = cross_entropy_loss(logits, labels, mask)
        grads = torch.autograd.grad(loss, params)
        grads, _ = clip_by_global_norm(grads, clip)
        ups, opt_state = opt_update(grads, opt_state, params, step_i)
        apply_updates(params, ups)
        return opt_state, loss.detach()

    return init, step


def train_full_graph(forward_fn: Callable, model: nn.Module, bundle, x,
                     labels, train_mask, *, strategy: str = "auto",
                     epochs: int = 10, lr: float = 1e-2, seed: int = 0,
                     val_mask=None, precision=None
                     ) -> Tuple[nn.Module, Dict[str, List[float]]]:
    """Train ``model`` in place for ``epochs`` full-graph steps; returns
    ``(model, history)`` with per-epoch ``loss``, ``epoch_time`` (s) and,
    given ``val_mask``, ``val_acc``. ``x``, ``labels`` and the masks may
    be numpy arrays or tensors; they move to the graph's device. A
    warm-up step on a copy of the model comes first (its result
    discarded, as in JAX, where it compiles): it builds the per-graph
    structures of every kernel of the step, G's and Gᵀ's."""
    dev = bundle.g.device
    opt_init, step = make_train_step(forward_fn, strategy, lr=lr,
                                     precision=precision)
    x = torch.as_tensor(x, device=dev)
    labels = torch.as_tensor(labels, device=dev).long()
    mask = torch.as_tensor(train_mask, device=dev)
    val = None if val_mask is None else torch.as_tensor(val_mask, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    history = {"loss": [], "epoch_time": [], "val_acc": []}
    warm = copy.deepcopy(model)
    _, loss = step(warm, opt_init(warm), 0, bundle, x, labels, mask, gen)
    float(loss)
    del warm

    opt_state = opt_init(model)
    for e in range(epochs):
        t0 = time.perf_counter()
        opt_state, loss = step(model, opt_state, e, bundle, x, labels, mask,
                               gen)
        loss = float(loss)          # the epoch's one host sync
        history["epoch_time"].append(time.perf_counter() - t0)
        history["loss"].append(loss)
        if val is not None:
            with torch.no_grad():
                logits = forward_fn(model, bundle, x, strategy=strategy)
                history["val_acc"].append(float(accuracy(logits, labels,
                                                         val)))
    return model, history
