"""GNN training loops (port of ``repro/models/gnn/train.py``): full
graph (paper Fig. 2) and sampled minibatch (paper Fig. 3).

One step is one forward, the masked cross-entropy, the backward, global
norm clipping and an AdamW update (lr 1e-2, weight decay 5e-4, clip 5.0
by default, as ``make_train_step`` sets them); per-epoch wall time — one
step ending in one host sync for the loss — is the paper's metric.
``strategy`` goes to the app's forward: ``"auto"`` runs the kernels on
the card (B1 forward and on Gᵀ backward for GCN and SAGE; B3 and B4 both
ways for GAT multipass), ``"segment"`` the plain versions. Dropout draws
from one ``torch.Generator`` on the graph's device, seeded by ``seed``:
two runs with one seed drop the same units.

The sampled loop (:func:`train_sampled`) samples on a prefetcher thread
(``data/pipeline.prefetch``; the trainer's sampler also builds each
block's Gᵀ there), pads the short final batch up to the static batch size
(loss rows masked by ``MiniBatch.label_mask``), and runs one step per
batch through the app's ``forward_blocks`` with ``bwd_strategy`` (the
block VJP, ``core/blocks.py``). It records the JAX loop's spans
(``train.epoch``, ``train.sample``, ``train.step``, ``train.drift_probe``)
and, once per new batch signature, an eager probe of the block ops'
forward and backward times (``obs.events``), which ``obs.drift_report``
holds against the planner's predicted costs.

``precision=`` ("fp32", "bf16" or an ``optim.Precision``) is JAX's mixed
precision policy: the parameters and AdamW's moments stay fp32 masters,
the loss runs the forward on ``precision.compute`` casts of them and of
the input rows (differentiable casts, so ``torch.autograd.grad`` hands
back fp32 gradients), and the cross-entropy is taken on fp32 logits. On
the card a bf16 step launches the same kernels as an fp32 step, in their
bf16 forms (fp32 accumulation). Partitioned training is ROADMAP A12.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...data.pipeline import prefetch
from ...data.sampler import NeighborSampler
from ...obs import metrics as _metrics
from ...obs.signatures import SignatureTracker
from ...obs.spans import fence, span
from ...optim import (Precision, adamw, apply_updates, cast_logits,
                      cast_tree, clip_by_global_norm)
from ...substrate.nn import accuracy, cross_entropy_loss
from .common import block_features, pad_features

__all__ = ["call_in_precision", "make_loss_step", "make_train_step",
           "train_full_graph", "make_sampled_train_step", "train_sampled"]


def _resolve_precision(precision) -> Precision:
    """Accept None (fp32), a name ("fp32" / "bf16") or a Precision."""
    if precision is None:
        return Precision.fp32()
    if isinstance(precision, str):
        return Precision.parse(precision)
    return precision


class _Bound(nn.Module):
    """``fn(model, ...)`` as a module call, so ``functional_call`` can
    swap ``model``'s parameters for their compute-dtype casts."""

    def __init__(self, fn: Callable, model: nn.Module):
        super().__init__()
        self.fn = fn
        self.model = model

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def call_in_precision(precision: Precision, fn: Callable, model: nn.Module,
                      *args, **kwargs):
    """``fn(model, *args, **kwargs)`` with every floating parameter of
    ``model`` replaced by its cast to ``precision.compute`` (a name or a
    ``Precision``; the masters stay as they are), so gradients reach the
    fp32 masters through the casts. At fp32 it is the plain call."""
    precision = _resolve_precision(precision)
    if not precision.mixed:
        return fn(model, *args, **kwargs)
    casts = cast_tree({f"model.{n}": p for n, p in model.named_parameters()},
                      precision.compute)
    return torch.func.functional_call(_Bound(fn, model), casts, args,
                                      kwargs, strict=False)


def make_loss_step(loss_fn: Callable, lr: float = 1e-2,
                   weight_decay: float = 5e-4, clip: float = 5.0):
    """Returns ``(opt_init, step)`` around any scalar loss — the one step
    body of every trainer here, and the training step of the apps with no
    trainer (GC-MC's per-rating loss, LGNN's, whose loss also writes its
    BatchNorm state back). ``opt_init(model)`` gives the AdamW state of
    ``model``'s parameters; ``step(model, opt_state, step_i, *args)``
    takes ``loss_fn(model, *args)``, its gradients by
    ``torch.autograd.grad`` (zero for a parameter the loss does not
    reach), clips them by global norm and updates the
    parameters in place; it returns ``(opt_state, loss)`` with ``loss`` a
    device scalar."""
    opt_init, opt_update = adamw(lr, weight_decay=weight_decay)

    def init(model: nn.Module):
        return opt_init(list(model.parameters()))

    def step(model: nn.Module, opt_state, step_i: int, *args):
        params = list(model.parameters())
        loss = loss_fn(model, *args)
        # a parameter the loss does not reach (LGNN's last line-graph
        # update) has a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        grads, _ = clip_by_global_norm(grads, clip)
        ups, opt_state = opt_update(grads, opt_state, params, step_i)
        apply_updates(params, ups)
        return opt_state, loss.detach()

    return init, step


def make_train_step(forward_fn: Callable, strategy: str = "auto",
                    lr: float = 1e-2, weight_decay: float = 5e-4,
                    clip: float = 5.0, precision=None):
    """Returns ``(opt_init, step)`` (:func:`make_loss_step` on the masked
    cross-entropy of ``forward_fn``'s logits): ``step(model, opt_state,
    step_i, bundle, x, labels, mask, gen)``; ``precision`` as in the
    module docstring (``x`` is cast inside the loss, every step)."""
    precision = _resolve_precision(precision)

    def loss_fn(model, bundle, x, labels, mask, gen):
        logits = call_in_precision(precision, forward_fn, model, bundle,
                                   cast_tree(x, precision.compute),
                                   strategy=strategy, train=True, gen=gen)
        return cross_entropy_loss(cast_logits(logits), labels, mask)

    return make_loss_step(loss_fn, lr, weight_decay, clip)


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
                                     precision=_resolve_precision(precision))
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


# --------------------------------------------------------------------- #
# sampled minibatch training (paper Fig. 3)
# --------------------------------------------------------------------- #
def make_sampled_train_step(forward_blocks_fn: Callable, strategy: str,
                            bwd_strategy: str = "auto", lr: float = 1e-2,
                            weight_decay: float = 5e-4, clip: float = 5.0,
                            precision=None):
    """Returns ``(opt_init, step)`` over one
    :class:`~repro_torch.data.MiniBatch` (:func:`make_loss_step`):
    ``step(model, opt_state, step_i, mb, feats_pad, gen)`` gathers the
    batch's input rows from ``feats_pad`` (``common.pad_features``), runs
    ``forward_blocks_fn`` with ``train=True`` and dropout from ``gen``,
    and takes the cross-entropy on the real seeds (``mb.label_mask``).
    ``bwd_strategy`` is the block VJP ('auto' takes the gather pull on
    the card). ``precision`` as in :func:`make_train_step`: the batch's
    input rows are cast inside the loss."""
    precision = _resolve_precision(precision)

    def loss_fn(model, mb, feats_pad, gen):
        x = cast_tree(block_features(feats_pad, mb.input_ids),
                      precision.compute)
        logits = call_in_precision(precision, forward_blocks_fn, model,
                                   mb.blocks, x, strategy=strategy,
                                   bwd_strategy=bwd_strategy, train=True,
                                   gen=gen)
        return cross_entropy_loss(cast_logits(logits), mb.labels,
                                  mb.label_mask)

    return make_loss_step(loss_fn, lr, weight_decay, clip)


def _drift_probe(forward_blocks_fn: Callable, model: nn.Module, mb,
                 feats_pad, strategy: str, bwd_strategy: str) -> None:
    """Once per new batch signature: the block forward without autograd
    (its ops timed as ``block:<op>``), then forward and backward (the
    backward's ops timed as ``block_bwd:<op>``), grads dropped — the
    measured side of the drift report (``obs.drift_report``), whose
    predicted side the block planner records with each decision."""
    if not _metrics.enabled():
        return
    with span("train.drift_probe"):
        x = block_features(feats_pad, mb.input_ids)
        with torch.no_grad():
            fence(forward_blocks_fn(model, mb.blocks, x, strategy=strategy,
                                    bwd_strategy=bwd_strategy))
        out = forward_blocks_fn(model, mb.blocks, x, strategy=strategy,
                                bwd_strategy=bwd_strategy)
        fence(torch.autograd.grad(out, list(model.parameters()),
                                  torch.ones_like(out)))


def train_sampled(forward_blocks_fn: Callable, model: nn.Module, g, feats,
                  labels, train_ids, *, fanouts=(10, 10),
                  batch_size: int = 64, strategy: str = "auto",
                  bwd_strategy: str = "auto", epochs: int = 5,
                  lr: float = 1e-2, weight_decay: float = 5e-4,
                  seed: int = 0, prefetch_depth: int = 2,
                  drop_last: bool = False,
                  sampler: Optional[NeighborSampler] = None,
                  max_batches: Optional[int] = None, precision=None
                  ) -> Tuple[nn.Module, Dict[str, List[float]]]:
    """Minibatch training of ``model`` in place on graph ``g`` (its
    device is the run's): sample (host, prefetched; each block's Gᵀ
    built with it) → one step per batch, ``max_batches`` per epoch at
    most. Returns ``(model, history)``; per epoch, ``loss`` is the mean
    batch loss, ``epoch_time`` the wall time, ``sample_time`` the time
    the loop waited on the prefetcher, ``step_time`` the steps' (ending
    in the loss read), ``n_batches`` the batches run — the
    sampling-vs-aggregation split of the paper's Fig. 3."""
    dev = g.device
    labels = np.asarray(labels)
    train_ids = np.asarray(train_ids)
    opt_init, step = make_sampled_train_step(
        forward_blocks_fn, strategy, bwd_strategy=bwd_strategy, lr=lr,
        weight_decay=weight_decay, precision=_resolve_precision(precision))
    opt_state = opt_init(model)
    feats_pad = pad_features(feats, dev)
    if sampler is None:
        sampler = NeighborSampler(g, fanouts, batch_size, seed=seed,
                                  device=dev, reverse=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tracker = SignatureTracker()
    history = {"loss": [], "epoch_time": [], "sample_time": [],
               "step_time": [], "n_batches": []}
    step_i = 0
    for _ in range(epochs):
        # one top-level span per epoch; sample / step / probe spans nest
        # under it, so the exported trace tiles the whole run
        with span("train.epoch"):
            it = prefetch(sampler.batches(train_ids, labels[train_ids],
                                          drop_last=drop_last),
                          depth=prefetch_depth)
            t_epoch = time.perf_counter()
            t_sample = t_step = 0.0
            losses = []
            try:
                while max_batches is None or len(losses) < max_batches:
                    t0 = time.perf_counter()
                    with span("train.sample"):
                        mb = next(it, None)
                    if mb is None:
                        break
                    t_sample += time.perf_counter() - t0
                    if tracker.observe_checked(mb.shape_signature()):
                        _drift_probe(forward_blocks_fn, model, mb,
                                     feats_pad, strategy, bwd_strategy)
                    t0 = time.perf_counter()
                    with span("train.step") as sp:
                        opt_state, loss = step(model, opt_state, step_i, mb,
                                               feats_pad, gen)
                        sp.fence(loss)
                        loss = float(loss)
                    t_step += time.perf_counter() - t0
                    losses.append(loss)
                    step_i += 1
                # stop the clock before close(): the join waits out an
                # abandoned in-flight sample no step consumed
                t_epoch = time.perf_counter() - t_epoch
            finally:
                it.close()  # never leave the producer thread mid-batch
        history["loss"].append(float(np.mean(losses)) if losses
                               else float("nan"))
        history["epoch_time"].append(t_epoch)
        history["sample_time"].append(t_sample)
        history["step_time"].append(t_step)
        history["n_batches"].append(len(losses))
    return model, history
