"""GNN training loops (port of ``repro/models/gnn/train.py``): full
graph (paper Fig. 2), sampled minibatch (paper Fig. 3) and partitioned
full graph (vertex shards on the emulated ring, or one shard per rank of
a ``torch.distributed`` process group).

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
bf16 forms (fp32 accumulation).

Partitioned training (:func:`train_partitioned`) keeps features, labels
and masks in the padded layout of the graph's partition end to end; each
step runs the app's ``forward_partitioned`` (exact, a delayed halo every
``halo_staleness`` epochs, and, with ``precision.comm == "int8"``, int8
exchanges whose error-feedback residual the step carries). On the card a
ring pass is B1 per ring stage (``core/partition.py``). With a process
group (``mesh``) each rank holds its shard's rows and the run is GSPMD's
by hand: the loss is the masked mean over every rank's rows (its sum and
count all-reduced), the gradients of the replicated parameters are
all-reduced before the norm clip, so AdamW runs alike on every rank and
the parameters stay equal across ranks.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...core.transport import all_reduce_sum, process_group
from ...data.pipeline import prefetch
from ...data.sampler import NeighborSampler
from ...obs import metrics as _metrics
from ...obs.signatures import SignatureTracker
from ...obs.spans import fence, span
from ...optim import (Precision, adamw, apply_updates, cast_logits,
                      cast_tree, clip_by_global_norm)
from ...substrate.nn import accuracy, cross_entropy_loss
from .common import (block_features, make_partitioned_bundle, pad_features,
                     shard_partitioned)

__all__ = ["call_in_precision", "make_loss_step", "make_train_step",
           "train_full_graph", "make_sampled_train_step", "train_sampled",
           "make_partitioned_train_step", "train_partitioned"]


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
    device scalar. ``step(..., group=g)`` with a process group sums the
    gradients over its ranks before the clip (each rank's loss its share
    of the whole). The step records the spans ``train.forward``,
    ``train.backward``, ``train.clip`` (the all-reduce with it) and
    ``train.optimizer``, each timed on the device without a host wait and
    tagged ``step`` = ``step_i``."""
    opt_init, opt_update = adamw(lr, weight_decay=weight_decay)

    def init(model: nn.Module):
        return opt_init(list(model.parameters()))

    def step(model: nn.Module, opt_state, step_i: int, *args, group=None):
        params = list(model.parameters())
        tag = {"step": int(step_i)}
        with span("train.forward", args=tag, device=True):
            loss = loss_fn(model, *args)
        with span("train.backward", args=tag, device=True):
            # a parameter the loss does not reach (LGNN's last line-graph
            # update) has a zero gradient, as under jax.grad
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(
                         loss, params, allow_unused=True))]
        with span("train.clip", args=tag, device=True):
            if group is not None:
                grads = all_reduce_sum(grads, group)
            grads, _ = clip_by_global_norm(grads, clip)
        with span("train.optimizer", args=tag, device=True):
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


# --------------------------------------------------------------------- #
# partitioned full-graph training (repro/models/gnn/train.py:116-260)
# --------------------------------------------------------------------- #
def _mesh_loss(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, group) -> torch.Tensor:
    """The masked mean cross-entropy over every rank's rows: its value is
    the whole run's loss; its gradient this rank's rows' share (their sum
    over the global count), which the gradient all-reduce completes."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    m = mask.to(nll.dtype)
    part = (nll * m).sum()
    total, count = all_reduce_sum([part.detach(), m.sum()], group)
    return (part + (total - part.detach())) / count.clamp(min=1.0)


def _mesh_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, group) -> torch.Tensor:
    """``accuracy`` over every rank's masked rows."""
    m = mask.to(torch.float32)
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
    hits, count = all_reduce_sum([(hit * m).sum(), m.sum()], group)
    return hits / count.clamp(min=1.0)


def make_partitioned_train_step(forward_part_fn: Callable,
                                lr: float = 1e-2,
                                weight_decay: float = 5e-4,
                                clip: float = 5.0, drop: float = 0.0,
                                precision=None, strategy: str = "auto"):
    """Returns ``(opt_init, step)`` over padded node tensors
    (:func:`make_loss_step`): ``step(model, opt_state, step_i, pb, xp,
    yp, mp, halo, comm, gen, refresh=True)`` runs
    ``forward_part_fn(model, pb, xp, halo=, refresh=, [comm_state=,]
    train=True, gen=, drop=, strategy=)`` in ``precision.compute`` (fp32
    masters, ``call_in_precision``), the masked cross-entropy on fp32
    logits, and returns ``(opt_state, loss, halo_out, comm_out)``:
    ``comm`` (None, or the per-layer int8 residuals) is carried into
    ``comm_out``; ``refresh`` is a plain bool (a stale-halo step). On a
    bundle with a process group the tensors are the rank's
    (``shard_partitioned``), the loss is the global masked mean and the
    gradients are all-reduced before the clip."""
    precision = _resolve_precision(precision)
    aux = {}

    def loss_fn(model, pb, xp, yp, mp, halo, comm, gen, refresh):
        kw = dict(halo=halo, refresh=refresh, train=True, gen=gen,
                  drop=drop, strategy=strategy)
        if comm is not None:
            kw["comm_state"] = comm
        out = call_in_precision(precision, forward_part_fn, model, pb,
                                cast_tree(xp, precision.compute), **kw)
        aux["halo"] = out[1]
        aux["comm"] = out[2] if comm is not None else None
        logits = cast_logits(out[0])
        if pb.mesh is None:
            return cross_entropy_loss(logits, yp, mp)
        return _mesh_loss(logits, yp, mp, pb.mesh)

    opt_init, inner = make_loss_step(loss_fn, lr, weight_decay, clip)

    def step(model, opt_state, step_i, pb, xp, yp, mp, halo, comm, gen,
             refresh: bool = True):
        opt_state, loss = inner(model, opt_state, step_i, pb, xp, yp, mp,
                                halo, comm, gen, refresh, group=pb.mesh)
        return opt_state, loss, aux.pop("halo"), aux.pop("comm")

    return opt_init, step


def train_partitioned(forward_part_fn: Callable, model: nn.Module, g, x,
                      labels, train_mask, *, n_shards: int, mesh=None,
                      axis: str = "data", mode: str = "contiguous",
                      halo_staleness: int = 0, epochs: int = 10,
                      lr: float = 1e-2, weight_decay: float = 5e-4,
                      drop: float = 0.0, seed: int = 0, val_mask=None,
                      init_halo_fn: Optional[Callable] = None,
                      precision=None,
                      init_comm_fn: Optional[Callable] = None,
                      strategy: str = "auto"
                      ) -> Tuple[nn.Module, Dict[str, List]]:
    """Full-graph training of ``model`` in place across ``n_shards``
    vertex shards of ``g`` (its device is the run's).

    Features are scattered once into the padded layout and the run stays
    there (labels padded with masked rows). ``mesh=None`` trains on the
    emulated ring; a process group of ``n_shards`` ranks (every rank calls
    with the same arguments) trains on the mesh ring, each rank on its
    shard's rows (``shard_partitioned``: features, labels, masks, the halo
    and the int8 residuals), the loss, ``val_acc`` and the gradients
    global; with ``drop > 0`` each rank keeps its rows of the whole
    layout's dropout mask, so the run is the emulated one.
    ``halo_staleness=0`` is exact every step; ``k > 0`` refreshes the
    cross-shard partials every k-th epoch and reuses them stale between
    (needs ``init_halo_fn``, e.g. ``gcn.init_halo``). ``precision`` as in
    :func:`train_full_graph`; ``precision.comm == "int8"`` puts the
    exchanges on the int8 wire with error feedback (needs
    ``init_comm_fn``, e.g. ``gcn.init_comm``). ``strategy`` goes to the
    ring ops (``core/partition.RING_STRATEGIES``). A warm-up step, and a
    stale one when delayed, run on a copy of the model first (their
    updates discarded, as JAX compiles both variants): they build the
    partition's stage graphs and every kernel's per-graph structures.
    Returns ``(model, history)``: per epoch ``loss``, ``epoch_time``
    (s), ``refreshed`` and, given ``val_mask``, ``val_acc``."""
    from ...core import planner

    precision = _resolve_precision(precision)
    group = process_group(mesh)
    pb = make_partitioned_bundle(g, n_shards, mesh=group, axis=axis,
                                 mode=mode)
    pg = pb.pg
    ring = "ring" if group is not None else "ring-emulated"
    planner._record("partitioned:train", "auto",
                    f"{ring}:s{n_shards}:{mode}:{precision.tag()}",
                    dtype=planner.dtype_name(precision.compute))
    dev = g.device
    xp = pg.scatter_nodes(torch.as_tensor(np.asarray(x, np.float32),
                                          device=dev))
    yp = pg.scatter_nodes(torch.as_tensor(np.asarray(labels),
                                          device=dev).long())
    mp = pg.scatter_nodes(torch.as_tensor(np.asarray(train_mask, bool),
                                          device=dev))
    vp = (None if val_mask is None else pg.scatter_nodes(
        torch.as_tensor(np.asarray(val_mask, bool), device=dev)))

    delayed = halo_staleness > 0
    if delayed and init_halo_fn is None:
        raise ValueError("halo_staleness > 0 needs init_halo_fn "
                         "(e.g. gcn.init_halo)")
    if precision.comm == "int8" and init_comm_fn is None:
        raise ValueError('precision.comm == "int8" needs init_comm_fn '
                         "(e.g. gcn.init_comm)")
    halo = init_halo_fn(model, pg) if delayed else None
    comm = init_comm_fn(model, pg) if precision.comm == "int8" else None
    if group is not None:
        pb, xp, yp, mp, vp = shard_partitioned(pb, xp, yp, mp, vp)
        if delayed:
            halo = shard_partitioned(pb, *halo)[1:]
        if comm is not None:
            comm = shard_partitioned(pb, *comm)[1:]

    opt_init, step = make_partitioned_train_step(
        forward_part_fn, lr=lr, weight_decay=weight_decay, drop=drop,
        precision=precision, strategy=strategy)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history = {"loss": [], "epoch_time": [], "val_acc": [],
               "refreshed": []}
    warm = copy.deepcopy(model)
    for refresh in ((True, False) if delayed else (True,)):
        _, loss, _, _ = step(warm, opt_init(warm), 0, pb, xp, yp, mp, halo,
                             comm, gen, refresh=refresh)
        float(loss)
    del warm

    opt_state = opt_init(model)
    for e in range(epochs):
        refresh = (not delayed) or (e % halo_staleness == 0)
        t0 = time.perf_counter()
        opt_state, loss, halo_new, comm = step(
            model, opt_state, e, pb, xp, yp, mp, halo, comm, gen,
            refresh=refresh)
        loss = float(loss)          # the epoch's one host sync
        history["epoch_time"].append(time.perf_counter() - t0)
        if delayed:
            halo = halo_new
        history["loss"].append(loss)
        history["refreshed"].append(bool(refresh))
        if vp is not None:
            with torch.no_grad():
                logits = call_in_precision(
                    precision, forward_part_fn, model, pb,
                    cast_tree(xp, precision.compute),
                    strategy=strategy)[0]
                logits = cast_logits(logits)
                history["val_acc"].append(float(
                    accuracy(logits, yp, vp) if group is None
                    else _mesh_accuracy(logits, yp, vp, group)))
    return model, history
