"""Train / prefill / decode step builders for the LM stack (port of
``repro/launch/steps.py``), on one card or over a process mesh.

``TrainState(params, mu, nu, step)``: ``params`` is the model (an
:class:`~repro_torch.models.lm.model.LM`), ``mu`` / ``nu`` its float32
AdamW moments, one per parameter in ``model.parameters()`` order, and
``step`` an int. A train step DONATES its input state, as JAX's jitted
step does (``donate_argnums``): the parameters are updated in place and
each moment is replaced in the state's lists as soon as its parameter is
done, so at most one parameter's temporaries exist beside the state.
:func:`state_tree` / :func:`load_state_tree` give the state JAX's
checkpoint layout (``params`` / ``mu`` / ``nu`` as JAX's stacked trees).

On a process mesh (``init_state(..., mesh=)``, ``make_train_step(...,
mesh=)``; a ``DeviceMesh`` over every rank) the state is SHARDED as
JAX's specs say (:func:`state_specs`): between steps each rank holds only
its shards of params, μ and ν, each a ``DTensor`` with
``shardings.to_placements`` of its spec (the model's parameters are
``DTensor`` records, ``requires_grad=False``). A step:

1. gathers the parameters (``pjit_utils.full_tensors``: one collective
   per mesh dim) into a working full-size model, which lives for the
   step only (the transient: one full copy of the params and their
   grads per rank);
2. runs the rank's share of the batch: split over 'data' (× 'pod') when
   ``batch_specs`` of a microbatch's size says so, else the whole batch;
   with ``microbatch > 1`` a rank's rows in microbatch i are its block
   of JAX's microbatch i;
3. all-reduces the loss and the gradients over the whole mesh (sum of
   ``g / size``, in float32; ranks on 'model' computed the same rows, so
   this is the mean over the data shards, the same bits on every rank);
4. clips by the global norm and runs AdamW on the rank's own shard of
   every parameter, one at a time.

The loss and grad norm reported are global. The mean of the ranks' mean
losses is the global mean because every rank holds as many labels, all
valid; a mesh step rejects a batch with masked (negative) labels.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from ..core.transport import all_reduce_sum
from ..device import DeviceLike
from ..models.lm import model as lm
from ..models.lm.config import ModelConfig
from ..optim import AdamState, adamw, apply_updates, global_norm
from ..pjit_utils import (axis_sizes, full_tensors, local_shard, mesh_group,
                          to_dtensor, to_placements)
from . import shardings as shard_rules

__all__ = ["TrainState", "init_state", "state_of", "make_train_step",
           "make_prefill_step", "make_decode_step", "state_specs",
           "state_placements", "eval_param_shapes", "state_tree",
           "load_state_tree", "is_sharded", "state_bytes"]


class TrainState(NamedTuple):
    params: lm.LM
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int


def eval_param_shapes(cfg: ModelConfig, max_seq: int = 0) -> Dict:
    """JAX's parameter tree of ``cfg`` as meta tensors (shapes and
    dtypes, no storage)."""
    return lm.to_jax_tree(lm.LM(cfg, max_seq=max_seq, device="meta",
                                init=False))


def state_specs(params_shape, cfg: ModelConfig, mesh) -> TrainState:
    """JAX's ``state_specs``: the moments take the parameters' specs,
    the step is replicated."""
    ps = shard_rules.param_specs(params_shape, cfg, mesh)
    return TrainState(ps, ps, ps, ())


def state_placements(params_shape, cfg: ModelConfig, mesh) -> TrainState:
    """:func:`state_specs` as DTensor placements over ``mesh``: the
    ``shardings`` of ``CheckpointManager.restore_latest`` (the step's
    ``None``: restored whole)."""
    pl = shard_rules.map_tree(lambda _, s: to_placements(s, mesh),
                              state_specs(params_shape, cfg, mesh).params)
    return TrainState(pl, pl, pl, None)


def is_sharded(state: TrainState) -> bool:
    """Does ``state`` hold DTensor shards (a mesh state)?"""
    from torch.distributed.tensor import DTensor

    return isinstance(next(state.params.parameters()), DTensor)


def state_bytes(state: TrainState) -> int:
    """The bytes this rank holds of the state's params, μ and ν."""
    def local(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()

    return sum(local(t) for t in list(state.params.parameters())
               + list(state.mu) + list(state.nu))


def _param_placements(model: lm.LM, mesh) -> List[tuple]:
    metas = [torch.empty(p.shape, dtype=p.dtype, device="meta")
             for p in model.parameters()]
    specs = shard_rules.param_specs(lm.to_jax_tree(model, metas),
                                    model.cfg, mesh)
    return [to_placements(s, mesh)
            for s in shard_rules.model_specs(model, specs)]


def _set_params(model: nn.Module, params: List[nn.Parameter]) -> None:
    """Bind ``params`` as ``model``'s parameters, in order."""
    for (name, _), p in zip(list(model.named_parameters()), params):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, p)


def init_state(cfg: ModelConfig, *, seed: int = 0, max_seq: int = 0,
               device: DeviceLike = "cuda", mesh=None) -> TrainState:
    """A new model (``lm.init_params``) with zero float32 moments; on a
    process ``mesh``, every rank draws the same model and keeps its
    shards."""
    return state_of(lm.init_params(cfg, seed=seed, max_seq=max_seq,
                                   device=device), mesh)


def state_of(model: lm.LM, mesh=None) -> TrainState:
    """The step-0 state of ``model`` (zero float32 moments); on a process
    ``mesh`` its parameters are replaced by this rank's shards."""
    if mesh is None:
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in model.parameters()]
        return TrainState(model, zeros, [torch.zeros_like(z) for z in zeros],
                          0)
    mu, nu, shards = [], [], []
    for p, pl in zip(model.parameters(), _param_placements(model, mesh)):
        local = local_shard(p.detach(), mesh, pl).clone()
        shards.append(nn.Parameter(to_dtensor(local, mesh, pl, p.shape),
                                   requires_grad=False))
        for m in (mu, nu):
            m.append(to_dtensor(torch.zeros(local.shape, device=local.device),
                                mesh, pl, p.shape))
    _set_params(model, shards)
    return TrainState(model, mu, nu, 0)


def _split(x: torch.Tensor, microbatch: int) -> torch.Tensor:
    """(mb, B/mb, ...) microbatches of ``x``; vlm positions (3, B, S)
    split on axis 1 (JAX's test: three dims, the first of size 3)."""
    if x.dim() == 3 and x.shape[0] == 3:
        return x.reshape(3, microbatch, -1, x.shape[-1]).transpose(0, 1)
    return x.reshape(microbatch, -1, *x.shape[1:])


def _microbatches(batch: Dict, microbatch: int) -> List[Dict]:
    if microbatch == 1:
        return [batch]
    mb = {k: _split(v, microbatch) for k, v in batch.items()}
    return [{k: v[i] for k, v in mb.items()} for i in range(microbatch)]


def _loss_and_grads(model: lm.LM, batches: List[Dict]):
    """The mean loss and grads over ``batches`` (JAX's microbatch
    accumulation: grads summed, then divided)."""
    params = list(model.parameters())
    if len(batches) == 1:
        loss = lm.loss_fn(model, batches[0])
        return loss.detach(), list(torch.autograd.grad(loss, params))
    grads = [torch.zeros_like(p) for p in params]
    loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for b in batches:
        li = lm.loss_fn(model, b)
        gi = torch.autograd.grad(li, params)
        grads = [a + g for a, g in zip(grads, gi)]
        loss = loss + li.detach()
    return loss / len(batches), [g / len(batches) for g in grads]


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    weight_decay: float = 0.1, clip: float = 1.0,
                    microbatch: int = 1, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    (mean over ``microbatch`` splits, grads averaged), global-norm
    clipping, AdamW (``optim.adamw``: bf16 params, float32 moments). With
    a process ``mesh`` the step of a sharded state (module docstring);
    every rank passes the whole batch."""
    if mesh is not None:
        return _mesh_train_step(cfg, lr, weight_decay, clip, microbatch,
                                mesh)
    _, opt_update = adamw(lr, weight_decay=weight_decay)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        model = state.params
        params = list(model.parameters())
        loss, grads = _loss_and_grads(model, _microbatches(batch,
                                                           microbatch))
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


def _rank_rows(cfg: ModelConfig, mesh, batch: Dict) -> Dict:
    """This rank's rows of ``batch``: its block over 'data' (× 'pod',
    pod-major) along the dim ``batch_specs`` shards, or the whole batch
    when the size does not divide."""
    B = batch["tokens"].shape[0]
    specs = shard_rules.batch_specs(cfg, "train", mesh, batch_size=B)
    if specs["tokens"][0] is None:
        return batch
    sizes, coord = axis_sizes(mesh), dict(zip(
        mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in ("pod", "data"):
        if a in sizes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    out = {}
    for k, v in batch.items():
        spec = specs.get(k)
        d = next((i for i, e in enumerate(spec or ()) if e is not None),
                 None)
        out[k] = v if d is None else v.narrow(d, idx * (v.shape[d] // n),
                                              v.shape[d] // n)
    return out


def _mesh_train_step(cfg: ModelConfig, lr: float, weight_decay: float,
                     clip: float, microbatch: int, mesh):
    _, opt_update = adamw(lr, weight_decay=weight_decay)
    group = mesh_group(mesh)
    size = mesh.size()

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if "labels" in batch and bool((batch["labels"] < 0).any()):
            raise ValueError("a mesh train step takes no masked (negative) "
                             "labels: its ranks' mean losses would not "
                             "average to the global mean")
        shards = list(state.params.parameters())
        max_seq = (state.params.dec_pos.shape[0]
                   if hasattr(state.params, "dec_pos") else 0)
        model = lm.LM(cfg, max_seq=max_seq, device="meta", init=False)
        _set_params(model, [nn.Parameter(t) for t in full_tensors(shards)])
        loss, grads = _loss_and_grads(model, [
            _rank_rows(cfg, mesh, b)
            for b in _microbatches(batch, microbatch)])
        del model
        # the mean over the mesh, in float32, the same bits on every rank
        for g in grads:
            g.div_(size)
        red = all_reduce_sum(grads + [loss / size], group,
                             dtype=torch.float32)
        loss, grads = red[-1], red[:-1]
        gnorm = global_norm(grads)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        with torch.no_grad():
            for i, p in enumerate(shards):
                g = local_shard(grads[i], mesh, p.placements)
                g, grads[i] = g * scale.to(g.dtype), None
                ups, opt = opt_update([g], AdamState(
                    [state.mu[i].to_local()], [state.nu[i].to_local()]),
                    [p.to_local()], state.step)
                apply_updates([p.to_local()], ups)
                state.mu[i], state.nu[i] = (
                    to_dtensor(m[0], mesh, p.placements, p.shape)
                    for m in (opt.mu, opt.nu))
        return (TrainState(state.params, state.mu, state.nu, state.step + 1),
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


def _stack_shards(dts: list):
    """The stacked leaf of per-layer DTensors: its shard is theirs
    stacked, each placement one dim further in."""
    from torch.distributed.tensor import Shard

    pl = tuple(Shard(p.dim + 1) if p.is_shard() else p
               for p in dts[0].placements)
    return to_dtensor(torch.stack([d.to_local() for d in dts]),
                      dts[0].device_mesh, pl, (len(dts),) + tuple(dts[0].shape))


def state_tree(state: TrainState) -> TrainState:
    """The state in JAX's checkpoint layout: JAX's parameter tree of the
    params and of each moment list, and the step as an int32 0-d
    tensor (leaf names ``params.blocks.attn.wq``, ``mu...``, ``step``).
    A mesh state's leaves are DTensors (a stacked leaf's shard is its
    layers' shards stacked)."""
    model = state.params
    step = torch.tensor(state.step, dtype=torch.int32)
    if is_sharded(state):
        def tree(ts):
            return lm.to_jax_tree(model, ts, stack=_stack_shards)

        return TrainState(tree(list(model.parameters())), tree(state.mu),
                          tree(state.nu), step)
    return TrainState(lm.to_jax_tree(model),
                      lm.to_jax_tree(model, state.mu),
                      lm.to_jax_tree(model, state.nu), step)


def load_state_tree(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` holding ``tree`` (a :func:`state_tree`, e.g. restored):
    the parameters copied into the model, the moments and step taken. A
    mesh state takes a tree of DTensors with its own placements
    (``restore_latest(..., shardings=state_placements(...))``)."""
    model = state.params
    if is_sharded(state):
        shards = list(model.parameters())
        shapes = [p.to_local().shape for p in shards]

        def locals_(t):
            return lm.from_jax_tree(model, shard_rules.map_tree(
                lambda _, d: d.to_local(), t), shapes)

        with torch.no_grad():
            for p, v in zip(shards, locals_(tree.params)):
                p.to_local().copy_(v)

        def sharded_moments(t):
            return [to_dtensor(v.to(device=p.device, dtype=torch.float32),
                               p.device_mesh, p.placements, p.shape)
                    for p, v in zip(shards, locals_(t))]

        return TrainState(model, sharded_moments(tree.mu),
                          sharded_moments(tree.nu), int(tree.step))
    with torch.no_grad():
        for p, v in zip(model.parameters(), lm.from_jax_tree(model,
                                                             tree.params)):
            p.copy_(v)

    def moments(t):
        return [v.to(device=p.device, dtype=torch.float32) for p, v in
                zip(model.parameters(), lm.from_jax_tree(model, t))]

    return TrainState(model, moments(tree.mu), moments(tree.nu),
                      int(tree.step))
