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
``DTensor`` records, ``requires_grad=False``). The model axis splits the
compute (``models/lm/tp.py``: Megatron TP and context-parallel
attention, the sequence-parallel residual, the vocab-parallel embedding,
head and CE, the MoE's expert-parallel, ff-TP and slot splits, the
Mamba2 mixer over its heads). A step:

1. hands the model's functions a ``fsdp.ShardedLM`` of the rank's
   shards (``launch/fsdp.py``; its plan, ``fsdp.gather_plan``, once a
   step): each block's leaves are gathered inside the function the
   model's remat checkpoints, just before the block runs, and dropped
   when it returns; the backward's recompute gathers them again, as
   JAX's ``nothing_saveable`` remat does. A leaf the split runs on its
   'model' chunk (``Split.chunk_dim``) is gathered over 'pod' / 'data'
   only and stays that chunk (the experts on E under 'ep', on d_ff under
   'ff'; ``out_proj`` on its 'model' dim; ``conv_w`` / ``conv_b`` only in
   a decode, whose conv runs on the rank's channel chunk); every other
   leaf (norms, the small experts, ``in_proj``, ``conv_w`` / ``conv_b``
   in a train or prefill step, whose conv runs on the rank's heads'
   channels, a leaf whose stored shard does not hold the chunk) is
   gathered whole. The non-block leaves are gathered at their use, a
   tied ``embed`` and the hybrid's ``shared`` block once a step;
2. runs the rank's share: its rows of the batch over 'data' (× 'pod')
   when ``batch_specs`` of a microbatch's size says so, else the whole
   batch (with ``microbatch > 1`` a rank's rows in microbatch i are its
   block of JAX's microbatch i), and its share of the model axis's work
   on them, the activations moving between the 'model' ranks at JAX's
   hint sites (``core/transport.py``); every 'model' rank gets the same
   loss;
3. takes the gradients to the rank's shards: each gather's backward
   divides by the row shards, takes the rank's 'model' chunk and
   reduce-scatters, in float32, over the batch axes the leaf is sharded
   on (``fsdp._Gather``); the step then sums, in float32, the gradients
   over the batch axes a leaf is replicated on, and the loss (every
   gradient is complete for the rank's rows, ``tp`` module docstring);
4. clips by the global norm (each element once: a shard's squares summed
   over the mesh dims its leaf is sharded on, never over its replicas)
   and runs AdamW on the rank's own shard of every parameter, one at a
   time.

The loss and grad norm reported are global. The mean of the ranks' mean
losses is the global mean because every rank holds as many labels, all
valid; a mesh step rejects a batch with masked (negative) labels (a fake
batch, the dry run's, has no values to test).

Serving over a process mesh (``make_prefill_step`` / ``make_decode_step``
with ``mesh=``; JAX's prefill and decode jitted with ``param_specs`` and
``cache_specs`` shardings) follows the train step's design. Between
calls the model's parameters are DTensor shards (:func:`shard_model`)
and the cache is held as shards of ``shardings.cache_specs``
(:func:`init_mesh_cache`, :func:`reshard_cache`). A call, under the
ambient mesh (the MoE's token blocks):

1. gathers each block's leaves just before it runs, as a train step
   does (no grad, no recompute; the plan for the call's split, a
   decode's attention following its cache's layout: heads, head_dim or
   whole), and the non-block leaves at their use; the encoder's leaves
   are never gathered;
2. runs prefill or decode on the rank's rows (its block over 'data' ×
   'pod' when ``batch_specs`` says so, else the whole batch), each rank
   reading and writing its own shards of the cache in place: its K/V
   heads, its chunk of the sequence (a context-parallel prefill, which
   starts from an empty cache) or its head_dim slice; its heads of the
   Mamba2 ``ssm`` state and its channels of the ``conv`` state (a
   prefill, which starts from an empty cache, writes them from the
   prompt's last conv inputs). No call gathers a cache leaf;
3. returns the logits as a DTensor of the global (B, V) (each rank's
   vocabulary slice gathered over 'model'), this rank's rows local.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from ..core.transport import all_reduce_sum
from ..device import DeviceLike
from ..models.lm import model as lm
from ..models.lm.config import ModelConfig
from ..optim import AdamState, adamw, apply_updates, global_norm
from ..models.lm.tp import Split, make_split
from ..pjit_utils import (BATCH_AXES, ambient_mesh, axis_sizes, full_tensors,
                          local_nbytes, local_shard, mesh_group, to_dtensor,
                          to_placements)
from . import shardings as shard_rules
from .fsdp import ShardedLM, gather_plan

__all__ = ["TrainState", "init_state", "state_of", "shard_model",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "state_specs", "state_placements", "eval_param_shapes",
           "state_tree", "load_state_tree", "is_sharded", "state_bytes",
           "cache_placements", "init_mesh_cache", "reshard_cache",
           "cache_bytes", "named_leaves", "tree_leaves",
           "step_batch_specs"]


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
    return sum(local_nbytes(t) for t in list(state.params.parameters())
               + list(state.mu) + list(state.nu))


def _param_placements(model: lm.LM, mesh, fsdp: bool = True
                      ) -> List[tuple]:
    metas = [torch.empty(p.shape, dtype=p.dtype, device="meta")
             for p in model.parameters()]
    specs = shard_rules.param_specs(lm.to_jax_tree(model, metas),
                                    model.cfg, mesh, fsdp=fsdp)
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


def state_of(model: lm.LM, mesh=None, fsdp: bool = True) -> TrainState:
    """The step-0 state of ``model`` (zero float32 moments); on a process
    ``mesh`` its parameters are replaced by this rank's shards
    (:func:`shard_model`)."""
    if mesh is None:
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in model.parameters()]
        return TrainState(model, zeros, [torch.zeros_like(z) for z in zeros],
                          0)
    mu, nu = [], []
    for p in shard_model(model, mesh, fsdp):
        local = p.to_local()
        for m in (mu, nu):
            m.append(to_dtensor(torch.zeros(local.shape, device=local.device),
                                mesh, p.placements, p.shape))
    return TrainState(model, mu, nu, 0)


def shard_model(model: lm.LM, mesh, fsdp: bool = True) -> List[nn.Parameter]:
    """Replace ``model``'s parameters by this rank's shards under JAX's
    ``param_specs`` (DTensor records, ``requires_grad=False``); returns
    them in ``model.parameters()`` order."""
    shards = []
    for p, pl in zip(model.parameters(),
                     _param_placements(model, mesh, fsdp)):
        local = local_shard(p.detach(), mesh, pl).clone()
        shards.append(nn.Parameter(to_dtensor(local, mesh, pl, p.shape),
                                   requires_grad=False))
    _set_params(model, shards)
    return shards


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


def _loss_and_grads(model: lm.LM, batches: List[Dict], split=None):
    """The mean loss and grads over ``batches`` (JAX's microbatch
    accumulation: grads summed, then divided)."""
    params = list(model.parameters())
    if len(batches) == 1:
        loss = lm.loss_fn(model, batches[0], split)
        return loss.detach(), list(torch.autograd.grad(loss, params))
    grads = [torch.zeros_like(p) for p in params]
    loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for b in batches:
        li = lm.loss_fn(model, b, split)
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


def step_batch_specs(cfg: ModelConfig, kind: str, mesh, batch_size: int
                     ) -> Dict:
    """``shardings.batch_specs`` of a ``kind`` step's inputs, with an
    encdec ``memory`` split along its first dim as the tokens are (as
    JAX's dry run places it)."""
    specs = shard_rules.batch_specs(cfg, kind, mesh, batch_size=batch_size)
    specs["memory"] = specs["tokens"][:1] + (None, None)
    return specs


def _rank_rows(cfg: ModelConfig, mesh, batch: Dict, kind: str = "train"
               ) -> Dict:
    """This rank's rows of ``batch`` (a ``kind`` step's inputs): its block
    over 'data' (× 'pod', pod-major) along the dim
    :func:`step_batch_specs` shards, or the whole batch when the size does
    not divide."""
    specs = step_batch_specs(cfg, kind, mesh, batch["tokens"].shape[0])
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


def _seq_len(batch: Dict) -> int:
    """The positions a train batch runs (``loss_fn``'s inputs)."""
    S = batch["tokens"].shape[1]
    return S if "labels" in batch else S - 1


def _shard_grads(cfg: ModelConfig, sharded: lm.LM, mesh, rows: List[Dict],
                 split: Optional[Split]) -> Tuple[torch.Tensor, list]:
    """The mean loss over the data shards and microbatches ``rows`` (the
    rank's), and the gradient of each of the rank's shards (before the
    clip), in ``parameters()`` order: the gathers' backward reduced each
    over the batch axes its leaf is sharded on (÷ the row shards, in
    float32); the rest of the mean runs here, in float32, over the batch
    axes it is replicated on, with the loss's."""
    batch_dims = [i for i, a in enumerate(mesh.mesh_dim_names)
                  if a in BATCH_AXES and int(mesh.shape[i]) > 1]
    n_rows = 1
    for i in batch_dims:
        n_rows *= int(mesh.shape[i])
    shards = list(sharded.parameters())
    leaves = [p.to_local().detach().requires_grad_() for p in shards]
    plan = gather_plan(sharded, split)
    # a ShardedLM per microbatch (its held leaves belong to one backward),
    # the grads accumulated as _loss_and_grads accumulates them
    if len(rows) == 1:
        loss, grads = _loss_and_grads(ShardedLM(sharded, plan, leaves,
                                                n_rows), rows, split)
    else:
        grads = [torch.zeros_like(p) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for b in rows:
            li, gi = _loss_and_grads(ShardedLM(sharded, plan, leaves,
                                               n_rows), [b], split)
            grads = [a + g for a, g in zip(grads, gi)]
            loss = loss + li
        loss, grads = loss / len(rows), [g / len(rows) for g in grads]
    del leaves
    loss = loss / n_rows
    for i in batch_dims:
        rep = [k for k, p in enumerate(shards)
               if not p.placements[i].is_shard()]
        red = all_reduce_sum([grads[k] for k in rep] + [loss],
                             mesh.get_group(i), dtype=torch.float32)
        loss = red[-1]
        for k, g in zip(rep, red):
            grads[k] = g
    return loss, grads


def _mesh_train_step(cfg: ModelConfig, lr: float, weight_decay: float,
                     clip: float, microbatch: int, mesh):
    _, opt_update = adamw(lr, weight_decay=weight_decay)
    mesh_group(mesh)                # the mesh must span the default group

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if "labels" in batch:
            masked = (batch["labels"] < 0).any()
            # a fake batch (the dry run's) holds no values to test
            if not is_fake(masked) and bool(masked):
                raise ValueError("a mesh train step takes no masked "
                                 "(negative) labels: its ranks' mean "
                                 "losses would not average to the global "
                                 "mean")
        shards = list(state.params.parameters())
        rows = [_rank_rows(cfg, mesh, b)
                for b in _microbatches(batch, microbatch)]
        split = make_split(cfg, mesh, _seq_len(rows[0]))
        loss, grads = _shard_grads(cfg, state.params, mesh, rows, split)
        # the global norm, each element once: a shard's squares summed over
        # the mesh dims its leaf is sharded on
        sq = {}
        for p, g in zip(shards, grads):
            on = tuple(i for i, q in enumerate(p.placements)
                       if q.is_shard() and int(mesh.shape[i]) > 1)
            sq[on] = sq.get(on, 0) + torch.sum(torch.square(g.float()))
        for i in range(mesh.ndim):
            on = [k for k in sq if i in k]
            if on:
                sq.update(zip(on, all_reduce_sum([sq[k] for k in on],
                                                 mesh.get_group(i))))
        gnorm = torch.sqrt(sum(sq.values()))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        with torch.no_grad():
            for i, p in enumerate(shards):
                g, grads[i] = grads[i] * scale.to(grads[i].dtype), None
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


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Returns ``prefill_step(model, tokens, cache, extras) -> (logits,
    cache)`` (JAX's signature; ``extras``: ``positions`` for the VLM,
    ``memory`` for encdec). With a process ``mesh``, the step of a model
    of shards and a cache of shards (module docstring); every rank passes
    the whole batch."""
    if mesh is not None:
        step = _mesh_serve_step(cfg, mesh, "prefill")
        return lambda model, tokens, cache, extras: step(
            model, tokens, cache, None, extras)

    def prefill_step(model, tokens, cache, extras):
        return lm.prefill(model, tokens, cache,
                          positions=extras.get("positions"),
                          memory=extras.get("memory"))
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """Returns ``decode_step(model, token, cache, pos, extras) -> (logits,
    cache)``; with a process ``mesh`` as :func:`make_prefill_step`."""
    if mesh is not None:
        return _mesh_serve_step(cfg, mesh, "decode")

    def decode_step(model, token, cache, pos, extras):
        return lm.decode_step(model, token, cache, pos,
                              memory=extras.get("memory"))
    return decode_step


def _mesh_serve_step(cfg: ModelConfig, mesh, kind: str):
    from torch.distributed.tensor import Replicate, Shard

    mesh_group(mesh)                # the mesh must span the default group
    names = mesh.mesh_dim_names

    def layout(dt) -> Optional[int]:
        """The per-layer dim of a stacked cache leaf sharded on 'model'."""
        if "model" not in names:
            return None
        p = dt.placements[names.index("model")]
        return p.dim - 1 if p.is_shard() else None

    @torch.no_grad()
    def serve_step(model, tokens, cache, pos, extras):
        inputs = {"tokens": tokens, **{k: v for k, v in extras.items()
                                       if v is not None}}
        with ambient_mesh(mesh):
            rows = _rank_rows(cfg, mesh, inputs, kind)
            attn = cache.get("attn", cache)
            split = make_split(
                cfg, mesh, rows["tokens"].shape[1] if kind == "prefill"
                else 1, kind, layout(attn["k"]) if "k" in attn else None,
                layout(attn["cross_k"]) if "cross_k" in attn else None)
            work = ShardedLM(model, gather_plan(model, split),
                             [p.to_local() for p in model.parameters()])
            tree = _with_leaves(cache, [dt.to_local()
                                        for dt in tree_leaves(cache)])
            if kind == "prefill":
                logits, _ = lm.prefill(work, rows["tokens"], tree,
                                       positions=rows.get("positions"),
                                       memory=rows.get("memory"),
                                       split=split)
            else:
                logits, _ = lm.decode_step(work, rows["tokens"], tree, pos,
                                           memory=rows.get("memory"),
                                           split=split)
            del work, tree
        split_rows = rows["tokens"].shape[0] != tokens.shape[0]
        pl = tuple(Shard(0) if split_rows and a in BATCH_AXES
                   else Replicate() for a in names)
        return to_dtensor(logits, mesh, pl,
                          (tokens.shape[0], logits.shape[1])), cache

    return serve_step


def named_leaves(tree, prefix: str = "") -> list:
    """``[("attn.k", leaf), ...]``: each leaf of a tree of nested dicts
    with its dotted path after ``prefix``, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(
            tree[k], f"{prefix}.{k}" if prefix else k)]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, keys sorted."""
    return [t for _, t in named_leaves(tree)]


def _with_leaves(tree, leaves: list):
    """``tree``'s structure holding ``leaves`` (:func:`tree_leaves`'
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def cache_placements(cfg: ModelConfig, mesh, batch_size: int, seq_len: int,
                     kind: str = "prefill"):
    """JAX's ``cache_specs`` as DTensor placements over ``mesh`` (a tree
    of the cache's shape)."""
    return shard_rules.map_tree(
        lambda _, s: to_placements(s, mesh),
        shard_rules.cache_specs(cfg, mesh, batch_size=batch_size,
                                seq_len=seq_len, kind=kind))


def init_mesh_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    mesh, *, kind: str = "prefill",
                    device: DeviceLike = "cuda"):
    """``lm.init_cache`` over a process ``mesh``: a tree of DTensors of
    the global shapes whose local tensors are this rank's zeroed shards
    under ``cache_specs(kind=)``; nothing global is allocated."""
    shapes = lm.init_cache(cfg, batch, max_seq, dtype, "meta")
    pls = cache_placements(cfg, mesh, batch, max_seq, kind)
    return _with_leaves(shapes, [
        to_dtensor(torch.zeros(local_shard(m, mesh, pl).shape, dtype=m.dtype,
                               device=device), mesh, pl, m.shape)
        for m, pl in zip(tree_leaves(shapes), tree_leaves(pls))])


def reshard_cache(cache, cfg: ModelConfig, mesh, *, kind: str):
    """``cache`` (DTensor shards) under ``cache_specs(kind=)``: leaves
    whose placements change are gathered whole and sliced anew (JAX's
    resharding between a prefill and a decode jit)."""
    leaves = tree_leaves(cache)
    pls = tree_leaves(cache_placements(cfg, mesh, _cache_batch(cache),
                                       _cache_seq(cache), kind))
    moved = [i for i, (t, pl) in enumerate(zip(leaves, pls))
             if tuple(t.placements) != tuple(pl)]
    whole = full_tensors([leaves[i] for i in moved])
    out = list(leaves)
    for i, t in zip(moved, whole):
        out[i] = to_dtensor(local_shard(t, mesh, pls[i]).clone(), mesh,
                            pls[i], t.shape)
    return _with_leaves(cache, out)


def _cache_batch(cache) -> int:
    """The batch size of an LM cache tree (its leaves' batch dim)."""
    if "attn" in cache:
        return cache["attn"]["k"].shape[1]
    return (cache["k"] if "k" in cache else cache["conv"]).shape[1]


def _cache_seq(cache) -> int:
    """The max sequence length of an LM cache tree (0 without K / V)."""
    kv = cache.get("attn", cache)
    return kv["k"].shape[2] if "k" in kv else 0


def cache_bytes(cache) -> int:
    """The bytes this rank holds of a cache tree (DTensor shards or
    plain tensors)."""
    return sum(local_nbytes(t) for t in tree_leaves(cache))


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
