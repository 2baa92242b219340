"""Per-block parameter gathering in the LM mesh steps: ZeRO-3 as JAX's
specs place it (``repro/launch/shardings.py``: FSDP on 'data', × 'pod'),
and as GSPMD runs it inside JAX's scanned, checkpointed layer stacks (a
block's weights gathered in the scan body, freed after it, gathered again
by the ``nothing_saveable`` recompute, their gradients reduce-scattered).

Between calls a rank holds only its shards of the parameters (DTensor
records, ``steps.shard_model``). A mesh step hands the model's functions
a :class:`ShardedLM` in place of the model. It has the model's attribute
layout, but its leaves stay shards until they are used:

* a block (``blocks[i]``, ``enc_blocks[i]``) is a :class:`BlockHandle`.
  The model's block functions call its :meth:`~BlockHandle.gather` first,
  INSIDE the function ``model._remat`` checkpoints, so a block's leaves
  are gathered just before it runs and dropped when it returns. The
  backward's recompute gathers them again; a serve call (no grad, no
  recompute) gathers each block once. Nothing outside the block keeps a
  reference: the gathered leaves live in a :class:`ParamView` local to
  the block's function.
* the other leaves are gathered at their use, once a call: ``lm_head``,
  ``final_norm``, ``enc_pos``, ``dec_pos``, ``enc_final_norm``, and an
  untied ``embed``. Two are gathered once a step and held across their
  uses, as JAX's program holds them: a tied ``embed`` (the lookup and the
  head; one gather, one reduce-scatter of the summed gradient), and the
  hybrid's ``shared`` block (applied after every group; JAX runs it
  outside the remat, so its weights live to the backward there too).

Which chunk a leaf gets (:func:`gather_plan`): a leaf the split runs on
its 'model' chunk (``Split.chunk_dim``) is gathered over the batch axes
only, where its shard is sharded on that dim by 'model' alone
(:func:`owns_chunk`); every other leaf is gathered whole (``Split.tp``
takes the rank's chunk of those). Mesh dims of size 1 are skipped.

The gather is an autograd function (:class:`_Gather`: a group of leaves,
one ``all_gather_cat`` per mesh dim, innermost first, so a dim sharded
over several mesh dims comes back in mesh order). Its backward takes
each leaf's gradient to the rank's shard: ÷ the number of row shards
(in the gradient's dtype), then per tensor dim the rank's 'model' chunk
taken, with no sum (a leaf used whole entered through ``Split.part``,
whose gradient is summed over 'model' already, or is the same on every
'model' rank); then, in float32, one ``reduce_scatter_cat`` per batch
mesh dim, outermost first, over every leaf of the group sharded on it.
A fused dim (``("data", "model")``) keeps mesh order: the 'model' chunks
the rank owns in every 'data' block are taken first, then scattered over
'data'. So a gradient reaches the optimizer as the rank's shard, summed
over the batch axes the leaf is sharded on; ``steps`` sums it over those
it is replicated on.

:func:`stats` counts the gathers (one per group of leaves), the bytes
they received, the reduce-scatters and their operand bytes, and the
gathered bytes alive at once (each gathered tensor's storage, until it
is freed) with their peak.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
from torch import nn

from ..core.transport import reduce_scatter_cat
from ..pjit_utils import BATCH_AXES, gather_shards

__all__ = ["GatherPlan", "gather_plan", "owns_chunk", "ShardedLM",
           "BlockHandle", "ParamView", "stats", "reset_stats"]

_STATS = {"gathers": 0, "gathered_bytes": 0, "reduce_scatters": 0,
          "reduce_scatter_bytes": 0, "live_bytes": 0, "peak_live_bytes": 0}


def reset_stats() -> None:
    """Zero the counts; the peak restarts from the bytes alive now."""
    live = _STATS["live_bytes"]
    for k in _STATS:
        _STATS[k] = 0
    _STATS["live_bytes"] = _STATS["peak_live_bytes"] = live


def stats() -> Dict[str, int]:
    """Since :func:`reset_stats`: ``gathers`` (calls), ``gathered_bytes``
    (received: gathered less the local shards), ``reduce_scatters``
    (collectives), ``reduce_scatter_bytes`` (their float32 operands),
    ``live_bytes`` (gathered bytes alive now), ``peak_live_bytes``."""
    return dict(_STATS)


def _release(n: int) -> None:
    _STATS["live_bytes"] -= n


def _track(t: torch.Tensor) -> None:
    st = t.untyped_storage()
    n = st.nbytes()
    _STATS["live_bytes"] += n
    _STATS["peak_live_bytes"] = max(_STATS["peak_live_bytes"],
                                    _STATS["live_bytes"])
    weakref.finalize(st, _release, n)


def owns_chunk(p, dim: int) -> bool:
    """Does the shard of the DTensor ``p`` hold its 'model' chunk along
    ``dim`` whole along every other axis's sharding of that dim (the
    chunk a gather over the batch axes alone completes)?"""
    names = p.device_mesh.mesh_dim_names
    if "model" not in names:
        return False
    own = p.placements[names.index("model")]
    return (own.is_shard() and own.dim == dim and not any(
        q.is_shard() and q.dim == dim
        for a, q in zip(names, p.placements) if a != "model"))


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Per leaf name (``model.named_parameters``): ``over``, the mesh dims
    (indices) it is gathered over; ``shapes``, its gathered shape;
    ``chunked``, the leaves that stay their 'model' chunk."""
    over: Dict[str, Tuple[int, ...]]
    shapes: Dict[str, Tuple[int, ...]]
    chunked: frozenset


def gather_plan(sharded: nn.Module, split=None) -> GatherPlan:
    """The plan of a call of ``split`` on the model of DTensor shards
    ``sharded``: the leaves ``split`` runs on their 'model' chunk
    (``Split.chunk_dim``) whose shard is sharded on that dim by 'model'
    alone stay that chunk. Every other leaf is gathered whole: the norms,
    the small experts, ``in_proj`` (its shard a chunk of the fused dim),
    and the fused fallbacks that shard one dim over both 'data' and
    'model' (``wq`` ``(("data", "model"), None, None)``, ``wo`` ``(None,
    None, ("data", "model"))``, ``embed`` / ``lm_head`` ``(None,
    ("model", "data"))`` where the vocabulary does not divide, whose
    chunks DTensor orders in mesh order, not JAX's) or on another dim
    (``wq`` on head_dim under 'heads'); ``Split.tp`` takes the rank's
    chunk of those."""
    named = list(sharded.named_parameters())
    mesh = named[0][1].device_mesh
    names = mesh.mesh_dim_names
    sizes = [int(s) for s in mesh.shape]
    over, shapes, chunked = {}, {}, set()
    for n, p in named:
        d = split.chunk_dim(n) if split is not None else None
        chunk = d is not None and owns_chunk(p, d)
        if chunk:
            chunked.add(n)
        dims = tuple(i for i, q in enumerate(p.placements)
                     if q.is_shard() and sizes[i] > 1
                     and not (chunk and names[i] not in BATCH_AXES))
        shape = list(p.to_local().shape)
        for i in dims:
            shape[p.placements[i].dim] *= sizes[i]
        over[n], shapes[n] = dims, tuple(shape)
    return GatherPlan(over, shapes, frozenset(chunked))


class _Group:
    """One gather's leaves: their placements, the mesh dims each is
    gathered over, and the step's row shards (the gradient's divisor)."""

    def __init__(self, mesh, placements, over, n_rows: int):
        self.mesh, self.placements, self.over = mesh, placements, over
        self.n_rows = n_rows
        self.names = mesh.mesh_dim_names
        self.sizes = [int(s) for s in mesh.shape]


def _take_model_chunks(g: torch.Tensor, grp: _Group, pl, over
                       ) -> torch.Tensor:
    """``g`` (a gathered leaf's gradient) at the rank's chunk along every
    non-batch mesh dim in ``over``; a tensor dim sharded over several mesh
    dims is viewed as (mesh dims in mesh order, chunk) and the batch ones
    stay, in that order."""
    coord = grp.mesh.get_coordinate()
    for d in sorted({pl[i].dim for i in over}):
        along = [i for i in over if pl[i].dim == d]
        if all(grp.names[i] in BATCH_AXES for i in along):
            continue
        shape = list(g.shape)
        blocks = [grp.sizes[i] for i in along]
        chunk = shape[d]
        for b in blocks:
            chunk //= b
        g = g.reshape(shape[:d] + blocks + [chunk] + shape[d + 1:])
        for j in reversed(range(len(along))):
            if grp.names[along[j]] not in BATCH_AXES:
                g = g.select(d + j, int(coord[along[j]]))
        g = g.reshape(shape[:d] + [-1] + shape[d + 1:])
    return g


class _Gather(torch.autograd.Function):
    """The group's leaves gathered (module docstring); the adjoint takes
    each gradient to the rank's shard."""

    @staticmethod
    def forward(ctx, grp: _Group, *locals_):
        ctx.grp = grp
        ctx.dtypes = [t.dtype for t in locals_]
        ctx.shapes = [t.shape for t in locals_]
        ctx.device = locals_[0].device
        out = gather_shards(locals_, grp.placements, grp.mesh, grp.over)
        _STATS["gathers"] += 1
        res = []
        for t, local, dims in zip(out, locals_, grp.over):
            if dims:
                _track(t)
                _STATS["gathered_bytes"] += (t.numel() - local.numel()) \
                    * t.element_size()
                res.append(t)
            else:
                res.append(local.view_as(local))
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        grp = ctx.grp
        gs = []
        for k, g in enumerate(grads):
            pl, dims = grp.placements[k], grp.over[k]
            if g is None:
                shape = list(ctx.shapes[k])
                for i in dims:
                    shape[pl[i].dim] *= grp.sizes[i]
                g = torch.zeros(shape, dtype=ctx.dtypes[k],
                                device=ctx.device)
            g = _take_model_chunks(g / grp.n_rows, grp, pl, dims)
            gs.append(g.float())
        for i in range(grp.mesh.ndim):
            if grp.names[i] not in BATCH_AXES:
                continue
            which = [k for k, dims in enumerate(grp.over) if i in dims]
            if not which:
                continue
            _STATS["reduce_scatters"] += 1
            _STATS["reduce_scatter_bytes"] += sum(gs[k].numel() * 4
                                                  for k in which)
            got = reduce_scatter_cat(
                [gs[k] for k in which], grp.mesh.get_group(i),
                [grp.placements[k][i].dim for k in which])
            for k, t in zip(which, got):
                gs[k] = t
        return (None,) + tuple(g.to(dt) for g, dt in zip(gs, ctx.dtypes))


class ParamView:
    """A module's parameters as given tensors, in the module's attribute
    layout: its submodules as views, its parameters as the tensors
    (``tensors``: by name relative to ``module``); ``named_parameters``
    as ``nn.Module``'s."""

    def __init__(self, module: nn.Module, tensors: Dict[str, torch.Tensor]):
        self._own = list(module._parameters)
        self._children = [n for n, _ in module.named_children()]
        for n in self._own:
            setattr(self, n, tensors[n])
        for n, child in module.named_children():
            setattr(self, n, ParamView(child, {
                k[len(n) + 1:]: t for k, t in tensors.items()
                if k.startswith(n + ".")}))

    def named_parameters(self, prefix: str = ""
                         ) -> Iterator[Tuple[str, torch.Tensor]]:
        for n in self._own:
            yield prefix + n, getattr(self, n)
        for n in self._children:
            yield from getattr(self, n).named_parameters(prefix + n + ".")


class BlockHandle:
    """A block of a :class:`ShardedLM`: :meth:`gather` gathers its leaves
    now and returns them as a :class:`ParamView` of the block."""

    def __init__(self, owner: "ShardedLM", prefix: str, module: nn.Module):
        # a weak reference: no cycle keeps the owner's held leaves alive
        self._owner = weakref.ref(owner)
        self._prefix, self._module = prefix, module

    def gather(self) -> ParamView:
        return self._owner()._view(self._prefix, self._module)


class ShardedLM:
    """The model of DTensor shards ``sharded`` as a mesh step's functions
    see it (module docstring): ``leaves`` are the shards' local tensors
    in ``parameters()`` order (a train step's require grad: the
    gradients are theirs), ``plan`` says what each is gathered over,
    ``n_rows`` divides the gradients (the step's row shards)."""

    _HELD = ("shared",)

    def __init__(self, sharded: nn.Module, plan: GatherPlan,
                 leaves: Sequence[torch.Tensor], n_rows: int = 1):
        self.cfg = sharded.cfg
        self._sharded, self._plan, self._n_rows = sharded, plan, n_rows
        self._leaves = list(leaves)
        named = list(sharded.named_parameters())
        self._dt = dict(named)
        self._leaf = {n: t for (n, _), t in zip(named, self._leaves)}
        self._mesh = named[0][1].device_mesh
        self._held: Dict[str, object] = {}
        self.blocks = [BlockHandle(self, f"blocks.{i}", b)
                       for i, b in enumerate(sharded.blocks)]
        if hasattr(sharded, "enc_blocks"):
            self.enc_blocks = [BlockHandle(self, f"enc_blocks.{i}", b)
                               for i, b in enumerate(sharded.enc_blocks)]

    def parameters(self) -> Iterator[torch.Tensor]:
        return iter(self._leaves)

    def gather(self, names: Sequence[str]) -> List[torch.Tensor]:
        """The leaves ``names`` gathered now (one :class:`_Gather`). With
        no grad recorded (serving) they are returned as parameters, as the
        model's own leaves are: a matmul of a (B, 1, K) activation then
        folds to one GEMM in eager and fake modes alike (torch's fake
        matmul reads a size-1 dim's stride where eager does not)."""
        grp = _Group(self._mesh, [self._dt[n].placements for n in names],
                     [self._plan.over[n] for n in names], self._n_rows)
        got = _Gather.apply(grp, *[self._leaf[n] for n in names])
        if torch.is_grad_enabled():
            return list(got)
        return [nn.Parameter(t) for t in got]

    def _view(self, prefix: str, module: nn.Module) -> ParamView:
        rel = [n for n, _ in module.named_parameters()]
        got = self.gather([f"{prefix}.{n}" for n in rel])
        return ParamView(module, dict(zip(rel, got)))

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name == "head":
            return getattr(self, "lm_head" if "lm_head" in self._dt
                           else "embed")
        if name in self._held:
            return self._held[name]
        part = getattr(self._sharded, name)     # AttributeError if absent
        got = (self._view(name, part) if isinstance(part, nn.Module)
               else self.gather([name])[0])
        if name in self._HELD or (name == "embed"
                                  and self.cfg.tie_embeddings):
            self._held[name] = got
        return got
