"""Ambient-mesh sharding hints and shard records (port of
``repro/pjit_utils.py``).

Model code calls ``shard_hint(x, "data", None, "model")`` with LOGICAL
axis names; "data" expands to ("pod", "data") on multi-pod meshes. A
mesh is either

* a ``torch.distributed`` ``DeviceMesh`` (a *process mesh*: one rank per
  mesh point, each holding its share of the batch and of the state), or
* a :class:`MeshShape`, axis names and sizes only: no process, no group.
  The spec logic (``launch/shardings.py``) and the MoE's mesh-aligned
  token blocks read only names and sizes, so under ``ambient_mesh(
  MeshShape((2, 4)))`` one process computes the whole batch with JAX's
  mesh semantics — the reference a process mesh is held to.

``shard_hint`` is the identity on a plain tensor (every tensor of the
mesh steps is one: a rank runs its share of the work on plain local
tensors, and the model axis's compute split, ``models/lm/tp.py``, moves
the activations at JAX's hint sites itself); on a ``DTensor`` it
redistributes to the spec's placements, which changes no value.
:func:`axis_index` and :func:`owned_chunk` give a rank its coordinate on
an axis and the block of a dim it owns there. A spec is JAX's ``PartitionSpec`` as
a tuple: per dim ``None``, an axis name, or a tuple of names.

A sharded leaf is recorded as a ``DTensor`` (``from_local`` /
``to_local``); its bytes move through ``core/transport.py``
(:func:`full_tensors`), never through DTensor's own collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["MeshShape", "axis_sizes", "is_process_mesh", "mesh_group",
           "current_mesh", "ambient_mesh", "resolve_axis", "make_spec",
           "shard_hint", "to_placements", "shard_shape", "local_shard",
           "local_nbytes", "to_dtensor", "full_tensors", "gather_shards",
           "axis_index", "owned_chunk", "BATCH_AXES"]

BATCH_AXES = ("pod", "data")

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process behind it; the
    names default to ``("pod", "data", "model")[-len(shape):]``, as the
    train CLI's ``--mesh``."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ()

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        names = tuple(self.axis_names) or ("pod", "data", "model")[
            -len(shape):]
        if len(names) != len(shape):
            raise ValueError(f"mesh shape {shape} against axes {names}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)


def is_process_mesh(mesh) -> bool:
    """Is ``mesh`` a ``DeviceMesh`` (one rank per point)?"""
    return mesh is not None and not isinstance(mesh, MeshShape)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order (JAX's ``mesh.shape``)."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_group(mesh):
    """The process group of every rank of the process mesh ``mesh``: the
    default group, which the mesh must span (``make_mesh`` over all
    ranks)."""
    import torch.distributed as dist

    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the LM mesh step needs a mesh over every rank of "
                         f"the default group: mesh of {mesh.size()}, world "
                         f"of {dist.get_world_size()}")
    return dist.group.WORLD


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on the process mesh's axis ``name``."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(name)])


def owned_chunk(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``(start, size)`` of block ``index`` of a dim of ``n`` cut into
    ``parts`` blocks of ``ceil(n / parts)`` (the last ones shorter when
    ``parts`` does not divide ``n``): the block a rank at ``index`` on an
    axis of ``parts`` owns. Where ``parts`` divides ``n`` it is the chunk
    ``local_shard`` takes."""
    size = -(-n // parts)
    start = min(n, index * size)
    return start, min(n, start + size) - start


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def ambient_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def resolve_axis(mesh, name):
    """Logical -> physical axes: 'data' covers ('pod','data') if present.

    Accepts a tuple of logical names for multi-axis dims (flattened)."""
    if name is None:
        return None
    if isinstance(name, tuple):
        flat = []
        for n in name:
            r = resolve_axis(mesh, n)
            if isinstance(r, tuple):
                flat.extend(r)
            elif r is not None:
                flat.append(r)
        return tuple(flat)
    if name == "data" and "pod" in axis_sizes(mesh):
        return ("pod", "data")
    return name


def make_spec(mesh, *axes) -> tuple:
    return tuple(resolve_axis(mesh, a) for a in axes)


def shard_hint(x, *axes):
    """JAX's ``with_sharding_constraint`` at a model site: the identity
    with no ambient mesh or on a plain tensor; a ``DTensor`` is
    redistributed to the spec's placements (its values unchanged)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(
        make_spec(mesh, *axes), mesh))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if its axis appears in dim ``d``'s entry, else
    ``Replicate()``. A dim sharded over several axes is chunked in MESH
    order (the first mesh dim outermost), whatever order its entry names
    them in: the shard shapes are JAX's, the rank holding a chunk may
    not be."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {a: d for d, entry in enumerate(spec) for a in _axes_of(entry)}
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in axis_sizes(mesh))


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """One rank's shape of a leaf of ``shape`` under ``spec`` (JAX's
    ``NamedSharding(mesh, spec).shard_shape``; the rules only pick specs
    whose axes divide their dims)."""
    sizes = axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        k = 1
        for a in _axes_of(spec[d] if d < len(spec) else None):
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {spec[d]!r}")
        out.append(n // k)
    return tuple(out)


def _chunks(mesh, placements) -> Dict[int, Tuple[int, int]]:
    """{tensor dim: (chunk index, chunk count)} of this rank's shard:
    the mesh dims sharding a tensor dim nest in mesh order."""
    coord = mesh.get_coordinate()
    out: Dict[int, Tuple[int, int]] = {}
    for i, p in enumerate(placements):
        if p.is_shard():
            idx, cnt = out.get(p.dim, (0, 1))
            n = int(mesh.shape[i])
            out[p.dim] = (idx * n + coord[i], cnt * n)
    return out


def local_nbytes(t: torch.Tensor) -> int:
    """The bytes this rank holds of ``t``: a DTensor's local shard, a
    plain tensor whole."""
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.numel() * t.element_size()


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of ``full`` (a view) under ``placements``."""
    t = full
    for d, (idx, cnt) in _chunks(mesh, placements).items():
        n = full.shape[d] // cnt
        t = t.narrow(d, idx * n, n)
    return t


def to_dtensor(local: torch.Tensor, mesh, placements,
               shape: Sequence[int]):
    """The ``DTensor`` of global ``shape`` whose shard on this rank is
    ``local``; no communication."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def full_tensors(dts: Sequence) -> List[torch.Tensor]:
    """Each ``DTensor`` of ``dts`` whole, on every rank
    (:func:`gather_shards` over every mesh dim). A leaf with nothing to
    gather comes back as its local tensor itself. The leaves share one
    mesh; every rank calls this with the same leaves."""
    if not dts:
        return []
    mesh = dts[0].device_mesh
    return gather_shards([dt.to_local() for dt in dts],
                         [dt.placements for dt in dts], mesh,
                         [range(mesh.ndim)] * len(dts))


def gather_shards(locals_: Sequence[torch.Tensor], placements: Sequence,
                  mesh, over: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """:func:`full_tensors` of local shards: ``locals_[k]`` (this rank's
    shard under ``placements[k]``) gathered over the mesh dims
    ``over[k]`` (indices): per mesh dim, innermost first, one
    ``transport.all_gather_cat`` over that dim's sub-group carries every
    leaf gathered there, so a tensor dim sharded over several mesh dims
    comes back in mesh order. A leaf with nothing to gather comes back as
    itself. Every rank calls this with the same leaves."""
    from .core.transport import all_gather_cat

    out = list(locals_)
    for i in reversed(range(mesh.ndim)):
        which = [k for k, pl in enumerate(placements)
                 if i in over[k] and pl[i].is_shard()]
        if not which:
            continue
        got = all_gather_cat([out[k] for k in which], mesh.get_group(i),
                             [placements[k][i].dim for k in which])
        for k, t in zip(which, got):
            out[k] = t
    return out
