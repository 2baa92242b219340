"""Mesh construction over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

Functions, not module constants, so importing touches no process group.
Each needs ``torch.distributed.init_process_group`` to have run in every
rank first (its address, world size and rank given by the caller, or by
``torchrun``); ranks past the mesh's size may exist and stay out of it.

* :func:`make_shard_mesh` — the 1-D process group of partitioned-graph
  (ring) execution, ``mesh=`` of ``core/partition.py`` and the trainers.
* :func:`make_mesh` / :func:`make_production_mesh` — a ``DeviceMesh`` of
  named axes; the production shapes are the JAX package's single pod
  (data=16, model=16) and two pods (pod=2, data=16, model=16).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_shard_mesh", "make_mesh"]


def _check_ranks(n: int, what: str) -> None:
    """Raise unless the default group has at least ``n`` ranks."""
    import torch.distributed as dist

    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)
    if have < n:
        raise RuntimeError(
            f"{what} needs {n} ranks, have {have} — start {n} processes "
            f"(torchrun --nproc-per-node={n}, or torch.multiprocessing.spawn "
            f"with nprocs={n}) and call torch.distributed."
            f"init_process_group(backend, init_method=..., world_size={n}, "
            f"rank=...) in each BEFORE building the mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda"):
    """The production ``DeviceMesh``: (data=16, model=16) over 256 ranks,
    or (pod=2, data=16, model=16) over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_shard_mesh(n_shards: int, axis: str = "data"):
    """The 1-D mesh of partitioned-graph (ring) execution: a process group
    over the first ``n_shards`` ranks (the default group itself when it
    has exactly that many). Collective: every rank of the default group
    calls it, also one left out. ``axis`` names the ring axis, as in
    JAX's signature."""
    import torch.distributed as dist

    _check_ranks(n_shards, f"shard mesh ({n_shards},) on axis {axis!r}")
    if dist.get_world_size() == n_shards:
        return dist.group.WORLD
    return dist.new_group(list(range(n_shards)))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: DeviceLike = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    first ``prod(shape)`` ranks of the default group (more ranks may
    exist, as JAX's tolerates more host devices), on ``device``'s type."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    _check_ranks(n, f"mesh {tuple(shape)}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
