"""Atomic checkpointing with corruption recovery (port of
``repro/checkpoint/manager.py``), in the JAX package's on-disk layout:

    <dir>/step_<N>/
        manifest.json       {leaves: {name: {file, crc32, shape, dtype}},
                             "complete": true}
        <leaf>.npy ...

* atomicity — written to ``step_<N>.tmp`` then renamed;
* integrity — a CRC32 over each leaf file's bytes, checked on restore; a
  corrupt or incomplete step is skipped for the previous good one;
* either package restores the other's checkpoint: leaf names follow
  JAX's ``_leaf_name`` (dict key, sequence index, NamedTuple field, joined
  by ``.``), and a bfloat16 leaf is written as JAX writes it (``.npy``
  descr ``<V2``, manifest dtype ``"bfloat16"``) and read by the
  manifest's dtype (the 2-byte words viewed as ``torch.bfloat16``).

A tree is nested dicts, lists, tuples and NamedTuples of tensors (or numpy
arrays); ``None`` is an empty subtree, as in JAX.

On a process mesh (leaves that are ``DTensor`` shards, ``launch/steps``'s
mesh state) every rank calls :meth:`CheckpointManager.save`: each leaf is
gathered whole (``pjit_utils.full_tensors``), rank 0 writes JAX's layout
and renames the temporary directory, and a barrier closes the save — the
layout is mesh-independent, as JAX's is. ``restore_latest(template,
mesh=, shardings=)`` gives each rank its own slice of every leaf as a
``DTensor`` with the leaf's placements over ``mesh`` (elastic re-shard:
any mesh restores any checkpoint); the ranks agree on each step's
verdict, so skipping a corrupt step never splits them. Every rank reads
the same directory.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.transport import all_reduce_sum
from ..pjit_utils import mesh_group

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16 = "bfloat16"


def _flatten(tree: Any, path: Tuple[str, ...] = (), is_leaf=None):
    """(name, leaf) pairs in JAX's flattening order (dict keys sorted);
    a subtree that ``is_leaf`` accepts is one leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [(".".join(path) or "leaf", tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(".".join(path) or "leaf", tree)]
    return [leaf for k, v in items
            for leaf in _flatten(v, path + (k,), is_leaf)]


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _write_leaf(path: str, leaf) -> Tuple[list, str]:
    """Write ``leaf`` as ``.npy``; returns (shape, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": "<V2", "fortran_order": False,
                    "shape": tuple(words.shape)})
                f.write(words.tobytes())
            return list(words.shape), _BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def save_pytree(tree: Any, out_dir: str, *, write: bool = True) -> None:
    """Write one tree to ``out_dir`` (not atomic by itself). A ``DTensor``
    leaf is gathered whole first, a collective over its mesh: every rank
    calls this, and only the one with ``write`` writes."""
    from ..pjit_utils import full_tensors

    if write:
        os.makedirs(out_dir, exist_ok=True)
    manifest = {"leaves": {}, "complete": False}
    for name, leaf in _flatten(tree):
        if _is_dtensor(leaf):
            leaf = full_tensors([leaf])[0]
        if not write:
            continue
        fn = name + ".npy"
        shape, dtype = _write_leaf(os.path.join(out_dir, fn), leaf)
        with open(os.path.join(out_dir, fn), "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"][name] = {"file": fn, "crc32": crc,
                                    "shape": shape, "dtype": dtype}
    if not write:
        return
    manifest["complete"] = True
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _read_leaf(fp: str, dtype: str) -> torch.Tensor:
    arr = np.load(fp)
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return x is None or (isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x))


def load_pytree(template: Any, in_dir: str, *, device=None, mesh=None,
                shardings: Any = None) -> Any:
    """Load into the structure of ``template``, verifying CRCs and shapes;
    each leaf takes its template leaf's dtype and device (or ``device``).

    ``shardings``: a matching tree of DTensor placements over ``mesh``
    (``None`` for a leaf restored whole): each rank keeps its slice of
    such a leaf as a ``DTensor``."""
    from ..pjit_utils import local_shard, to_dtensor

    with open(os.path.join(in_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise IOError("incomplete checkpoint")
    leaves = _flatten(template)
    places = ([pl for _, pl in _flatten(shardings, is_leaf=_is_placements)]
              if shardings is not None else [None] * len(leaves))
    if len(places) != len(leaves):
        raise ValueError(f"{len(places)} shardings for {len(leaves)} leaves")
    out = []
    for (name, leaf), pl in zip(leaves, places):
        ent = manifest["leaves"].get(name)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        fp = os.path.join(in_dir, ent["file"])
        with open(fp, "rb") as f:
            if zlib.crc32(f.read()) != ent["crc32"]:
                raise IOError(f"CRC mismatch for {name}")
        t = _read_leaf(fp, ent["dtype"])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(t.shape)} vs {want}")
        if pl is not None:
            local = local_shard(t, mesh, pl).to(
                device=device or leaf.device, dtype=leaf.dtype).contiguous()
            t = to_dtensor(local, mesh, pl, t.shape)
        elif isinstance(leaf, torch.Tensor):
            t = t.to(device=device or leaf.device, dtype=leaf.dtype)
        elif device is not None:
            t = t.to(device)
        out.append(t)
    return _unflatten(template, iter(out))


class CheckpointManager:
    """Latest-good discovery + atomic save + bounded retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, state: Any, step: int) -> str:
        """Write ``state`` as ``step``. With DTensor leaves, every rank of
        their mesh calls this; rank 0 writes."""
        import torch.distributed as dist

        mesh = next((leaf.device_mesh for _, leaf in _flatten(state)
                     if _is_dtensor(leaf)), None)
        write = mesh is None or dist.get_rank() == 0
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if write and os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(state, tmp, write=write)
        if write:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        if mesh is not None:
            dist.barrier(group=mesh_group(mesh))
        return final

    def restore_latest(self, template: Any, mesh=None, shardings=None,
                       device=None) -> Optional[Tuple[Any, int]]:
        """Try newest -> oldest; skip corrupt / incomplete checkpoints.
        Leaves go to their template leaf's device (or ``device``); with
        ``shardings`` over the process ``mesh`` each rank keeps its
        slices, and a step is taken only if every rank read it."""
        for step in reversed(self.steps()):
            path = os.path.join(self.dir, f"step_{step}")
            try:
                got, err = load_pytree(template, path, device=device,
                                       mesh=mesh, shardings=shardings), None
            except Exception as e:   # any unreadable step: try the older
                got, err = None, e
            if mesh is not None:
                bad = all_reduce_sum([torch.tensor(
                    [float(err is not None)], device=mesh.device_type)],
                    mesh_group(mesh))[0]
                if err is None and bad.item():
                    err = "another rank could not read it"
            if err is None:
                return got, step
            print(f"[ckpt] step_{step} unusable ({err}); trying older")
        return None

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
