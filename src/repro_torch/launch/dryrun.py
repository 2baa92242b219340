"""Dry run of one (arch × shape × mesh) cell under fake tensors (port of
``repro/launch/dryrun.py``).

JAX lowers and compiles each cell's step for a 256- or 512-chip mesh and
reads XLA's memory and cost analyses. The port RUNS the cell's step,
with no memory and no card:

* the mesh: this process is rank 0 of a ``fake`` process group
  (``torch.distributed``'s fake backend: collectives move nothing and
  return at once; ``core/transport.py``'s third branch) of
  ``make_production_mesh``'s 256 or 512 ranks, or of the debug mesh
  ``REPRO_DRYRUN_MESH`` names ("2x4"), as in JAX;
* the state: every tensor is a ``FakeTensorMode`` tensor of its real
  shape and dtype: ``input_specs``' batch, cache and extras, the
  parameters of a model sharded by ``shard_model`` / ``state_of``
  (JAX's ``param_specs``), the cache by ``init_mesh_cache``
  (``cache_specs``);
* the step: one train, prefill or decode step of ``launch/steps.py``
  (the mesh steps a real rank runs) under ``op_analysis.OpAnalysis``,
  which counts FLOPs, bytes and collectives as they dispatch.

Fake tensors take the port's device, ``cuda``, where torch is built for
CUDA. A CPU-only build makes fake CUDA tensors but cannot run ops on them
(the first op with a device guard raises "PyTorch is not linked with
support for cuda devices"), so there the cell fakes on the CPU; the JSON
records which. ``device.resolve_device`` is not asked for a card: nothing
real is allocated.

The cell JSON has JAX's keys, plus the port's ``top_collectives`` (the
largest collective sites), ``collective_sites`` (every call site that
posted a collective) and, with ``--peak-sites``, ``peak_sites``. Where
the port's step differs from JAX's GSPMD program (the leaves a rank's
split does not run on their 'model' chunk gathered whole, each block's
leaves gathered inside the block as a group), its ``notes`` say so; no
count is scaled.
``--attn-block`` is left out: JAX's dry run accepts it and never reads
it, and the port's model has no such knob.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import SHAPES
from ..models.lm import model as lm
from ..models.lm.config import ModelConfig
from ..pjit_utils import ambient_mesh, axis_sizes, local_nbytes, shard_shape
from . import shardings as SR
from .input_specs import input_specs, step_specs
from .op_analysis import OpAnalysis
from .steps import (cache_bytes, init_mesh_cache, make_decode_step,
                    make_prefill_step, make_train_step, named_leaves,
                    shard_model, state_bytes, state_of, step_batch_specs,
                    tree_leaves)

__all__ = ["Cell", "fake_device", "fake_mesh", "build_cell", "run_cell",
           "main"]


def fake_device() -> str:
    """``cuda`` where torch is built for CUDA, else ``cpu`` (module
    docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_mesh(shape, axes, device: str):
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group of as
    many ranks, this process rank 0 (the group is started once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_mesh

    n = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(f"a {dist.get_backend()} group of "
                               f"{dist.get_world_size()} is up; the dry run "
                               f"needs its own fake group of {n}")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_mesh(tuple(shape), tuple(axes), device=device)


@dataclasses.dataclass
class Cell:
    """One cell's step, built on fake tensors: :meth:`step` runs it once
    (the state or cache is donated: run it once). ``arguments``: per
    input tensor, its bytes on this rank and whether the step donates
    it; ``step_bytes``: the train state's int32 step, an int here."""
    arch: str
    shape: str
    kind: str
    cfg: ModelConfig
    mesh: Any
    device: str
    fake: Any
    run: Callable[[], Any]
    arguments: List[Tuple[torch.Tensor, int, bool]]
    step_bytes: int
    names: Dict[str, torch.Tensor]
    notes: List[str]

    def argument_bytes(self, oa: OpAnalysis) -> int:
        """This rank's bytes of the inputs the step read (JAX's jit
        keeps only the arguments its program reads)."""
        return self.step_bytes + sum(n for t, n, _ in self.arguments
                                     if oa.was_read(t))

    def alias_bytes(self, oa: OpAnalysis) -> int:
        """This rank's bytes of the donated inputs the step read."""
        return self.step_bytes + sum(n for t, n, donated in self.arguments
                                     if donated and oa.was_read(t))

    def step(self, analysis: Optional[OpAnalysis] = None):
        """The step's outputs, under the cell's fake mode (and
        ``analysis``, which counts it)."""
        with self.fake, contextlib.ExitStack() as stack:
            if self.mesh is not None:
                stack.enter_context(ambient_mesh(self.mesh))
            if analysis is not None:
                analysis.name(self.names)
                stack.enter_context(analysis)
            return self.run()


def _rows_bytes(x: torch.Tensor, spec, mesh) -> int:
    """A rank's bytes of the batch leaf ``x`` under ``spec``."""
    if mesh is None:
        return x.numel() * x.element_size()
    return int(np.prod(shard_shape(x.shape, spec, mesh))) * x.element_size()


def _fake(meta: torch.Tensor, device: str) -> torch.Tensor:
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def build_cell(arch: str, shape: str, mesh, *, microbatch: int = 1,
               fsdp: bool = True, device: Optional[str] = None,
               cfg: Optional[ModelConfig] = None,
               batch_size: Optional[int] = None,
               seq_len: Optional[int] = None) -> Cell:
    """The cell's step on fake tensors (the counterpart of JAX's
    ``build_lowered``). ``mesh``: a ``DeviceMesh`` of a fake group
    (:func:`fake_mesh`), or None for one rank's plain step. ``cfg`` /
    ``batch_size`` / ``seq_len`` replace the arch's config and the shape's
    global batch and length (a cut cell, as a one-card run takes it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = device or fake_device()
    spec = input_specs(arch, shape)
    cfg = cfg or spec["cfg"]
    kind = spec["kind"]
    B, S = batch_size or spec["B"], seq_len or spec["S"]
    spec = step_specs(cfg, B, S, kind)
    max_seq = S + 8 if cfg.family == "encdec" else 0
    notes = []
    if mesh is not None:
        notes.append(
            "the 'model' axis splits attention (heads, context or "
            "head_dim), the dense MLP, the embedding, the head and the CE, "
            "the residual stream between blocks (sequence-parallel), the "
            "MoE FFN (expert-parallel, ff-TP or the small experts' token "
            "slots) and the Mamba2 mixer (its heads, its conv channels)")
        notes.append(
            "each block's leaves are gathered inside the block, just before "
            "it runs (and again by its recompute in a train step), and "
            "freed after it: a rank's 'model' chunks of the split leaves "
            "over the batch axes, every other leaf whole; their gradients "
            "are reduce-scattered onto the rank's shards in float32. The "
            "non-block leaves are gathered at their use, a tied embedding "
            "and the hybrid's shared block once a step, held across their "
            "uses")
        notes.append("every rank is handed the whole batch and narrows it "
                     "to its rows; argument bytes count its rows")
    if device != "cuda":
        notes.append(f"fake tensors on {device}: this torch is not built "
                     f"for CUDA")
    bspec = step_batch_specs(cfg, kind, mesh, B) if mesh is not None else {}
    fake = FakeTensorMode()
    with fake:
        model = lm.LM(cfg, max_seq=max_seq, device=device, init=False)
        if kind == "train":
            state = state_of(model, mesh, fsdp)
            batch = {k: _fake(v, device) for k, v in spec["batch"].items()}
            step_fn = make_train_step(cfg, microbatch=microbatch, mesh=mesh)
            args = [(t, local_nbytes(t), True) for t in list(
                model.parameters()) + list(state.mu) + list(state.nu)]
            args += [(v, _rows_bytes(v, bspec.get(k), mesh), False)
                     for k, v in batch.items()]
            box = [state]

            def run():
                box[0], metrics = step_fn(box[0], batch)
                return box[0], metrics

            return Cell(arch, shape, kind, cfg, mesh, device, fake, run,
                        args, 4, dict(model.named_parameters()), notes)

        if mesh is not None:
            shard_model(model, mesh, fsdp)
            cache = init_mesh_cache(cfg, B, S, lm.lm_dtype(cfg), mesh,
                                    kind=kind, device=device)
            cspecs = tree_leaves(SR.cache_specs(cfg, mesh, batch_size=B,
                                                seq_len=S, kind=kind))
            if any("model" in str(sp) for sp in cspecs):
                notes.append(
                    "the cache is sharded over 'model' (heads, sequence or "
                    "head_dim): each rank reads and writes its own cache "
                    "shards in place")
        else:
            cache = lm.init_cache(cfg, B, S, lm.lm_dtype(cfg), device)
        names = {**dict(model.named_parameters()),
                 **dict(named_leaves(cache, "cache"))}
        extras = {k: _fake(v, device) for k, v in spec["extras"].items()}
        args = [(p, local_nbytes(p), False) for p in model.parameters()]
        args += [(t, local_nbytes(t), True) for t in tree_leaves(cache)]
        args += [(v, _rows_bytes(v, bspec.get(k), mesh), False)
                 for k, v in extras.items()]
        if kind == "prefill":
            tokens = _fake(spec["tokens"], device)
            step_fn = make_prefill_step(cfg, mesh=mesh)
            args.append((tokens, _rows_bytes(tokens, bspec.get("tokens"),
                                             mesh), False))

            def run():
                return step_fn(model, tokens, cache, extras)
        else:
            token = _fake(spec["token"], device)
            pos = _fake(spec["pos"], device)
            step_fn = make_decode_step(cfg, mesh=mesh)
            args += [(token, _rows_bytes(token, bspec.get("tokens"), mesh),
                      False), (pos, 4, False)]

            def run():
                return step_fn(model, token, cache, pos, extras)

    return Cell(arch, shape, kind, cfg, mesh, device, fake, run, args, 0,
                names, notes)


def output_bytes(cell: Cell, outputs) -> int:
    """A rank's bytes of the step's outputs: the state and its metrics, or
    its logits rows and the cache."""
    if cell.kind == "train":
        state, metrics = outputs
        return (state_bytes(state) + 4
                + sum(local_nbytes(v) for v in metrics.values()))
    logits, cache = outputs
    return local_nbytes(logits) + cache_bytes(cache)


def _mesh_from_env(multi_pod: bool, device: str):
    mesh_env = os.environ.get("REPRO_DRYRUN_MESH")  # e.g. "2x4" (debug)
    if mesh_env:
        dims = tuple(int(x) for x in mesh_env.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
        return fake_mesh(dims, axes, device), "debug-" + mesh_env
    if multi_pod:
        return (fake_mesh((2, 16, 16), ("pod", "data", "model"), device),
                "multipod-2x16x16")
    return fake_mesh((16, 16), ("data", "model"), device), "pod-16x16"


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_path: Optional[str] = None, *, microbatch: int = 1,
             fsdp: bool = True, peak_sites: bool = False) -> Dict[str, Any]:
    """Build and count one cell, JAX's cell JSON written to ``out_path``;
    ``peak_sites`` adds ``peak_sites``: what was alive at the temp's peak,
    by op and site (``OpAnalysis.peak_sites``; slower)."""
    device = fake_device()
    mesh, mesh_label = _mesh_from_env(multi_pod, device)
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, microbatch=microbatch, fsdp=fsdp,
                      device=device)
    t_lower = time.time() - t0
    oa = OpAnalysis(peak_sites=peak_sites)
    outputs = cell.step(oa)
    t_compile = time.time() - t0 - t_lower
    tripaware = oa.analyze()
    cfg, kind = cell.cfg, cell.kind
    mem = {"argument_size_in_bytes": cell.argument_bytes(oa),
           "output_size_in_bytes": output_bytes(cell, outputs),
           "alias_size_in_bytes": cell.alias_bytes(oa),
           "temp_size_in_bytes": int(tripaware["peak_live_bytes"])}
    cost = {"flops": tripaware["flops_hlo"],
            "bytes accessed": tripaware["hbm_bytes_est"]}
    coll = dict(tripaware["collective_bytes"])
    coll["total"] = tripaware["collective_total"]
    coll["op_counts"] = tripaware["collective_counts"]
    sh = SHAPES[shape]
    tokens_global = sh["global_batch"] * (sh["seq_len"] if kind != "decode"
                                          else 1)
    result = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": mesh_label,
        "mesh_shape": list(axis_sizes(mesh).values()),
        "n_chips": mesh.size(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens_global": tokens_global,
        "memory_analysis": mem,
        "cost_analysis": cost,
        "collective_bytes": coll,
        "tripaware": tripaware,
        "top_collectives": oa.top_collectives(),
        "collective_sites": sorted({r["site"]
                                    for r in oa.top_collectives(None)}),
        **({"peak_sites": oa.peak_sites(20)} if peak_sites else {}),
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "microbatch": microbatch,
        "fsdp": fsdp,
        "device": device,
        "package": "repro_torch",
        "notes": cell.notes,
        "ok": True,
    }
    print(f"[dryrun] {arch} × {shape} × {mesh_label}: "
          f"flops/dev={tripaware['flops_hlo']:.3e} "
          f"coll/dev={tripaware['collective_total']:.3e} "
          f"build={t_lower:.0f}s run={t_compile:.0f}s")
    print("memory_analysis:", json.dumps(mem))
    print("cost_analysis:", cost)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="fake-tensor dry run of one "
                                             "(arch × shape × mesh) cell")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--peak-sites", action="store_true",
                    help="record what is alive at the temp's peak, by op "
                         "and site (slower)")
    args = ap.parse_args(argv)
    run_cell(args.arch, args.shape, args.multi_pod, args.out,
             microbatch=args.microbatch, fsdp=not args.no_fsdp,
             peak_sites=args.peak_sites)


if __name__ == "__main__":
    main()
