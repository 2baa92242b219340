"""LM training launcher with checkpoint / auto-resume (port of
``repro/launch/train.py``), on one card or, with ``--mesh``, over a
``torch.distributed`` process mesh.

The loop restores the latest good checkpoint, if any, and continues. Data
is the JAX launcher's deterministic synthetic token stream keyed by
(seed, step) — the same numpy draws, so both packages train on the same
batches — and restarts replay identically with no sampler state.

Usage (on the card; ``--device cpu`` runs on the host):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_3b \\
      --smoke --steps 50 --batch 4 --seq 128 --ckpt-dir /tmp/ckpt

``--mesh DxM`` (or ``PxDxM``; axes ``("pod", "data", "model")``, as
JAX's) runs every rank of a process mesh of that many ranks, e.g.
  torchrun --nproc-per-node=8 -m repro_torch.launch.train --arch \\
      llama3p2_3b --smoke --mesh 2x4 --ckpt-dir /tmp/ckpt
Each rank holds its shards of the state (``launch/steps.py``); a resume
restores the latest checkpoint onto this mesh, whatever mesh wrote it.
A rank joins the default group from ``torchrun``'s environment when the
caller has not initialised it.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, resolve_device, synchronize
from ..models.lm.config import ModelConfig
from ..pjit_utils import ambient_mesh
from .mesh import make_mesh
from .steps import (eval_param_shapes, init_state, load_state_tree,
                    make_train_step, state_placements, state_tree)

__all__ = ["synthetic_batch", "main"]


def synthetic_batch(cfg: ModelConfig, step: int, B: int, S: int,
                    seed: int = 0, device: DeviceLike = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """JAX's deterministic synthetic batch (``seed·1_000_003 + step``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed * 1_000_003 + step)

    def ints(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                               dtype=torch.int32, device=dev)

    batch = {"tokens": ints((B, S)), "labels": ints((B, S))}
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
        batch["frames"] = torch.as_tensor(frames, device=dev).to(
            torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    if cfg.family == "vlm":
        batch["positions"] = torch.arange(S, dtype=torch.int32,
                                          device=dev).expand(3, B, S)
    return batch


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI on ``argv``; returns the run's per-step losses, grad
    norms and times (s) and the step it started from."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4: a process mesh of that many ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train every step on step 0's batch")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        _join_torchrun(dev)
        mesh = make_mesh(dims, ("pod", "data", "model")[-len(dims):],
                         device=dev)
    train_step = make_train_step(cfg, lr=args.lr, mesh=mesh)
    max_seq = args.seq + 8 if cfg.family == "encdec" else 0
    state = init_state(cfg, seed=args.seed, max_seq=max_seq, device=dev,
                       mesh=mesh)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        shardings = (None if mesh is None else state_placements(
            eval_param_shapes(cfg, max_seq), cfg, mesh))
        restored = mgr.restore_latest(state_tree(state), mesh=mesh,
                                      shardings=shardings)
        if restored is not None:
            tree, start_step = restored
            state = load_state_tree(state, tree)
            print(f"[train] resumed from step {start_step}")

    t_hist, losses, gnorms = [], [], []
    with ambient_mesh(mesh):
        for step in range(start_step, args.steps):
            batch = synthetic_batch(cfg, 0 if args.fixed_batch else step,
                                    args.batch, args.seq, args.seed, dev)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            synchronize(dev)
            t_hist.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"gnorm={gnorms[-1]:.3f} dt={t_hist[-1]*1e3:.0f}ms")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(state_tree(state), step + 1)
                print(f"[train] checkpoint @ {step + 1}")
    if mgr:
        mgr.save(state_tree(state), args.steps)
    med = float(np.median(t_hist)) if t_hist else float("nan")
    print(f"[train] done. median step time {med*1e3:.1f} ms")
    return {"arch": cfg.name, "start_step": start_step, "losses": losses,
            "grad_norms": gnorms, "step_s": t_hist}


def _join_torchrun(dev) -> None:
    """Join the default group from ``torchrun``'s environment, when the
    caller has not initialised one (``gloo`` on the CPU, ``nccl`` on the
    card); otherwise ``make_mesh`` says how to start the ranks."""
    import torch.distributed as dist

    if dist.is_initialized() or "RANK" not in os.environ:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


if __name__ == "__main__":
    main()
