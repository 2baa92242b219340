"""Run the full dry-run grid: every live (arch × shape) cell × both meshes
(port of ``repro/launch/dryrun_all.py``).

Each cell runs in a fresh subprocess (``python -m
repro_torch.launch.dryrun``: its own fake process group, its memory
reclaimed). Results are cached as JSON under ``experiments/dryrun_torch/``
(``REPRO_DRYRUN_OUT``), apart from the JAX package's cells; re-runs skip
completed cells, and a failed or timed-out cell leaves an error JSON with
its stderr's tail.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--only arch]
       [--mesh pod|multipod|both] [--timeout S]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..configs import cells

OUT_DIR = os.environ.get("REPRO_DRYRUN_OUT",
                         os.path.join("experiments", "dryrun_torch"))


def cell_path(arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "multipod" if multi_pod else "pod"
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh}.json")


def cell_done(path: str) -> bool:
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return json.load(f).get("ok", False)
    except (OSError, ValueError):
        return False


def run_one(arch: str, shape: str, multi_pod: bool,
            timeout: int = 3600) -> bool:
    path = cell_path(arch, shape, multi_pod)
    if cell_done(path):
        print(f"[skip] {os.path.basename(path)}")
        return True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", path]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env.pop("REPRO_DRYRUN_MESH", None)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, timeout=timeout,
                              capture_output=True, text=True)
        ok = proc.returncode == 0 and cell_done(path)
    except subprocess.TimeoutExpired:
        ok = False
        proc = None
    dt = time.time() - t0
    status = "ok" if ok else "FAIL"
    print(f"[{status}] {os.path.basename(path)} ({dt:.0f}s)")
    if not ok:
        err = {"arch": arch, "shape": shape,
               "mesh": "multipod" if multi_pod else "pod", "ok": False,
               "stderr": (proc.stderr[-4000:] if proc else "timeout")}
        with open(path, "w") as f:
            json.dump(err, f, indent=1)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="restrict to one arch")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    os.makedirs(OUT_DIR, exist_ok=True)
    todo = [(a, s) for a, s in cells()
            if args.only is None or a == args.only]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    for arch, shape in todo:
        for mp in meshes:
            if run_one(arch, shape, mp, timeout=args.timeout):
                n_ok += 1
            else:
                n_fail += 1
    print(f"done: {n_ok} ok, {n_fail} failed")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
