"""The readings that set a cell's limits, one process for many seeds:

    python3 gnnbench/control.py --workload <cell> --seeds 11 12 13 ...

For each seed the cell's set-up runs (the program's first steps or
refreshes, as a run's), then the mode's ``control`` compares, against the
fp32 reference, the program's outputs (the lower readings), the control
— the reference in TF32, the precision below the configuration's — and
the mode's planted faults (the upper readings). One JSON line a seed;
the last line holds each number's largest program reading and smallest
control and fault readings.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(name: str, seeds, device: str = "cuda", root=None,
             bench=None, seconds: float = 10.0):
    import torch

    from gnnbench.harness import ROOT as R, HERE, Cell, Context

    rows = []
    for seed in seeds:
        cell = Cell(name, root or R, bench or HERE)
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx = Context(cell, seed, torch.device(device), False, seconds)
        state = cell.mode.setup(ctx)
        row = {"seed": seed, **cell.mode.control(ctx, state)}
        del state
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def summary(rows):
    """Per number: the largest program reading, the smallest reading of
    each control and fault."""
    out = {}
    for kind in rows[0]:
        if kind == "seed":
            continue
        for num in rows[0][kind]:
            vals = [r[kind][num] for r in rows]
            key = "max" if kind == "program" else "min"
            out.setdefault(num, {})[f"{kind}_{key}"] = (
                max(vals) if kind == "program" else min(vals))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    from gnnbench.harness import checkout_dirs
    checkout_dirs()
    import torch
    if not torch.cuda.is_available():
        sys.exit("control readings need the card")
    rows = readings(args.workload, args.seeds)
    print(json.dumps({"summary": summary(rows)}), flush=True)
