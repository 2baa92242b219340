"""The cell runner: finds a cell's files by name, runs its mode's set-up,
the measured window (or, with ``--trace 1``, the traced window), reads
the peak, frees the program, has the mode compare its outputs with the
plain reference, and prints the result line.

A mode (``modes/<mode>.py``) has ``setup(ctx) -> state``, where
``state.unit()`` runs one unit of the timed work (a training step ending
in the loss read, a refresh) and returns a dict of host timings of its
parts; ``end_to_end(ctx, state, window) -> {metric: value}``;
``model_flops(ctx) -> float`` for one unit; and ``check(ctx, state) ->
{name: number}``, the numbers compared with the workload's limits.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path, name: str):
    """A module from a file path (names may hold dots, as metric names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Cell:
    """One cell's entry in BENCHMARK.json with its workload and config
    files, under ``root`` (the checkout) and ``bench`` (the folder)."""

    def __init__(self, name: str, root: Path = ROOT, bench: Path = HERE):
        self.root, self.bench = Path(root), Path(bench)
        spec = load_json(self.root / "BENCHMARK.json")
        entries = [w for w in spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.entry, self.name = spec, entries[0], name
        self.workload = load_json(self.bench / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} is {self.workload[key]!r} "
                                 f"in its file, {self.entry[key]!r} in "
                                 f"BENCHMARK.json")
        self.config = load_json(self.bench / "configs"
                                / f"{self.entry['config']}.json")
        self.mode = load_file_module(
            self.bench / "modes" / f"{self.workload['mode']}.py",
            f"gnnbench_mode_{self.workload['mode']}")

    def metrics(self, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable:
        return load_file_module(reader_path(self.bench, metric),
                                f"gnnbench_metric_{metric}").read


def reader_path(bench: Path, metric: str) -> Path:
    """``metrics/<metric>.py``, else the reader of the name without its
    last ``.<suffix>`` (``mfu.train`` and ``mfu.refresh`` share
    ``mfu.py``)."""
    path = Path(bench) / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
    return path


class Context:
    """What a mode sees: the cell, the seed, the device and the log."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool,
                 seconds: float):
        self.cell, self.seed, self.trace = cell, int(seed), bool(trace)
        self.seconds = float(seconds)
        self.config, self.params = cell.config, cell.workload["params"]
        self.device = device
        self.log = log
        self.info: Dict = {}

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def run_window(unit: Callable, seconds: float) -> Dict:
    """``unit()`` back to back until ``seconds`` have passed; each unit
    ends in a host wait for its result, so the clock spans the work."""
    times, parts = [], []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        parts.append(unit())
        times.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= seconds:
            break
    return {"count": len(times), "wall_s": time.perf_counter() - t0,
            "unit_s": times, "parts": parts}


def window_quantiles(window: Dict) -> Dict[str, List[float]]:
    """p10 / p50 / p90 of the units' milliseconds and of each host-timed
    part, for the log."""
    series = {"unit_ms": [t * 1e3 for t in window["unit_s"]]}
    for p in window["parts"]:
        for k, v in p.items():
            series.setdefault(k, []).append(v)
    out = {}
    for k, v in series.items():
        q = (statistics.quantiles(v, n=10) if len(v) > 1 else v * 9)
        out[k] = [round(q[0], 3), round(statistics.median(v), 3),
                  round(q[-1], 3)]
    return out


def compare(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): each number at or under its
    limit; a missing or non-finite number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Path = ROOT, bench: Path = HERE) -> Dict:
    """One run of cell ``name``; returns the result line's object."""
    import torch

    from . import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root, bench)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell, seed, dev, trace, seconds)
    if dev.type == "cuda":
        ctx.info["device"] = torch.cuda.get_device_name(dev)
        log(f"device {ctx.info['device']}; nvidia-smi: {power_limit()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}; cell {name} seed {seed}")

    state = cell.mode.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}; graph_build_s "
        + json.dumps(ctx.info.get("graph_build_s", {})))
    obs: Dict = {"graph_build_s": ctx.info.get("graph_build_s", {})}
    if trace:
        obs.update(tracing.traced_window(ctx, state))
        e2e = {}
    else:
        window = run_window(state.unit, seconds)
        e2e = cell.mode.end_to_end(ctx, state, window)
        log(f"window: {window['count']} units in {window['wall_s']:.3f} s; "
            + "; ".join(f"{k} p10/p50/p90 {v}" for k, v in
                        window_quantiles(window).items()))
    ctx.sync()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    attempted, failed = state.attempted, state.failed
    t_check = time.perf_counter()
    numbers = cell.mode.check(ctx, state)
    del state
    log(f"check took {time.perf_counter() - t_check:.3f} s; run "
        f"{time.perf_counter() - t_start:.3f} s")
    ok, checks = compare(numbers, cell.workload["limits"])

    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.metrics("per_layer"):
            v = cell.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(e2e, setup_s=setup_s, peak_gib=peak / GIB)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_obj = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": ctx.info.get("device", str(dev)),
                  "count": int(cell.entry["chips"]),
                  "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_obj}
    if trace:
        device_obj["busy_s"] = obs["trace"]["busy_s"]
        device_obj["window_s"] = obs["trace"]["window_s"]
        result["breakdown"] = {"device_ops": obs["trace"]["device_ops"],
                               "idle_gaps": obs["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be ≥ 0")

    import torch

    cell = Cell(args.workload)
    want = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        log(f"{args.workload} needs {want} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=t_start)
    found = forbidden_modules()
    if found:     # what the port loaded in this process, window included
        log(f"forbidden modules loaded: {found}; no result")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def checkout_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths, so only a cell's first run builds."""
    cache = Path(root) / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def kernel_names(csrc: Path) -> Dict[str, List[str]]:
    """The ``__global__`` functions of each of the port's CUDA sources,
    by source stem (the stem is the kernel wrapper's name)."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(\w+)\s*\(")
    return {p.stem: pat.findall(p.read_text())
            for p in sorted(Path(csrc).glob("*.cu"))}
