"""The traced window of a ``--trace 1`` run, and what it reads.

1. One unit with the port's kernel wrappers watched by
   ``sys.monitoring`` (every thread, autograd's too): each call's
   operand shapes, described by ``costs/<kernel>.py``. Nothing of the
   program is changed.
2. A few units timed by the host clock, for the host-side part metrics.
3. ``K`` units under ``torch.profiler`` (after one warm-up unit inside
   the profiler), inside a ``gnnbench.window`` annotation whose interval
   is the traced window; the port's launch counters are read around them.

The trace gives the device's busy time (the union of kernel, copy and
set intervals in the window), device time by operation, the port's
kernels' device time by source, and the idle gaps by what the host was
doing.
"""
from __future__ import annotations

import json
import math
import pkgutil
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from .harness import kernel_names, load_file_module

__all__ = ["port_kernels", "launch_counters", "capture_calls",
           "traced_window", "summarize_trace", "base_name"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "gnnbench.window"
HOST_UNITS = 5          # units timed by the host clock (step 2)
TRACE_SECONDS = 2.0     # the profiled units' aim, from set-up's unit time
TRACE_UNITS = (3, 40)   # least and most profiled units (step 3)


def port_kernels() -> Dict[str, List[str]]:
    """The port's kernel sources by stem, each with its device functions."""
    import repro_torch.kernels as k
    return kernel_names(Path(k.__file__).resolve().parent / "csrc")


def launch_counters() -> Dict[str, Callable]:
    """The port's kernel wrappers that count launches, by name."""
    import importlib

    import repro_torch.kernels as k
    stems = set(port_kernels())
    found = {}
    for info in pkgutil.iter_modules(k.__path__):
        if not info.ispkg:
            continue
        try:
            mod = importlib.import_module(f"repro_torch.kernels.{info.name}"
                                          f".ops")
        except ModuleNotFoundError:
            continue
        for stem in stems:
            fn = getattr(mod, stem, None)
            if fn is not None and hasattr(fn, "launches"):
                found[stem] = fn
    return found


def read_launches(fns: Dict[str, Callable]) -> Dict[str, int]:
    return {name: int(fn.launches) for name, fn in fns.items()}


def capture_calls(unit: Callable, fns: Dict[str, Callable],
                  describe: Dict[str, Callable]) -> Dict[str, List[Dict]]:
    """``unit()`` with every call of ``fns`` (watched by
    ``sys.monitoring`` on their code objects alone) described by
    ``describe[name](arguments)``."""
    mon = sys.monitoring
    tool = next(t for t in range(6) if mon.get_tool(t) is None)
    by_code = {fns[n].__code__: n for n in describe}
    calls: Dict[str, List[Dict]] = {n: [] for n in describe}

    def on_start(code, offset):
        name = by_code.get(code)
        if name is not None:
            calls[name].append(describe[name](dict(sys._getframe(1)
                                                   .f_locals)))

    mon.use_tool_id(tool, "gnnbench")
    try:
        mon.register_callback(tool, mon.events.PY_START, on_start)
        for code in by_code:
            mon.set_local_events(tool, code, mon.events.PY_START)
        unit()
    finally:
        for code in by_code:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.free_tool_id(tool)
    return calls


def base_name(name: str) -> str:
    """A device function's own name from a demangled kernel name."""
    s = name.replace("(anonymous namespace)", "anon")
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].split()[-1] if s.strip() else name


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize_trace(events: List[Dict], port: Dict[str, List[str]],
                    top: int = 10) -> Dict:
    """Busy, window and per-operation device seconds, the port's kernels'
    device seconds by source, and idle gaps by host activity, inside the
    ``gnnbench.window`` annotation of a Chrome trace's events."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace holds no gnnbench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_op = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
        if b <= a:
            continue
        dev.append((a, b))
        key = e["name"][:160]
        by_op[key] = by_op.get(key, 0.0) + (b - a) * 1e-6
    owner = {f: stem for stem, fs in port.items() for f in fs}
    port_s = {stem: 0.0 for stem in port}
    for name, s in by_op.items():
        stem = owner.get(base_name(name))
        if stem is not None:
            port_s[stem] += s
    busy = _merge(dev)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(cover, key=lambda h: h[1] - h[0])[2][:160] if cover
                else "host between recorded ops")
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    rank = sorted(by_op.items(), key=lambda kv: kv[1], reverse=True)
    gap_rank = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_total_s": sum(by_op.values()),
            "port_s": port_s,
            "device_ops": [[k, v] for k, v in rank[:top]],
            "idle_gaps": [[k, v] for k, v in gap_rank[:top]]}


def traced_window(ctx, state) -> Dict:
    """Steps 1–3 of the module docstring; returns the observations the
    per-layer readers take."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    bench = ctx.cell.bench
    fns = launch_counters()
    describe = {}
    for stem in fns:
        path = bench / "costs" / f"{stem}.py"
        if path.is_file():
            describe[stem] = load_file_module(path, f"gnnbench_cost_{stem}")
    calls = capture_calls(state.unit, fns,
                          {k: m.describe for k, m in describe.items()})
    parts = [state.unit() for _ in range(HOST_UNITS)]
    least, most = TRACE_UNITS
    k = min(most, max(least, math.ceil(TRACE_SECONDS / ctx.info["unit_s"])))
    out_dir = ctx.cell.root / "build" / "gnnbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace.{ctx.cell.name}.json"

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1,
                                                    active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        state.unit()
        ctx.sync()
        prof.step()
        time.sleep(0.05)
        before = read_launches(fns)
        with record_function(WINDOW):
            for _ in range(k):
                state.unit()
            ctx.sync()
        counts = {n: c - before[n] for n, c in read_launches(fns).items()}
        prof.step()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    summary = summarize_trace(events, port_kernels())
    ctx.log(f"traced {k} units: window {summary['window_s']:.4f} s, busy "
            f"{summary['busy_s']:.4f} s; launches {counts}")
    costs = {stem: m.cost for stem, m in describe.items()}
    return {"calls": calls, "costs": costs, "units": k, "launches": counts,
            "trace": summary, "parts": parts,
            "model_flops": ctx.cell.mode.model_flops(ctx)}
