"""What the per-layer readers (``metrics/<name>.py``) share. Each takes
the observations of a traced run (``tracing.traced_window``) and returns
a number, or None when it finds nothing to read."""
from __future__ import annotations

import statistics
from typing import Dict, Optional

from .costs.peaks import FP32_FLOPS_PER_S, least_seconds


def part_median(obs: Dict, part: str) -> Optional[float]:
    """Median of one host-timed part over the traced run's host units."""
    vals = [p[part] for p in obs.get("parts", []) if part in p]
    return statistics.median(vals) if vals else None


def roofline_pct(obs: Dict, kernel: str) -> Optional[float]:
    """Least time over device time of ``kernel``'s launches in the traced
    window, in percent: the least time of each call of one unit (from its
    operands' shapes, ``costs/<kernel>.py``) times the units traced. None
    when the kernel did not run, or when the port's launch counter over
    the traced units is not the watched unit's calls times the units (the
    calls were not one unit's)."""
    calls = obs.get("calls", {}).get(kernel)
    device_s = obs.get("trace", {}).get("port_s", {}).get(kernel, 0.0)
    if not calls or device_s <= 0.0:
        return None
    if obs["launches"].get(kernel) != len(calls) * obs["units"]:
        return None
    cost = obs["costs"][kernel]
    least = sum(least_seconds(*cost(c)) for c in calls) * obs["units"]
    return 100.0 * least / device_s


def port_share_pct(obs: Dict) -> Optional[float]:
    """The port's kernels' share of the device's time in the window."""
    tr = obs.get("trace")
    if not tr or tr["device_total_s"] <= 0.0:
        return None
    return 100.0 * sum(tr["port_s"].values()) / tr["device_total_s"]


def idle_pct(obs: Dict) -> Optional[float]:
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(obs: Dict) -> Optional[float]:
    """Model FLOPs of the traced units over the traced window, as a share
    of the fp32 peak."""
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0.0 or not obs.get("model_flops"):
        return None
    rate = obs["model_flops"] * obs["units"] / tr["window_s"]
    return 100.0 * rate / FP32_FLOPS_PER_S
