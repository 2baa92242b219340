"""What the readers of the port's own spans share. Each reader takes the
spans its process recorded (``repro_torch.obs.trace_events()``, after
``resolve_device_spans(wait=True)`` where the program has it), groups
them by unit — a training step is ``train.forward`` start to
``train.optimizer`` end with the same ``step``, a refresh is
``serve.refresh`` — and returns the median over the units, or None where
the program records no such span."""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Tuple

AGG = "agg."


def program_spans() -> List[Dict]:
    """The port's spans in this process, device times resolved."""
    from repro_torch import obs

    resolve = getattr(obs, "resolve_device_spans", None)
    if resolve is not None:
        resolve(wait=True)
    return obs.trace_events()


def _end(e: Dict) -> float:
    return e["ts"] + e["dur"]


def train_units(spans: List[Dict]) -> List[Tuple[float, float]]:
    """Host intervals of the training steps: each ``train.forward`` to
    the first ``train.optimizer`` of the same ``step`` after it."""
    opts = sorted((e for e in spans if e["name"] == "train.optimizer"),
                  key=lambda e: e["ts"])
    units = []
    for f in sorted((e for e in spans if e["name"] == "train.forward"),
                    key=lambda e: e["ts"]):
        step = f["args"].get("step")
        o = next((o for o in opts if o["ts"] >= f["ts"]
                  and o["args"].get("step") == step), None)
        if o is not None:
            units.append((f["ts"], _end(o)))
    return units


def refresh_units(spans: List[Dict]) -> List[Tuple[float, float]]:
    """Host intervals of the refreshes (``serve.refresh``)."""
    return sorted((e["ts"], _end(e)) for e in spans
                  if e["name"] == "serve.refresh")


def within(spans: List[Dict], unit: Tuple[float, float]) -> List[Dict]:
    """The spans whose host interval lies inside ``unit``'s."""
    lo, hi = unit
    return [e for e in spans if e["ts"] >= lo and _end(e) <= hi]


def device_ms(spans: List[Dict], names) -> Optional[float]:
    """Σ ``device_ms`` of the spans named in ``names``; None when one of
    them has no device time or none is there."""
    got = [e for e in spans if e["name"] in names]
    if not got or any("device_ms" not in e["args"] for e in got):
        return None
    return sum(e["args"]["device_ms"] for e in got)


def plain_leaves(spans: List[Dict]) -> List[Dict]:
    """``agg.*`` spans that enclose no other ``agg.*`` span (by parent id)
    and ran on a route other than the port's kernels."""
    agg = [e for e in spans if e["name"].startswith(AGG)]
    parents = {e["args"].get("parent") for e in agg}
    return [e for e in agg if e["args"].get("id") not in parents
            and e["args"].get("route") != "kernel"]


def plain_route_ms(spans: List[Dict]) -> Optional[float]:
    """Device milliseconds of the plain-route leaves in ``spans`` (one
    unit's); None when the unit has no ``agg.*`` span, or a leaf has no
    device time."""
    if not any(e["name"].startswith(AGG) for e in spans):
        return None
    leaves = plain_leaves(spans)
    if any("device_ms" not in e["args"] for e in leaves):
        return None
    return sum(e["args"]["device_ms"] for e in leaves)


def unit_median(units: Callable, per_unit: Callable,
                spans: Optional[List[Dict]] = None) -> Optional[float]:
    """Median of ``per_unit(spans inside the unit)`` over ``units(spans)``,
    leaving out units that read None; None when every unit does."""
    spans = program_spans() if spans is None else spans
    vals = [per_unit(within(spans, u)) for u in units(spans)]
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None


def setup_spans(spans: List[Dict]) -> List[Dict]:
    """The spans that end before the first unit (training step or
    refresh) starts: set-up's."""
    starts = [u[0] for u in train_units(spans) + refresh_units(spans)]
    if not starts:
        return spans
    first = min(starts)
    return [e for e in spans if _end(e) <= first]


def setup_seconds(name: str) -> Optional[float]:
    """Σ host seconds of set-up's spans named ``name``; None if none."""
    got = [e["dur"] / 1e6 for e in setup_spans(program_spans())
           if e["name"] == name]
    return sum(got) if got else None
