"""Fit the planner's ``cuda`` (or ``cuda:bf16``) cost row on one CUDA card.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 benchmarks/torch_planner_fit.py [--dtype fp32|bf16]

The cost model (``src/repro_torch/core/planner.py``) prices a gspmm
route as ``rate × work + fixed``: ``work`` is ``estimate_cost``'s element
count (``n_edges·d`` for segment and push, the ELL pack's padded slots·d,
the tile buckets' slots·d for onehot and the kernel), ``rate`` is
relative to segment's (segment = 1), and ``fixed`` is a per-call cost in
the same unit. This script measures both on the card:

* rates: GCN's weighted sum ``u_mul_e_add_v`` (a scalar edge weight, B1's
  spec) on ``reddit-like`` (R-MAT seed 0, self-loops) at d = 16, 32 and
  602, each route timed on the device alone, warm
  (``chip_smoke.time_device_ms``; onehot at d ≤ 32 only, its one-hot
  tiles take ≈ 47 GB at 602). A route's rate is the median over the
  widths of its time per work element over segment's at the same width.
* fixed costs: one call of each route on ``tiny`` (512 nodes, ≈ 3,500
  edges, d = 16), where the device work is a few µs, timed back to back
  with one synchronize at the end: the host time of one call, over
  segment's device time per element-op at ``reddit-like``. The ELL
  route's host time is charged per degree class (``ell_class``).
* the ring: ``core/partition.ring_gspmm`` on the kernels (B1 per ring
  stage) over ``reddit-like``'s contiguous partition at S = 4 (GCN's
  bucketed weights, padded features), every stage of a pass on this one
  card; its work is the partition's ragged slots · d, so its rate is the
  emulated ring's device time per bucket slot, which ``estimate_cost``
  charges per device (slots / S). Its fixed cost is one pass's host time
  on ``tiny`` at S = 4. The exchange term (JAX's model constant) is not
  measured: one card has no ring to send over.

With ``--dtype bf16`` the features are bf16 (the weight stays fp32, as
in a bf16 training step) and the rates are taken over the fp32 segment
route's time per element-op at the same width, measured in the same run:
the ``cuda:bf16`` row is in the ``cuda`` row's unit, as JAX's ``cpu:bf16``
row is in ``cpu``'s, so the per-call (fixed) costs, which the model keeps
per device, apply to both; the bf16 calls' host times are printed beside
them.

It prints one JSON line per measurement and, last, the fitted row.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OP = "u_mul_e_add_v"
WIDTHS = (16, 32, 602)
ROUTES = ("segment", "push", "ell", "onehot", "kernel")
RING_SHARDS = 4
ONEHOT_MAX_D = 32
HOST_CALLS = 50


def work(route: str, stats, d: int) -> int:
    """``estimate_cost``'s work term: element-ops of one call."""
    if route in ("push", "segment"):
        return stats.n_edges * d
    if route == "ell":
        return stats.ell_padded_slots * d
    return -(-stats.n_edges // 256) * 256 * d


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _operands(g, d: int, gen, dtype=torch.float32):
    from repro_torch.models.gnn.common import make_bundle

    x = torch.randn(g.n_src, d, generator=gen).to(g.device, dtype)
    return x, make_bundle(g).gcn_norm[:, None].contiguous()


def _ring_call(g, d: int, gen, dtype=torch.float32):
    """One exact ring pass of ``g``'s contiguous partition at S =
    ``RING_SHARDS`` on ``dtype`` features: ``(call, ragged slots)``."""
    from repro_torch.core.partition import ring_gspmm
    from repro_torch.models.gnn.common import make_partitioned_bundle

    pb = make_partitioned_bundle(g, RING_SHARDS)
    xp = torch.randn(pb.pg.n_pad, d, generator=gen).to(g.device, dtype)
    return (lambda: ring_gspmm(pb.pg, xp, pb.gcn_w, strategy="kernel"),
            pb.pg.stats.ragged_slots)


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """Wall ms of one call of ``fn``, back to back, one sync at the end."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def fit_cuda_row(g_big, g_small, gen, emit=print, reps: int = 10,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Measure every route on ``dtype`` features, fit the row, return it
    with its inputs: ``{"rate": {...}, "fixed": {...}, "ell_class": x,
    "unit_ms": u, "device_ms": {route: {d: ms}}, "work": {route: {d: n}},
    "host_ms": {route: ms}}``; for bf16 also ``"unit_device_ms"``, the
    fp32 segment times the rates are taken over."""
    from chip_smoke import time_device_ms
    from repro_torch.core import gspmm
    from repro_torch.core.planner import compute_stats

    stats = compute_stats(g_big)
    name = "fp32" if dtype == torch.float32 else "bf16"
    routes = ROUTES + ("ring",)
    dev, wk = {r: {} for r in routes}, {r: {} for r in routes}
    unit_dev = {}
    for d in WIDTHS:
        x, w = _operands(g_big, d, gen, dtype)
        for route in ROUTES:
            if route == "onehot" and d > ONEHOT_MAX_D:
                continue
            ms = time_device_ms(lambda: gspmm(g_big, OP, u=x, e=w,
                                              strategy=route),
                                cold=False, reps=reps, warmup=2)
            dev[route][d], wk[route][d] = ms, work(route, stats, d)
            emit(json.dumps({"phase": "planner_fit", "dtype": name,
                             "route": route, "d": d, "device_ms": ms,
                             "work": wk[route][d]}))
        call, slots = _ring_call(g_big, d, gen, dtype)
        dev["ring"][d] = time_device_ms(call, cold=False, reps=reps,
                                        warmup=2)
        wk["ring"][d] = slots * d
        emit(json.dumps({"phase": "planner_fit", "dtype": name,
                         "route": "ring", "shards": RING_SHARDS, "d": d,
                         "device_ms": dev["ring"][d],
                         "work": wk["ring"][d]}))
        del call
        if dtype != torch.float32:  # the unit: fp32 segment, this width
            x32 = x.float()
            unit_dev[d] = time_device_ms(
                lambda: gspmm(g_big, OP, u=x32, e=w, strategy="segment"),
                cold=False, reps=reps, warmup=2)
            emit(json.dumps({"phase": "planner_fit", "dtype": "fp32",
                             "route": "segment", "d": d,
                             "device_ms": unit_dev[d],
                             "work": wk["segment"][d]}))
            del x32
        del x, w
        torch.cuda.empty_cache()
    unit_src = unit_dev if unit_dev else {d: dev["segment"][d]
                                          for d in WIDTHS}
    unit = {d: unit_src[d] / wk["segment"][d] for d in WIDTHS}
    rate = {r: statistics.median(dev[r][d] / wk[r][d] / unit[d]
                                 for d in dev[r]) for r in routes}
    unit_ms = statistics.median(unit.values())

    small = compute_stats(g_small)
    x, w = _operands(g_small, 16, gen, dtype)
    host = {r: host_ms(lambda r=r: gspmm(g_small, OP, u=x, e=w, strategy=r))
            for r in ROUTES}
    host["ring"] = host_ms(_ring_call(g_small, 16, gen, dtype)[0])
    for r, ms in host.items():
        emit(json.dumps({"phase": "planner_fit_host", "route": r,
                         "graph": "tiny", "n_edges": small.n_edges,
                         "ell_n_classes": small.ell_n_classes,
                         "host_ms": ms}))
    fixed = {r: host[r] / unit_ms for r in routes if r != "ell"}
    fixed["ell"] = 0.0
    ell_class = host["ell"] / max(small.ell_n_classes, 1) / unit_ms
    return {"rate": rate, "fixed": fixed, "ell_class": ell_class,
            "unit_ms": unit_ms, "device_ms": dev, "work": wk,
            "host_ms": host, "unit_device_ms": unit_dev,
            "reddit_stats": {
                "n_edges": stats.n_edges,
                "ell_padded_slots": stats.ell_padded_slots,
                "ell_n_classes": stats.ell_n_classes}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="fp32",
                    help="feature dtype of the fitted row (default fp32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_planner_fit: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("spmm_csr",))
    gen = torch.Generator().manual_seed(0)
    g_big = make_node_dataset("reddit-like", device="cuda")[0]
    g_small = make_node_dataset("tiny", device="cuda")[0]
    fit = fit_cuda_row(g_big, g_small, gen,
                       emit=lambda s: print(s, flush=True),
                       dtype=DTYPES[args.dtype])
    row = "cuda" if args.dtype == "fp32" else "cuda:bf16"
    print(json.dumps({"phase": "planner_fit_row", "row": row, **{
        k: fit[k] for k in ("rate", "fixed", "ell_class", "unit_ms",
                            "host_ms", "reddit_stats")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
