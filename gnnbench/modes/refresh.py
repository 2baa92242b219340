"""Layer-wise serving's refresh: one unit is one
``repro_torch.core.serving.GNNServer.refresh()`` of a ``mode="layerwise"``
server — the app's inference forward over the whole graph (no autograd,
no Gᵀ, no optimizer), the output table copied to the host and swapped
into the server's row cache — back to back, as fresh outputs cost a
layer-wise serving user.

Set-up takes its inputs from the configuration's graph kind, which has to
be ``rmat`` (the server is built on one plain graph), builds G and the
server (its bundle, its device copy of the features) and runs
``setup_units`` refreshes, which warm every shape. The window keeps the
table of a few refreshes drawn from the seed, and of the last; the check
compares each with the reference forward. A refresh whose table is not
finite counts as failed.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from gnnbench.data.graph import generator
from gnnbench.inputs import (make_inputs, model_costs, n_edges, port_model,
                             reference_inputs, reference_module, table_gap)


def finite(table: np.ndarray) -> bool:
    return bool(np.isfinite(table.sum()))


class State:
    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.attempted = 0
        self.i = 0
        self.tables = {}
        # each table is checked on a worker thread while the next refresh
        # runs on the device, so the check adds nothing to the window
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.finite = []

    @property
    def failed(self) -> int:
        return sum(not f.result() for f in self.finite)

    def unit(self) -> Dict[str, float]:
        from repro_torch.obs.spans import trace_events

        t0 = time.perf_counter()
        self.server.refresh()
        wall = time.perf_counter() - t0
        table = self.server._out_cache.store   # the rows requests read
        self.finite.append(self.pool.submit(finite, table))
        if self.i in self.keep:
            self.tables[self.i] = table
        self.last = table
        self.i += 1
        self.attempted += 1
        spans = [e for e in trace_events()[-4:] if e["name"] ==
                 "serve.refresh"]
        if not spans:
            return {"wall_ms": wall * 1e3}
        return {"wall_ms": wall * 1e3,
                "store_ms": wall * 1e3 - spans[-1]["dur"] / 1e3}


def setup(ctx) -> State:
    from repro_torch.core.graph import from_coo
    from repro_torch.core.serving import GNNServer

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    if cfg["graph"] != "rmat":
        raise ValueError(f"{ctx.cell.name}: the refresh serves one plain "
                         f"graph and takes the rmat graph kind, not "
                         f"{cfg['graph']!r}")
    inp = make_inputs(ctx)
    feats = inp["x"].cpu().numpy()
    inp["x"] = feats              # the server keeps its own device copy
    n = cfg["nodes"]
    build = {}
    t = time.perf_counter()
    g = from_coo(inp["src"], inp["dst"], n_src=n, n_dst=n, device=dev)
    ctx.sync()
    build["G"] = time.perf_counter() - t
    t = time.perf_counter()
    server = GNNServer(cfg["app"], port_model(cfg, inp["leaves"], dev), g,
                       feats, mode="layerwise", device=dev)
    ctx.sync()
    build["server"] = time.perf_counter() - t
    ctx.info["graph_build_s"] = build
    for _ in range(p["setup_units"]):
        t = time.perf_counter()
        server.refresh()
        ctx.info["unit_s"] = time.perf_counter() - t
    # refreshes whose tables the check reads, drawn from the seed among
    # those the window is expected to run
    expect = max(1, int(ctx.seconds / ctx.info["unit_s"]))
    draw = torch.randperm(expect, generator=generator(ctx.seed, "sample",
                                                      "cpu"))
    keep = set(draw[:p["checked_tables"]].tolist())
    ctx.log(f"set-up refreshes: last {ctx.info['unit_s'] * 1e3:.2f} ms; "
            f"tables checked at {sorted(keep)} and the last")
    return State(inp=inp, server=server, keep=keep, last=None)


def end_to_end(ctx, state, window) -> Dict[str, float]:
    return {"refresh_ms": 1e3 * window["wall_s"] / window["count"]}


def model_flops(ctx) -> float:
    cfg = ctx.config
    return model_costs(ctx).forward(cfg, cfg["nodes"], n_edges(ctx))


def reference_table(ctx, inp: Dict, *, tf32: bool = False) -> torch.Tensor:
    from gnnbench.reference.common import tf32_mode

    cfg = ctx.config
    with torch.no_grad(), tf32_mode(tf32):
        return reference_module(ctx).forward(
            inp["leaves"], reference_inputs(ctx, inp), cfg)


def free_program(state) -> Dict:
    """Drop the server and the check's worker, keep the inputs."""
    state.pool.shutdown()
    state.server = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return state.inp


def check(ctx, state) -> Dict[str, float]:
    tables = list(state.tables.values()) + [state.last]
    inp = free_program(state)
    ref = reference_table(ctx, inp)
    return {"table_gap": max(table_gap(t, ref) for t in tables)}


def control(ctx, state) -> Dict[str, Dict[str, float]]:
    """The program's number, the control's (the reference in TF32) and
    two planted faults' (one answer altered; half of the rows left out)
    against the fp32 reference, for one seed."""
    table = state.server._out_cache.store
    inp = free_program(state)
    ref = reference_table(ctx, inp)
    ctl = reference_table(ctx, inp, tf32=True).cpu().numpy()
    altered = table.copy()
    altered[0] = altered[1]
    half = table.copy()
    half[: half.shape[0] // 2] = 0.0
    return {"program": {"table_gap": table_gap(table, ref)},
            "control_tf32": {"table_gap": table_gap(ctl, ref)},
            "fault_answer_altered": {"table_gap": table_gap(altered, ref)},
            "fault_half_rows": {"table_gap": table_gap(half, ref)}}
