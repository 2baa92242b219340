"""GNN inference serving entry point (port of
``repro/launch/serve_gnn.py``).

Stands up a :class:`~repro_torch.core.serving.GNNServer` over a synthetic
dataset and drives it with N concurrent requester threads through a
:class:`~repro_torch.data.RequestQueue`: clients submit node-id requests
and block on futures, the serving loop drains coalescing windows through
the prefetcher, batches pad onto signature classes, and steady state
meets no new signature.

Usage (on the card; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --app gcn \\
      --dataset reddit-like --clients 4 --requests 25
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --app gat \\
      --dataset tiny --mode fanout --fanout 10 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --app rgcn \\
      --dataset tiny --mode fanout --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --app gat \\
      --dataset tiny --device cpu --trace t.json --drift

``--trace OUT.json`` writes the session's spans as Chrome-trace JSON and
prints their count and span coverage; ``--drift`` prints the planner's
predicted-vs-measured drift report and the ``serve.batch_seconds``
summary.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.serving import SERVE_APPS, SERVE_MODES, GNNServer
from ..data import RequestQueue, make_node_dataset, relational_graph
from ..device import DeviceLike, resolve_device
from ..models.gnn import gat, gcn, rgcn, sage
from ..obs import (drift_report, export_chrome_trace, percentile_nearest_rank,
                   snapshot, span_coverage, trace_events)

__all__ = ["build_server", "run_session", "percentile_nearest_rank", "main"]


def build_server(app: str, dataset: str, *, mode: str = "auto",
                 classes=(8, 32, 128), d_hidden: int = 32,
                 fanout: Optional[int] = None, cache_rows: int = 4096,
                 pin_hot: int = 256, seed: int = 0,
                 device: DeviceLike = "cuda") -> GNNServer:
    """Dataset + randomly initialized model (from ``seed``) + server on
    ``device``, ready to serve. ``fanout`` is the fan-out mode's per-layer
    sample size (None: the max in-degree, exact). Serving correctness
    does not depend on the weights: served rows are held to the full
    forward under the same model. R-GCN serves a BGS-like typed graph of
    the JAX entry point's shape (``tiny``: 256 nodes, 4 relations; any
    other dataset: 4096 nodes, 8 relations; n/2 edges per relation),
    32 input features, 8 classes."""
    dev = resolve_device(device)
    if app == "rgcn":
        n, n_rel = (256, 4) if dataset == "tiny" else (4096, 8)
        rels = relational_graph(n, n_rel, max(n // 2, 64), seed=seed)
        feats = np.random.default_rng(seed).standard_normal(
            (n, 32)).astype(np.float32)
        model = rgcn.init(torch.Generator().manual_seed(seed), 32, d_hidden,
                          8, n_rel, device=dev)
        return GNNServer("rgcn", model, None, feats, rels=rels, mode=mode,
                         classes=classes, fanout=fanout,
                         cache_rows=cache_rows, pin_hot=pin_hot, seed=seed,
                         device=dev)
    if app not in SERVE_APPS:
        raise ValueError(f"unknown serve app {app!r}; expected one of "
                         f"{SERVE_APPS}")
    g, feats, _labels, _tr, _va, n_classes = make_node_dataset(
        dataset, device=dev)
    gen = torch.Generator().manual_seed(seed)
    init = {"gcn": gcn.init, "sage": sage.init, "gat": gat.init}[app]
    model = init(gen, feats.shape[1], d_hidden, n_classes, device=dev)
    return GNNServer(app, model, g, feats, mode=mode, classes=classes,
                     fanout=fanout, cache_rows=cache_rows, pin_hot=pin_hot,
                     seed=seed, device=dev)


def run_session(srv: GNNServer, *, n_clients: int, requests_per_client: int,
                ids_fn: Callable[[np.random.Generator], np.ndarray],
                max_wait: float = 0.002, depth: int = 2,
                timeout: float = 600.0) -> Dict:
    """Drive the server with ``n_clients`` concurrent closed-loop
    requester threads, each submitting ``requests_per_client`` requests
    drawn by ``ids_fn`` and blocking on each before the next.

    Returns per-request wall latencies (submit → fulfilled: queueing +
    batching + compute), nearest-rank p50/p99, throughput, the
    new-signature count over the steady-state window, server stats, and
    every ``(ids, rows)`` response for checking.
    """
    srv.warmup()                       # the table is computed HERE
    compiles_before = srv.compiles
    rq = RequestQueue(max_wait=max_wait)
    lat: List[List[float]] = [[] for _ in range(n_clients)]
    responses: List[List] = [[] for _ in range(n_clients)]
    errs: List[BaseException] = []

    def client(cid: int) -> None:
        rng = np.random.default_rng(1000 + cid)
        try:
            for _ in range(requests_per_client):
                ids = ids_fn(rng)
                req = rq.submit(ids)
                rows = req.result(timeout=timeout)
                lat[cid].append(time.perf_counter() - req.t_submit)
                responses[cid].append((np.asarray(ids), rows))
        except BaseException as e:      # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]

    def close_when_done() -> None:
        for t in threads:
            t.join()
        rq.close()

    closer = threading.Thread(target=close_when_done, daemon=True)
    for t in threads:
        t.start()
    closer.start()
    t0 = time.perf_counter()
    srv.run(rq, depth=depth)           # serving loop, main thread
    elapsed = time.perf_counter() - t0
    closer.join(timeout=timeout)
    if errs:
        raise errs[0]

    flat = sorted(x for per in lat for x in per)
    n = len(flat)
    return {
        "latencies": flat,
        "n_samples": n,
        "p50_ms": 1e3 * percentile_nearest_rank(flat, 50) if n else
                  float("nan"),
        "p99_ms": 1e3 * percentile_nearest_rank(flat, 99) if n else
                  float("nan"),
        "throughput_rps": n / max(elapsed, 1e-9),
        "elapsed_s": elapsed,
        "recompiles_steady": srv.compiles - compiles_before,
        "stats": srv.stats(),
        "responses": [r for per in responses for r in per],
    }


def main(argv: Optional[List[str]] = None) -> None:
    """The CLI; ``argv`` defaults to the command line's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", choices=SERVE_APPS, default="gcn")
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--mode", default="auto", choices=("auto",) + SERVE_MODES)
    ap.add_argument("--fanout", type=int, default=None,
                    help="fan-out per layer (default: the max in-degree)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=50,
                    help="requests per client")
    ap.add_argument("--request-ids", type=int, default=4,
                    help="node ids per request")
    ap.add_argument("--classes", type=int, nargs="+", default=[8, 32, 128])
    ap.add_argument("--cache-rows", type=int, default=4096)
    ap.add_argument("--pin-hot", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export the session as Chrome-trace JSON "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--drift", action="store_true",
                    help="print the planner predicted-vs-measured "
                         "drift report after the session")
    args = ap.parse_args(argv)

    srv = build_server(args.app, args.dataset, mode=args.mode,
                       classes=tuple(args.classes), fanout=args.fanout,
                       cache_rows=args.cache_rows, pin_hot=args.pin_hot,
                       seed=args.seed, device=args.device)
    n_nodes = srv.g.n_src

    def ids_fn(rng: np.random.Generator) -> np.ndarray:
        return rng.integers(0, n_nodes, args.request_ids)

    res = run_session(srv, n_clients=args.clients,
                      requests_per_client=args.requests, ids_fn=ids_fn)
    modes = {c: srv.mode_for_class(c) for c in srv.batcher.classes}
    print(f"[serve_gnn] app={args.app} dataset={args.dataset} "
          f"device={srv.device} clients={args.clients} "
          f"req/client={args.requests} ids/req={args.request_ids}")
    print(f"[serve_gnn] class→mode {modes} (fanout={srv.fanout})")
    print(f"[serve_gnn] p50 {res['p50_ms']:.3f} ms  p99 {res['p99_ms']:.3f} "
          f"ms  {res['throughput_rps']:.0f} req/s (n={res['n_samples']})")
    print(f"[serve_gnn] steady-state new signatures: "
          f"{res['recompiles_steady']} (must be 0)")
    for name in ("out_cache", "feat_cache"):
        cs = res["stats"][name]
        if cs is not None:
            print(f"[serve_gnn] {name}: hit_ratio {cs.hit_ratio:.3f} "
                  f"({cs.hits}h/{cs.misses}m, {cs.evictions} evictions, "
                  f"{cs.pinned} pinned)")
    if args.trace:
        export_chrome_trace(args.trace)
        print(f"[serve_gnn] trace: {len(trace_events())} events → "
              f"{args.trace} (span coverage {span_coverage():.1%})")
    if args.drift:
        rows = drift_report()
        print(f"[serve_gnn] drift report ({len(rows)} rows):")
        for r in rows:
            print(f"  {r['op']:28s} {r['chosen']:10s} "
                  f"pred={r['predicted_cost']:.3g} "
                  f"meas={1e3 * r['measured_mean_s']:.3f}ms "
                  f"ratio={r['ratio']:.2f}"
                  f"{'  DRIFTED' if r['drifted'] else ''}")
        batch_h = snapshot().get("serve.batch_seconds")
        if batch_h:
            print(f"[serve_gnn] serve.batch_seconds: "
                  f"n={batch_h['count']} mean={1e3 * batch_h['mean']:.3f}ms")
    if res["recompiles_steady"]:
        raise SystemExit("steady-state recompiles detected")


if __name__ == "__main__":
    main()
