"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line per result; any failure raises, exit code != 0):

1. Environment: torch version, the card's name and power limit, TF32 off.
2. Build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, all in parallel.
3. Kernels: on the ``reddit-like`` graph, with and without self-loops
   (the latter has ~30k zero-in-degree rows), at each main-path shape,
   hold each kernel against its plain PyTorch version and time kernel,
   plain version and (B1 only) ``torch.sparse.mm`` on a CSR tensor —
   a yardstick the port never calls — with CUDA events.
4. Serve: for gcn, sage and gat, ``build_server(app, "reddit-like")``
   and a 4-client session; served rows must equal a plain-version full
   forward, the kernels' launch counters must rise in the refresh, and
   no new signature may appear in steady state.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
B1_SHAPES = [(32, "sum"), (41, "sum"), (602, "sum"),
             (32, "mean"), (41, "mean"), (602, "mean")]
B1_MAIN = [(32, "sum"), (41, "sum"), (602, "mean"), (32, "mean")]
B2_SHAPES = [(4, 32), (1, 41)]
B1_SOURCE = "src/repro_torch/kernels/csrc/spmm_csr.cu"
B2_SOURCE = "src/repro_torch/kernels/csrc/fused_attention_csr.cu"
B1_REPLACES = "src/repro/kernels/spmm/kernel.py:31"
B2_REPLACES = "src/repro/kernels/edge_softmax/kernel.py:51"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    return float((got - ref).abs().max()) if ref.numel() else 0.0


def check_b1(g, w_canon, gen, label: str, rows: dict) -> None:
    from repro_torch.kernels.spmm.ops import spmm_csr, spmm_plain

    deg = g.in_degrees.clamp(min=1).float()
    for d, red in B1_SHAPES:
        mean = red == "mean"
        weight = None if mean else w_canon
        B = torch.randn(g.n_src, d, generator=gen).cuda()
        n0 = spmm_csr.launches
        got = spmm_csr(g, B, weight, mean)
        ref = spmm_plain(g, B, weight, mean)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-5 * float(ref.abs().max())
        vals = (1.0 / deg).index_select(0, g.long("dst")) if mean else weight
        A = torch.sparse_csr_tensor(g.long("indptr_dst"), g.long("src"),
                                    vals, size=(g.n_dst, g.n_src))
        lib_err = max_err(torch.sparse.mm(A, B), ref)
        k_ms = time_ms(lambda: spmm_csr(g, B, weight, mean))
        p_ms = time_ms(lambda: spmm_plain(g, B, weight, mean))
        l_ms = time_ms(lambda: torch.sparse.mm(A, B))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges * (1 if mean else 2)
                      + g.n_src * d + g.n_dst * d)
        b_ms, b_by = bound(nbytes, 2 * g.n_edges * d)
        row = {"phase": "kernel", "kernel": "spmm_csr", "graph": label,
               "d": d, "reduce": red, "weighted": not mean,
               "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "launches": spmm_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"spmm_csr disagrees: {row}")
        rows[(label, d, red)] = row


def check_b2(g, gen, label: str, rows: dict) -> None:
    from repro_torch.kernels.edge_softmax.ops import (fused_attention_csr,
                                                      fused_attention_plain)

    for H, F in B2_SHAPES:
        el = torch.randn(g.n_src, H, generator=gen).cuda()
        er = torch.randn(g.n_dst, H, generator=gen).cuda()
        z = torch.randn(g.n_src, H, F, generator=gen).cuda()
        n0 = fused_attention_csr.launches
        got = fused_attention_csr(g, el, er, z, 0.2)
        ref = fused_attention_plain(g, el, er, z, 0.2)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-4 * float(ref.abs().max())
        k_ms = time_ms(lambda: fused_attention_csr(g, el, er, z, 0.2))
        p_ms = time_ms(lambda: fused_attention_plain(g, el, er, z, 0.2))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + g.n_src * H
                      + g.n_dst * H + g.n_src * H * F + g.n_dst * H * F)
        b_ms, b_by = bound(nbytes, g.n_edges * H * (2 * F + 6))
        row = {"phase": "kernel", "kernel": "fused_attention_csr",
               "graph": label, "H": H, "F": F, "max_abs_err": err,
               "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "launches": fused_attention_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"fused_attention_csr disagrees: {row}")
        rows[(label, H, F)] = row


def serve_app(app: str) -> dict:
    from repro_torch.kernels.edge_softmax.ops import fused_attention_csr
    from repro_torch.kernels.spmm.ops import spmm_csr
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import gat, gcn, sage

    t0 = time.perf_counter()
    srv = build_server(app, "reddit-like", device="cuda")
    setup_s = time.perf_counter() - t0
    n = srv.g.n_src
    spmm_csr.launches = 0
    fused_attention_csr.launches = 0
    res = run_session(srv, n_clients=4, requests_per_client=25,
                      ids_fn=lambda rng: rng.integers(0, n, 4))
    launches = {"spmm_csr": spmm_csr.launches,
                "fused_attention_csr": fused_attention_csr.launches}
    refreshes = srv.refreshes
    kernel = "fused_attention_csr" if app == "gat" else "spmm_csr"
    if refreshes < 1 or launches[kernel] != 2 * refreshes:
        raise AssertionError(f"{app}: {launches} launches over {refreshes} "
                             f"refreshes; expected 2 {kernel} per refresh")
    if res["recompiles_steady"] != 0:
        raise AssertionError(f"{app}: {res['recompiles_steady']} "
                             f"steady-state recompiles")
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    ref = mod.infer(srv.model, srv.bundle, srv.x_device,
                    strategy="segment").cpu().numpy()
    if not np.isfinite(ref).all() or ref.shape != (n, 41):
        raise AssertionError(f"{app}: plain forward shape {ref.shape}")
    served_err = 0.0
    for ids, rows in res["responses"]:
        if rows.shape != (len(ids), ref.shape[1]):
            raise AssertionError(f"{app}: served shape {rows.shape}")
        served_err = max(served_err, float(np.abs(rows - ref[ids]).max()))
    if not served_err <= 1e-4:
        raise AssertionError(f"{app}: served rows off by {served_err}")
    table = mod.infer(srv.model, srv.bundle, srv.x_device).cpu().numpy()
    table_err = float(np.abs(table - ref).max())
    if not table_err <= 1e-4:
        raise AssertionError(f"{app}: kernel forward off by {table_err}")

    def kernel_forward():
        mod.infer(srv.model, srv.bundle, srv.x_device)

    def plain_forward():
        mod.infer(srv.model, srv.bundle, srv.x_device, strategy="segment")

    row = {"phase": "serve", "app": app, "dataset": "reddit-like",
           "n_samples": res["n_samples"], "p50_ms": res["p50_ms"],
           "p99_ms": res["p99_ms"], "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "refreshes": refreshes, "launches": launches,
           "served_max_abs_err": served_err,
           "table_max_abs_err": table_err,
           "refresh_forward_ms": time_ms(kernel_forward, reps=5, warmup=1),
           "plain_forward_ms": time_ms(plain_forward, reps=5, warmup=1),
           "setup_s": setup_s}
    emit(row)
    return row


def summary(name, source, replaces, main_rows, all_rows, launches):
    def total(key):
        vals = [r[key] for r in main_rows]
        return None if any(v is None for v in vals) else sum(vals)

    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(main_rows, key=lambda r: r["bound_ms"])[
                "bound_by"],
            "library_ms": total("library_ms"),
            "shapes": [{k: r[k] for k in ("d", "reduce", "H", "F")
                        if k in r} for r in main_rows]}


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.data.synthetic import make_node_dataset, rmat_graph
    from repro_torch.core.graph import from_coo
    from repro_torch.kernels import _build
    from repro_torch.models.gnn.common import make_bundle

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    per_source = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "nvcc": _build.nvcc_path()})
    for name in _build.SOURCES:
        report = [ln for ln in _build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        emit({"phase": "ptxas", "source": name, "report": report})

    # 3. kernels, with and without zero-in-degree rows
    gen = torch.Generator().manual_seed(0)
    b1_rows, b2_rows = {}, {}
    g_loops = make_node_dataset("reddit-like", device="cuda")[0]
    src, dst, n = rmat_graph(16, 600_000, seed=0)
    g_bare = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    for label, g in (("self_loops", g_loops), ("no_self_loops", g_bare)):
        emit({"phase": "graph", "graph": label, "n_nodes": g.n_dst,
              "n_edges": g.n_edges,
              "max_in_degree": int(g.host.in_degrees.max()),
              "zero_in_degree_rows": int((g.host.in_degrees == 0).sum())})
        w = make_bundle(g).gcn_norm.index_select(0, g.long("eid"))
        check_b1(g, w.contiguous(), gen, label, b1_rows)
        check_b2(g, gen, label, b2_rows)
    del g_loops, g_bare
    torch.cuda.empty_cache()

    # 4. serve through the entry points a user calls
    served = {app: serve_app(app) for app in ("gcn", "sage", "gat")}

    b1_main = [b1_rows[("self_loops", d, r)] for d, r in B1_MAIN]
    b2_main = [b2_rows[("self_loops", H, F)] for H, F in B2_SHAPES]
    b1_launches = sum(s["launches"]["spmm_csr"] for s in served.values())
    b2_launches = sum(s["launches"]["fused_attention_csr"]
                      for s in served.values())
    emit({"kernels": [
        summary("spmm_csr", B1_SOURCE, B1_REPLACES, b1_main,
                list(b1_rows.values()), b1_launches),
        summary("fused_attention_csr", B2_SOURCE, B2_REPLACES, b2_main,
                list(b2_rows.values()), b2_launches)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
