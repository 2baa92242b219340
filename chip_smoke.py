"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line per result; any failure raises, exit code != 0):

1. Environment: torch version, the card's name and power limit, TF32 off.
2. Build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, all in parallel.
3. Kernels: on the ``reddit-like`` graph, with and without self-loops
   (the latter has ~30k zero-in-degree rows), at each main-path shape,
   hold each kernel (B1 Copy-Reduce, B2 fused attention, B3 gSDDMM, B4
   Binary-Reduce, B5 edge softmax) against its plain PyTorch version
   within a stated tolerance, and time kernel, plain version and, where
   one PyTorch call computes the same function, that call — a yardstick
   the port never calls — with CUDA events. B1, B2 and B5 are called
   twice at every shape and must give bit-identical outputs. Every kernel
   and yardstick is also timed on the device alone, warm and with L2
   flushed between launches (cold). B3 is also timed walking canonical
   order (its first version, kept in ``benchmarks/``), and B5 over work
   lists of other caps K and lanes per segment (the sweep rows).
4. Serve: for gcn, sage and gat, ``build_server(app, "reddit-like")``
   and a 4-client session; served rows must equal a plain-version full
   forward, each refresh must launch exactly the app's kernels (GAT
   serves multipass: B3 × 6 and B4 × 2), and no new signature may appear
   in steady state.
5. Forward: ``gat.infer`` on the served model at ``attn`` = multipass,
   softmax-fused (B3 × 2 + B5 × 2) and auto (the fused pipeline on B2,
   × 2), each against the plain multipass forward.

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
FLUSH_BYTES = 128 << 20       # written between cold launches: > 2.5x L2
SLEEP_CYCLES = 2_000_000      # ~1 ms of GPU sleep ahead of each timed launch
B1_SHAPES = [(32, "sum"), (41, "sum"), (602, "sum"),
             (32, "mean"), (41, "mean"), (602, "mean")]
B1_MAIN = [(32, "sum"), (41, "sum"), (602, "mean"), (32, "mean")]
B2_SHAPES = [(4, 32), (1, 41)]
# (op, lhs target, rhs target, width): GAT multipass's three per layer at
# H = 4 then 1, and mul / dot / copy at the same shapes
B3_SHAPES = [(op, lt, rt, d) for op, lt, rt in (
    ("add", "u", "v"), ("sub", "e", "v"), ("div", "e", "v"),
    ("mul", "e", "v"), ("dot", "u", "v"), ("copy", "u", None))
    for d in (4, 1)]
B3_MAIN = [(op, lt, rt, d) for d in (4, 1)
           for op, lt, rt in (("add", "u", "v"), ("sub", "e", "v"),
                              ("div", "e", "v"))]
# (binop, width of B, width of E, reduce): the composed softmax's sums
# at H = 4 then 1, a vector-E u_mul_e and a mean
B4_SHAPES = [("copy_rhs", 4, 4, "sum"), ("copy_rhs", 1, 1, "sum"),
             ("mul", 32, 32, "sum"), ("copy_rhs", 4, 4, "mean")]
B4_MAIN = B4_SHAPES[:2]
B5_SHAPES = [4, 1]
B5_CAPS = (128, 256, 512)     # work-list caps K of B5's sweep rows
B5_LANES = (16, 32)           # lanes per segment of B5's sweep rows
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in (
    "spmm_csr", "fused_attention_csr", "sddmm_csr", "binary_reduce_csr",
    "edge_softmax_csr")}
REPLACES = {"spmm_csr": "src/repro/kernels/spmm/kernel.py:31",
            "fused_attention_csr": "src/repro/kernels/edge_softmax/kernel.py:51",
            "sddmm_csr": "src/repro/kernels/sddmm/kernel.py:18",
            "sddmm_csr:copy": "src/repro/kernels/sddmm/kernel.py:36",
            "binary_reduce_csr": "src/repro/kernels/binary_reduce/kernel.py:32",
            "edge_softmax_csr": "src/repro/kernels/edge_softmax/kernel.py:23"}
# kernel launches per refresh of each app's served (default) forward, and
# per forward of each GAT attn mode; every other counter must stay 0
SERVE_LAUNCHES = {"gcn": {"spmm_csr": 2}, "sage": {"spmm_csr": 2},
                  "gat": {"sddmm_csr": 6, "binary_reduce_csr": 2}}
# (attn="fused" names the fused pipeline's plain version, as in the JAX
# package; "auto" is the pipeline on its kernel, B2)
FORWARD_LAUNCHES = {"multipass": {"sddmm_csr": 6, "binary_reduce_csr": 2},
                    "softmax-fused": {"sddmm_csr": 2, "edge_softmax_csr": 2},
                    "auto": {"fused_attention_csr": 2}}


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


def time_device_ms(fn, cold: bool, reps: int = 20,
                   warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``'s device work
    alone. The GPU first sleeps, so the host has queued both events and
    ``fn``'s launches before the first event runs (``time_ms`` above also
    counts the host's wrapper time); with ``cold``, ``FLUSH_BYTES`` are
    written between launches so the inputs start outside L2."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if cold:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def warm_cold_ms(fn):
    """``time_device_ms`` of ``fn`` warm and with L2 flushed (cold)."""
    return time_device_ms(fn, False), time_device_ms(fn, True)


def bit_identical(what: str, fn) -> torch.Tensor:
    """Call ``fn`` twice; raise unless the outputs are bit-identical."""
    first, second = fn(), fn()
    if not torch.equal(first, second):
        raise AssertionError(f"{what}: two calls differ by "
                             f"{float((first - second).abs().max())}")
    return first


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
        got = bit_identical(f"spmm_csr d={d} {red}",
                            lambda: spmm_csr(g, B, weight, mean))
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
        k_dev = warm_cold_ms(lambda: spmm_csr(g, B, weight, mean))
        lib_dev = warm_cold_ms(lambda: torch.sparse.mm(A, B))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges * (1 if mean else 2)
                      + g.n_src * d + g.n_dst * d)
        b_ms, b_by = bound(nbytes, 2 * g.n_edges * d)
        row = {"phase": "kernel", "kernel": "spmm_csr", "graph": label,
               "d": d, "reduce": red, "weighted": not mean,
               "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
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
        got = bit_identical(f"fused_attention_csr H={H} F={F}",
                            lambda: fused_attention_csr(g, el, er, z, 0.2))
        ref = fused_attention_plain(g, el, er, z, 0.2)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-4 * float(ref.abs().max())
        k_ms = time_ms(lambda: fused_attention_csr(g, el, er, z, 0.2))
        p_ms = time_ms(lambda: fused_attention_plain(g, el, er, z, 0.2))
        k_dev = warm_cold_ms(lambda: fused_attention_csr(g, el, er, z, 0.2))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + g.n_src * H
                      + g.n_dst * H + g.n_src * H * F + g.n_dst * H * F)
        b_ms, b_by = bound(nbytes, g.n_edges * H * (2 * F + 6))
        row = {"phase": "kernel", "kernel": "fused_attention_csr",
               "graph": label, "H": H, "F": F, "max_abs_err": err,
               "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": None, "kernel_device_ms": k_dev[0],
               "kernel_cold_ms": k_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
               "launches": fused_attention_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"fused_attention_csr disagrees: {row}")
        rows[(label, H, F)] = row


def b3_operands(g, gen, op: str, lt: str, rt, d: int) -> tuple:
    """B3's arguments ``(g, op, lt, lhs[, rt, rhs])`` at one shape, drawn
    from ``gen`` on the card."""
    n_rows = {"u": g.n_src, "v": g.n_dst, "e": g.n_edges}
    args = (g, op, lt, torch.randn(n_rows[lt], d, generator=gen).cuda())
    if rt is not None:
        rhs = torch.randn(n_rows[rt], d, generator=gen).cuda()
        if op == "div":     # the path divides by sums of exp, >= 1
            rhs = rhs.abs() + 0.5
        args += (rt, rhs)
    return args


def check_b3(g, gen, label: str, rows: dict) -> None:
    from benchmarks.torch_sddmm_walks import sddmm_canonical
    from repro_torch.kernels.sddmm.ops import sddmm_csr, sddmm_plain

    src_caller = g.long("src_caller")
    for op, lt, rt, d in B3_SHAPES:
        args = b3_operands(g, gen, op, lt, rt, d)
        lhs = args[3]
        n0 = sddmm_csr.launches
        got = sddmm_csr(*args)
        ref = sddmm_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        if op == "dot":
            tol = 1e-5 + 1e-5 * float(ref.abs().max())
            why = "fma chain vs torch.sum: another summation order"
        else:
            tol = 0.0
            why = "one IEEE op per element in both: exact"
        lib_ms, lib_dev = None, (None, None)
        if op == "copy":
            lib_err = max_err(lhs.index_select(0, src_caller), ref)
            if lib_err != 0.0:
                raise AssertionError(f"index_select copy differs: {lib_err}")
            lib_ms = time_ms(lambda: lhs.index_select(0, src_caller))
            lib_dev = warm_cold_ms(lambda: lhs.index_select(0, src_caller))
        k_ms = time_ms(lambda: sddmm_csr(*args))
        p_ms = time_ms(lambda: sddmm_plain(*args))
        k_dev = warm_cold_ms(lambda: sddmm_csr(*args))
        # the kernel's first walk (canonical order, written through eid),
        # a benchmark variant kept to show what the caller-order walk buys
        canon_err = max_err(sddmm_canonical(*args), ref)
        canon_ms = time_device_ms(lambda: sddmm_canonical(*args), False)
        # one caller-order index array per node operand; an edge operand
        # is read at its own caller edge id, with no index
        n_idx = len({lt, rt} - {"e", None})
        nbytes = 4 * (n_idx * g.n_edges + lhs.numel()
                      + (0 if rt is None else args[5].numel()) + ref.numel())
        b_ms, b_by = bound(nbytes, g.n_edges * d)
        row = {"phase": "kernel", "kernel": "sddmm_csr", "graph": label,
               "op": op, "lhs": lt, "rhs": rt, "d": d, "max_abs_err": err,
               "tol": tol, "tol_reason": why, "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1],
               "canonical_device_ms": canon_ms,
               "canonical_max_abs_err": canon_err, "bound_ms": b_ms,
               "bound_by": b_by, "launches": sddmm_csr.launches - n0}
        emit(row)
        if not (err <= tol and canon_err <= tol):
            raise AssertionError(f"sddmm_csr disagrees: {row}")
        rows[(label, op, lt, rt, d)] = row


def check_b4(g, gen, label: str, rows: dict) -> None:
    from repro_torch.kernels.binary_reduce.ops import (binary_reduce_csr,
                                                       binary_reduce_plain)

    deg = g.in_degrees.long()
    has_edge = deg > 0
    for binop, d, de, red in B4_SHAPES:
        mean = red == "mean"
        B = (None if binop == "copy_rhs"
             else torch.randn(g.n_src, d, generator=gen).cuda())
        E = torch.randn(g.n_edges, de, generator=gen).cuda()
        n0 = binary_reduce_csr.launches
        got = binary_reduce_csr(g, B, E, binop, mean)
        ref = binary_reduce_plain(g, B, E, binop, mean)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-5 * float(ref.abs().max())
        lib_ms = lib_err = None
        lib_dev = (None, None)
        if binop == "copy_rhs":
            # the edge values already in canonical order: the permutation
            # through eid is left out of the library's time
            e_canon = E.index_select(0, g.long("eid"))

            def lib():
                return torch.segment_reduce(e_canon, red, lengths=deg)

            lib_err = max_err(lib()[has_edge], ref[has_edge])
            lib_ms = time_ms(lib)
            lib_dev = warm_cold_ms(lib)
        k_ms = time_ms(lambda: binary_reduce_csr(g, B, E, binop, mean))
        p_ms = time_ms(lambda: binary_reduce_plain(g, B, E, binop, mean))
        k_dev = warm_cold_ms(lambda: binary_reduce_csr(g, B, E, binop, mean))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + E.numel() + ref.numel()
                      + (0 if B is None else g.n_edges + B.numel()))
        b_ms, b_by = bound(nbytes, g.n_edges * d * (1 if B is None else 2))
        row = {"phase": "kernel", "kernel": "binary_reduce_csr",
               "graph": label, "binop": binop, "d": d, "de": de,
               "reduce": red, "max_abs_err": err, "tol": tol,
               "tol_reason": "another summation order",
               "library_max_abs_err": lib_err, "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1], "bound_ms": b_ms,
               "bound_by": b_by, "launches": binary_reduce_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"binary_reduce_csr disagrees: {row}")
        rows[(label, binop, d, de, red)] = row


def check_b5(g, gen, label: str, rows: dict) -> None:
    from repro_torch.kernels.edge_softmax.ops import (_launch_softmax,
                                                      edge_softmax_csr,
                                                      edge_softmax_plain)
    from repro_torch.kernels.rowsplit import build_row_split

    for H in B5_SHAPES:
        x = 3 * torch.randn(g.n_edges, H, generator=gen).cuda()
        n0 = edge_softmax_csr.launches
        got = bit_identical(f"edge_softmax_csr H={H}",
                            lambda: edge_softmax_csr(g, x))
        ref = edge_softmax_plain(g, x)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5
        k_ms = time_ms(lambda: edge_softmax_csr(g, x))
        p_ms = time_ms(lambda: edge_softmax_plain(g, x))
        k_dev = warm_cold_ms(lambda: edge_softmax_csr(g, x))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + 2 * x.numel())
        b_ms, b_by = bound(nbytes, 4 * x.numel())
        row = {"phase": "kernel", "kernel": "edge_softmax_csr",
               "graph": label, "H": H, "max_abs_err": err, "tol": tol,
               "tol_reason": "alpha <= 1; expf and the sum's order differ",
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
               "launches": edge_softmax_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"edge_softmax_csr disagrees: {row}")
        rows[(label, H)] = row
        # the work list's cap K and the lanes per segment: the wrapper's
        # (128, 16) against their neighbours
        hl = min(32, 1 << (H - 1).bit_length())
        for K, lanes in [(K, n) for K in B5_CAPS for n in B5_LANES
                         if n >= hl]:
            rs = build_row_split(g.indptr_dst, K)
            k_err = max_err(_launch_softmax(g, x, rs, lanes), ref)
            emit({"phase": "sweep", "kernel": "edge_softmax_csr",
                  "graph": label, "H": H, "K": K, "lanes": lanes,
                  "max_abs_err": k_err, "device_ms": time_device_ms(
                      lambda: _launch_softmax(g, x, rs, lanes), False)})
            if not k_err <= tol:
                raise AssertionError(f"edge_softmax K={K} lanes={lanes} "
                                     f"H={H}: {k_err}")


def counters():
    """Every kernel wrapper, by name, with its launch counter; B3's copy
    (B3b) is read from ``sddmm_csr.op_launches``."""
    from repro_torch.kernels.binary_reduce.ops import binary_reduce_csr
    from repro_torch.kernels.edge_softmax.ops import (edge_softmax_csr,
                                                      fused_attention_csr)
    from repro_torch.kernels.sddmm.ops import sddmm_csr
    from repro_torch.kernels.spmm.ops import spmm_csr

    return {f.__name__: f for f in (spmm_csr, fused_attention_csr, sddmm_csr,
                                    binary_reduce_csr, edge_softmax_csr)}


def reset_counts() -> None:
    for f in counters().values():
        f.launches = 0
    counters()["sddmm_csr"].op_launches.clear()


def read_counts() -> dict:
    out = {name: f.launches for name, f in counters().items()}
    out["sddmm_csr:copy"] = counters()["sddmm_csr"].op_launches["copy"]
    out["sddmm_csr"] -= out["sddmm_csr:copy"]
    return out


def check_launches(what: str, launches: dict, per_run: dict,
                   runs: int) -> None:
    want = {k: per_run.get(k, 0) * runs for k in launches}
    if runs < 1 or launches != want:
        raise AssertionError(f"{what}: launches {launches} over {runs} "
                             f"run(s); expected {want}")


def serve_app(app: str):
    """Serve ``app`` through ``build_server`` and check it; returns the
    row and the server (its model feeds the forward phase)."""
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import gat, gcn, sage

    t0 = time.perf_counter()
    srv = build_server(app, "reddit-like", device="cuda")
    setup_s = time.perf_counter() - t0
    n = srv.g.n_src
    reset_counts()
    res = run_session(srv, n_clients=4, requests_per_client=25,
                      ids_fn=lambda rng: rng.integers(0, n, 4))
    launches = read_counts()
    refreshes = srv.refreshes
    check_launches(app, launches, SERVE_LAUNCHES[app], refreshes)
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
    return row, srv


def forward_gat(srv) -> dict:
    """``gat.infer`` on the served GAT at each attn mode that reaches a
    kernel: launches per forward, error against the plain multipass
    forward, and the forward's time. Returns mode → row."""
    from repro_torch.models.gnn import gat

    args = (srv.model, srv.bundle, srv.x_device)
    ref = gat.infer(*args, strategy="segment")
    rows = {}
    for attn, per_run in FORWARD_LAUNCHES.items():
        reset_counts()
        out = gat.infer(*args, attn=attn)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(f"gat attn={attn}", launches, per_run, 1)
        err = max_err(out, ref)
        if not err <= 1e-4:
            raise AssertionError(f"gat attn={attn}: off by {err}")
        row = {"phase": "forward", "app": "gat", "dataset": "reddit-like",
               "attn": attn, "launches": launches, "max_abs_err": err,
               "refresh_forward_ms": time_ms(lambda: gat.infer(
                   *args, attn=attn), reps=5, warmup=1)}
        emit(row)
        rows[attn] = row
    return rows


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
            "shapes": [{k: r[k] for k in (
                "op", "binop", "lhs", "rhs", "d", "de", "reduce", "H", "F",
                "kernel_ms", "kernel_device_ms", "kernel_cold_ms",
                "canonical_device_ms", "library_ms", "library_device_ms",
                "library_cold_ms", "plain_ms", "bound_ms") if k in r}
                for r in main_rows]}


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from benchmarks.torch_sddmm_walks import CANONICAL_SRC
    from repro_torch.data.synthetic import make_node_dataset, rmat_graph
    from repro_torch.core.graph import from_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_softmax.ops import SOFTMAX_SEGMENT_EDGES
    from repro_torch.kernels.rowsplit import SEGMENT_EDGES, row_split
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
    sources = _build.SOURCES + (CANONICAL_SRC,)
    per_source = _build.build(sources)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "nvcc": _build.nvcc_path()})
    for name in sources:
        report = [ln for ln in _build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        emit({"phase": "ptxas", "source": name, "report": report})

    # 3. kernels, with and without zero-in-degree rows
    gen = torch.Generator().manual_seed(0)
    b1_rows, b2_rows, b3_rows, b4_rows, b5_rows = {}, {}, {}, {}, {}
    g_loops = make_node_dataset("reddit-like", device="cuda")[0]
    src, dst, n = rmat_graph(16, 600_000, seed=0)
    g_bare = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    for label, g in (("self_loops", g_loops), ("no_self_loops", g_bare)):
        lists = []
        for K in (SEGMENT_EDGES, SOFTMAX_SEGMENT_EDGES):   # B1 / B2, B5
            t0 = time.perf_counter()
            rs = row_split(g, K)
            lists.append({"K": rs.K, "segments": rs.n_segments,
                          "split_rows": rs.n_split,
                          "partial_slots": rs.n_partials,
                          "longest_segment": rs.max_segment,
                          "build_s": time.perf_counter() - t0})
        emit({"phase": "graph", "graph": label, "n_nodes": g.n_dst,
              "n_edges": g.n_edges,
              "max_in_degree": int(g.host.in_degrees.max()),
              "zero_in_degree_rows": int((g.host.in_degrees == 0).sum()),
              "work_lists": lists})
        w = make_bundle(g).gcn_norm.index_select(0, g.long("eid"))
        check_b1(g, w.contiguous(), gen, label, b1_rows)
        check_b2(g, gen, label, b2_rows)
        check_b3(g, gen, label, b3_rows)
        check_b4(g, gen, label, b4_rows)
        check_b5(g, gen, label, b5_rows)
    del g_loops, g_bare
    torch.cuda.empty_cache()

    # 4. serve through the entry points a user calls; 5. GAT's modes
    served = {}
    for app in ("gcn", "sage", "gat"):
        served[app], srv = serve_app(app)
    forward = forward_gat(srv)
    del srv

    # launches on the main path: every serve and forward run, each
    # counted from 0 just before it
    runs = list(served.values()) + list(forward.values())
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    main = {
        "spmm_csr": [b1_rows[("self_loops", d, r)] for d, r in B1_MAIN],
        "fused_attention_csr": [b2_rows[("self_loops", H, F)]
                                for H, F in B2_SHAPES],
        "sddmm_csr": [b3_rows[("self_loops",) + k] for k in B3_MAIN],
        "sddmm_csr:copy": [b3_rows[("self_loops",) + k] for k in B3_SHAPES
                           if k[0] == "copy"],
        "binary_reduce_csr": [b4_rows[("self_loops",) + k] for k in B4_MAIN],
        "edge_softmax_csr": [b5_rows[("self_loops", H)] for H in B5_SHAPES]}
    every = {"spmm_csr": b1_rows, "fused_attention_csr": b2_rows,
             "sddmm_csr": {k: r for k, r in b3_rows.items()
                           if r["op"] != "copy"},
             "sddmm_csr:copy": {k: r for k, r in b3_rows.items()
                                if r["op"] == "copy"},
             "binary_reduce_csr": b4_rows, "edge_softmax_csr": b5_rows}
    emit({"kernels": [
        summary(name, SOURCES[name.split(":")[0]], REPLACES[name],
                main[name], list(every[name].values()), launches[name])
        for name in main]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
