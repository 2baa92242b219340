"""Sweep the row-segment cap K of the port's B1 and B2 kernels on one H100.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 benchmarks/torch_rowsplit_sweep.py

On ``reddit-like`` with self-loops (the serving graph), at each main-path
shape of B1 (``spmm_csr``: d = 32 and 41 weighted sums, d = 602 and 32
means) and B2 (``fused_attention_csr``: H = 4, F = 32 and H = 1, F = 41),
it launches the kernel over work lists of cap K = 64 … 1024 and over one
cap above the largest in-degree (no row split: one warp per row, the
layout before the work list), and B2 also at one head per warp. Each
output is held against the plain version (the tolerances of
``chip_smoke.py``); each time is the device alone, warm, median of 20
CUDA-event timings (``chip_smoke.time_device_ms``). It also reports the
host time of one wrapper call and of its pieces, enqueue only, beside
``torch.sparse.mm``'s. One JSON line per row; the card's name and power
limit first.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import B1_MAIN, B2_SHAPES, emit, max_err  # noqa: E402
from chip_smoke import time_device_ms  # noqa: E402

CAPS = (64, 128, 256, 512, 1024)


def host_us(fn, n: int = 200) -> float:
    """Median host time of one ``fn`` call (enqueue only), in µs."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _enter_device(dev) -> None:
    with torch.cuda.device(dev):
        pass


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rowsplit_sweep: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.kernels.common import check_operand, stream_handle
    from repro_torch.kernels.edge_softmax.ops import (
        _launch_attention, fused_attention_csr, fused_attention_plain,
        heads_per_warp)
    from repro_torch.kernels.rowsplit import build_row_split, row_split
    from repro_torch.kernels.spmm.ops import _launch_spmm, spmm_csr, spmm_plain
    from repro_torch.models.gnn.common import make_bundle

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = make_node_dataset("reddit-like", device="cuda")[0]
    max_deg = int(g.host.in_degrees.max())
    lists = {K: build_row_split(g.indptr_dst, K)
             for K in CAPS + (max_deg + 1,)}
    for K, rs in lists.items():
        emit({"phase": "work_list", "K": K, "segments": rs.n_segments,
              "split_rows": rs.n_split, "partial_slots": rs.n_partials})
    gen = torch.Generator().manual_seed(0)
    w = make_bundle(g).gcn_norm.index_select(0, g.long("eid")).contiguous()

    for d, red in B1_MAIN:
        mean = red == "mean"
        weight = None if mean else w
        B = torch.randn(g.n_src, d, generator=gen).cuda()
        ref = spmm_plain(g, B, weight, mean)
        tol = 1e-5 + 1e-5 * float(ref.abs().max())
        for K, rs in lists.items():
            err = max_err(_launch_spmm(g, B, weight, mean, rs), ref)
            if not err <= tol:
                raise AssertionError(f"spmm K={K} d={d}: {err} > {tol}")
            emit({"phase": "sweep", "kernel": "spmm_csr", "d": d,
                  "reduce": red, "K": K, "max_abs_err": err,
                  "device_ms": time_device_ms(
                      lambda: _launch_spmm(g, B, weight, mean, rs), False)})
        vals = ((1.0 / g.in_degrees.clamp(min=1).float()).index_select(
            0, g.long("dst")) if mean else weight)
        A = torch.sparse_csr_tensor(g.long("indptr_dst"), g.long("src"),
                                    vals, size=(g.n_dst, g.n_src))
        dev = B.device
        emit({"phase": "host", "kernel": "spmm_csr", "d": d, "reduce": red,
              "wrapper_us": host_us(lambda: spmm_csr(g, B, weight, mean)),
              "sparse_mm_us": host_us(lambda: torch.sparse.mm(A, B)),
              "check_operand_us": host_us(lambda: check_operand(
                  "k", "B", B, torch.float32, (g.n_src, None), dev)),
              "row_split_us": host_us(lambda: row_split(g)),
              "empty_us": host_us(lambda: torch.empty(
                  (g.n_dst, d), dtype=torch.float32, device=dev)),
              "device_ctx_us": host_us(lambda: _enter_device(dev)),
              "stream_handle_us": host_us(lambda: stream_handle(dev))})

    for H, F in B2_SHAPES:
        el = torch.randn(g.n_src, H, generator=gen).cuda()
        er = torch.randn(g.n_dst, H, generator=gen).cuda()
        z = torch.randn(g.n_src, H, F, generator=gen).cuda()
        ref = fused_attention_plain(g, el, er, z, 0.2)
        tol = 1e-5 + 1e-4 * float(ref.abs().max())
        for hg in sorted({1, heads_per_warp(H, F)}):
            for K, rs in lists.items():
                err = max_err(_launch_attention(g, el, er, z, 0.2, hg, rs),
                              ref)
                if not err <= tol:
                    raise AssertionError(f"attention K={K} H={H}: {err}")
                emit({"phase": "sweep", "kernel": "fused_attention_csr",
                      "H": H, "F": F, "heads_per_warp": hg, "K": K,
                      "max_abs_err": err,
                      "device_ms": time_device_ms(
                          lambda: _launch_attention(g, el, er, z, 0.2, hg,
                                                    rs), False)})
        emit({"phase": "host", "kernel": "fused_attention_csr", "H": H,
              "F": F, "wrapper_us": host_us(
                  lambda: fused_attention_csr(g, el, er, z, 0.2))})
    emit({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
