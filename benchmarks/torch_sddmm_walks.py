"""Time the port's B3 (gSDDMM) kernel under its two edge walks on one H100.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 benchmarks/torch_sddmm_walks.py

On ``reddit-like`` with self-loops, at each B3 shape of ``chip_smoke.py``
(GAT multipass's add u,v / sub e,v / div e,v at widths 4 and 1, and mul,
dot and copy), it launches the port's kernel, which walks caller edge
order (``src/repro_torch/kernels/csrc/sddmm_csr.cu``), and the kernel's
first version, which walks canonical (dst-sorted) order and writes
through ``eid`` (``benchmarks/csrc/sddmm_canonical.cu``, never on the
port's path). Both are held against the plain version (exact, dot within
1e-5 + 1e-5·max|ref|) and timed on the device alone, warm and with L2
flushed (``chip_smoke.time_device_ms``), beside the same timing of a
launch that does nothing (a one-float fill). It then reports the host
time of one wrapper call and of its pieces, enqueue only, beside
``index_select``'s. One JSON line per row; the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CANONICAL_SRC = os.path.join(ROOT, "benchmarks", "csrc",
                             "sddmm_canonical.cu")


def _canonical_fn():
    from repro_torch.kernels import _build

    fn = _build.library(CANONICAL_SRC).sddmm_canonical_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sddmm_canonical(g, op: str, lhs_target: str, lhs: torch.Tensor,
                    rhs_target: Optional[str] = None,
                    rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3 in canonical order, ``out[eid[k]] = lhs[idx_l[k]] ⊗
    rhs[idx_r[k]]``, on operands ``sddmm_csr`` accepts (unchecked here).
    Counts nothing."""
    from repro_torch.kernels.common import ptr, raise_on_error, stream_handle
    from repro_torch.kernels.sddmm.ops import OPS, TARGET_INDEX, out_width

    dl = lhs.shape[1]
    dr = 0 if rhs is None else rhs.shape[1]
    out = torch.empty((g.n_edges, out_width(op, dl, dr)),
                      dtype=torch.float32, device=lhs.device)
    idx_r = None if rhs is None else getattr(g, TARGET_INDEX[rhs_target])
    rc = _canonical_fn()(ptr(getattr(g, TARGET_INDEX[lhs_target])),
                         ptr(idx_r), ptr(g.eid), ptr(lhs), ptr(rhs),
                         ptr(out), g.n_edges, dl, dr, OPS[op],
                         stream_handle(lhs.device))
    raise_on_error("sddmm_canonical", rc)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sddmm_walks: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from chip_smoke import B3_SHAPES, b3_operands, emit, max_err
    from chip_smoke import time_device_ms
    from benchmarks.torch_rowsplit_sweep import host_us
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import (check_operand, device_guard,
                                            stream_handle)
    from repro_torch.kernels.sddmm.ops import sddmm_csr, sddmm_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    _build.build(["sddmm_csr", CANONICAL_SRC])
    g = make_node_dataset("reddit-like", device="cuda")[0]
    gen = torch.Generator().manual_seed(0)
    for op, lt, rt, d in B3_SHAPES:
        args = b3_operands(g, gen, op, lt, rt, d)
        ref = sddmm_plain(*args)
        tol = (1e-5 + 1e-5 * float(ref.abs().max())) if op == "dot" else 0.0
        row = {"phase": "walks", "op": op, "lhs": lt, "rhs": rt, "d": d}
        for walk, fn in (("caller", sddmm_csr), ("canonical",
                                                 sddmm_canonical)):
            err = max_err(fn(*args), ref)
            if not err <= tol:
                raise AssertionError(f"{walk} {op} {lt},{rt} d={d}: {err}")
            row[f"{walk}_max_abs_err"] = err
            for cold in (False, True):
                row[f"{walk}_{'cold' if cold else 'device'}_ms"] = (
                    time_device_ms(lambda: fn(*args), cold))
        emit(row)

    # the floor of a device-only timing: one launch that does nothing
    tiny = torch.zeros(1, device="cuda")
    emit({"phase": "floor", "fill_1_float_device_ms": time_device_ms(
        tiny.zero_, False)})

    # the wrapper's host time at the main path's first shape, and its pieces
    args = b3_operands(g, gen, "add", "u", "v", 4)
    lhs, dev = args[3], args[3].device
    src_caller = g.src_caller.long()
    emit({"phase": "host", "kernel": "sddmm_csr", "op": "add", "d": 4,
          "wrapper_us": host_us(lambda: sddmm_csr(*args)),
          "index_select_us": host_us(
              lambda: lhs.index_select(0, src_caller)),
          "check_operand_us": host_us(lambda: check_operand(
              "k", "lhs", lhs, torch.float32, (g.n_src, None), dev)),
          "empty_us": host_us(lambda: torch.empty(
              (g.n_edges, 4), dtype=torch.float32, device=dev)),
          "device_guard_us": host_us(lambda: device_guard(dev)),
          "stream_handle_us": host_us(lambda: stream_handle(dev))})
    emit({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
