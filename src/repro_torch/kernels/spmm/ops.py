"""Copy-Reduce SpMM (ROADMAP B1): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/spmm/kernel.py::_spmm_kernel`` (the TPU
kernel built by ``spmm_pallas_call`` and launched from
``repro/kernels/spmm/ops.py::spmm``). The CUDA source is
``../csrc/spmm_csr.cu``: one warp per segment of the row-segment work
list (``../rowsplit.py``, at most ``SEGMENT_EDGES`` edges) walks the
CSR by destination directly, so no TilePack is built; a heavy row's
segments are combined in edge order by a second launch of the same call.
Its header says what bounds it on the H100 (bytes) and how the design
keeps gathers in flight.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..common import (check_operand, device_guard, ptr, raise_on_error,
                      stream_handle)
from ..rowsplit import row_split

__all__ = ["spmm", "spmm_csr", "spmm_plain"]

_KERNEL = "spmm_csr"


def _lib():
    lib = _build.library(_KERNEL)
    fn = lib.spmm_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 6 + [
                           ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def spmm_plain(g, B: torch.Tensor, weight: Optional[torch.Tensor] = None,
               mean: bool = False) -> torch.Tensor:
    """``C[v] = Σ_{e=(u→v)} w_e·B[u]`` (÷ max(deg, 1) when ``mean``) with
    ``index_select`` + ``index_add_``; ``weight`` in canonical edge
    order. Empty rows are 0. The reference the kernel is held against."""
    msg = B.index_select(0, g.long("src"))
    if weight is not None:
        msg = msg * weight[:, None].to(msg.dtype)
    out = torch.zeros((g.n_dst,) + tuple(B.shape[1:]), dtype=B.dtype,
                      device=B.device)
    out.index_add_(0, g.long("dst"), msg)
    if mean:
        out = out / g.in_degrees.clamp(min=1).to(B.dtype)[:, None]
    return out


def spmm_csr(g, B: torch.Tensor, weight: Optional[torch.Tensor] = None,
             mean: bool = False) -> torch.Tensor:
    """B1 wrapper: the CUDA kernel for a CUDA ``B``, the plain version for
    a CPU ``B``. ``B``: (n_src, d) fp32; ``weight``: (n_edges,) fp32 in
    canonical edge order, or None. Returns (n_dst, d).

    ``spmm_csr.launches`` counts calls that launched the kernel (CUDA
    branch only); a heavy row's combine pass is part of the same call.
    """
    if B.device.type == "cpu":
        return spmm_plain(g, B, weight, mean)
    if B.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {B.device}")
    dev = B.device
    check_operand(_KERNEL, "indptr_dst", g.indptr_dst, torch.int32,
                  (g.n_dst + 1,), dev)
    check_operand(_KERNEL, "src", g.src, torch.int32, (g.n_edges,), dev)
    check_operand(_KERNEL, "B", B, torch.float32, (g.n_src, None), dev)
    if weight is not None:
        check_operand(_KERNEL, "weight", weight, torch.float32,
                      (g.n_edges,), dev)
    if g.n_dst * B.shape[1] == 0:
        return torch.empty((g.n_dst, B.shape[1]), dtype=torch.float32,
                           device=dev)
    out = _launch_spmm(g, B, weight, mean, row_split(g))
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0


def _launch_spmm(g, B: torch.Tensor, weight: Optional[torch.Tensor],
                 mean: bool, rs) -> torch.Tensor:
    """Launch B1 on checked operands over work list ``rs`` (the wrapper
    passes the graph's cached list; ``benchmarks/torch_rowsplit_sweep.py``
    also times other caps K). Counts nothing."""
    dev = B.device
    d = B.shape[1]
    out = torch.empty((g.n_dst, d), dtype=torch.float32, device=dev)
    partial = (torch.empty((rs.n_partials, d), dtype=torch.float32,
                           device=dev) if rs.n_partials else None)
    fn = _lib()
    with device_guard(dev):
        rc = fn(ptr(rs.seg), rs.n_segments, ptr(rs.split), rs.n_split,
                ptr(g.indptr_dst), ptr(g.src), ptr(weight), ptr(B), ptr(out),
                ptr(partial), d, int(bool(mean)), stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    return out


def spmm(g, B: torch.Tensor, reduce_op: str = "sum",
         weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy-Reduce ``C[v] = ⊕_(u→v) w·B[u]`` for ⊕ ∈ {sum, mean}.

    ``weight``: optional (n_edges,) per-edge scalar in the CALLER's edge
    order (covers ``u_mul_e_add_v`` with scalar gates), as in
    ``repro.kernels.spmm.ops.spmm``.
    """
    if reduce_op not in ("sum", "mean"):
        raise ValueError("spmm supports sum/mean")
    w = None
    if weight is not None:
        w = weight.reshape(-1).index_select(0, g.long("eid")).contiguous()
    return spmm_csr(g, B, w, mean=reduce_op == "mean")
