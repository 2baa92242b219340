"""Fused GAT attention (ROADMAP B2, forward) and edge softmax (B5): the
CUDA kernels' wrappers and their plain PyTorch versions.

* ``fused_attention_csr`` replaces
  ``src/repro/kernels/edge_softmax/kernel.py::_attention_kernel`` (built
  by ``fused_attention_pallas_call``, launched once per pow2 degree class
  from ``repro/kernels/edge_softmax/ops.py``). The CUDA source is
  ``../csrc/fused_attention_csr.cu``: one warp per segment of the
  row-segment work list (``../rowsplit.py``) and group of heads runs an
  online softmax over the segment's CSR edges, so no ELL stripe is
  packed; a heavy row's segments are merged in edge order (flash
  decoding) by a second launch of the same call.
* ``edge_softmax_csr`` replaces ``::_softmax_kernel`` (built by
  ``edge_softmax_pallas_call``, launched from ``ops.py::edge_softmax``).
  The CUDA source is ``../csrc/edge_softmax_csr.cu``: one warp per
  destination row, lanes over (edge, head), reading the logits and
  writing α through ``eid`` in caller order — no stripe, no scatter-back.

Each source's header says what bounds it on the H100 (bytes) and what
its design does about hub rows and narrow head counts.
"""
from __future__ import annotations

import ctypes

import torch

from ...substrate.nn import leaky_relu
from .. import _build
from ..common import (check_operand, device_guard, ptr, raise_on_error,
                      stream_handle)
from ..rowsplit import row_split

__all__ = ["fused_attention_csr", "fused_attention_plain", "MAX_F",
           "heads_per_warp", "edge_softmax_csr", "edge_softmax_plain"]

_KERNEL = "fused_attention_csr"
_SOFTMAX_KERNEL = "edge_softmax_csr"
MAX_F = 128  # a warp's lanes hold ≤ 128 floats of z[src] (4 per lane)
_MAX_HEADS_PER_WARP = 8  # the kernel's register state for heads (HMAX)
# the TPU kernel's mask value and sum floor (kernel.py:20, :31)
_NEG = -1e30
_TINY = 1e-38


def _lib():
    lib = _build.library(_KERNEL)
    fn = lib.fused_attention_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 7 + [
                           ctypes.c_int] * 3 + [ctypes.c_float,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def heads_per_warp(H: int, F: int) -> int:
    """Heads one warp of the kernel covers: as many as fit in the lanes'
    128 floats of ``z[src]``, at most 8 (and at least 1)."""
    return max(1, min(H, MAX_F // max(F, 1), _MAX_HEADS_PER_WARP))


def fused_attention_plain(g, el: torch.Tensor, er: torch.Tensor,
                          z: torch.Tensor, slope: float = 0.2
                          ) -> torch.Tensor:
    """Gather, leaky-relu, ``scatter_reduce("amax")``, exp, ``index_add_``:
    ``out[v,h,:] = Σ_e α_e·z[u,h,:]`` with α the softmax over v's in-edges
    of ``leaky(el[u]+er[v])``. Zero-degree rows are 0. ``el`` (n_src, H),
    ``er`` (n_dst, H), ``z`` (n_src, H, F) → (n_dst, H, F)."""
    src, dst = g.long("src"), g.long("dst")
    H = el.shape[-1]
    m = el.index_select(0, src) + er.index_select(0, dst)       # (E, H)
    m = leaky_relu(m, slope)
    idx = dst[:, None].expand(-1, H)
    mx = torch.full((g.n_dst, H), float("-inf"), dtype=m.dtype,
                    device=m.device)
    mx = mx.scatter_reduce(0, idx, m, "amax", include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(m - mx.index_select(0, dst))
    zs = torch.zeros((g.n_dst, H), dtype=m.dtype, device=m.device)
    zs.index_add_(0, dst, ex)
    alpha = ex / zs.clamp(min=1e-38).index_select(0, dst)
    msg = alpha[..., None] * z.index_select(0, src)             # (E, H, F)
    out = torch.zeros((g.n_dst,) + tuple(z.shape[1:]), dtype=z.dtype,
                      device=z.device)
    out.index_add_(0, dst, msg)
    return out


def fused_attention_csr(g, el: torch.Tensor, er: torch.Tensor,
                        z: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """B2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. fp32 only; F ≤ :data:`MAX_F`.

    ``fused_attention_csr.launches`` counts calls that launched the
    kernel (CUDA only); a heavy row's merge pass is part of the same call.
    """
    if z.device.type == "cpu":
        return fused_attention_plain(g, el, er, z, slope)
    if z.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {z.device}")
    dev = z.device
    if z.ndim != 3:
        raise ValueError(f"{_KERNEL}: z must be (n_src, H, F), got "
                         f"{tuple(z.shape)}")
    _, H, F = z.shape
    if F > MAX_F:
        raise ValueError(f"{_KERNEL}: F={F} > {MAX_F} is not supported")
    check_operand(_KERNEL, "indptr_dst", g.indptr_dst, torch.int32,
                  (g.n_dst + 1,), dev)
    check_operand(_KERNEL, "src", g.src, torch.int32, (g.n_edges,), dev)
    check_operand(_KERNEL, "el", el, torch.float32, (g.n_src, H), dev)
    check_operand(_KERNEL, "er", er, torch.float32, (g.n_dst, H), dev)
    check_operand(_KERNEL, "z", z, torch.float32, (g.n_src, H, F), dev)
    if g.n_dst * H * F == 0:
        return torch.empty((g.n_dst, H, F), dtype=torch.float32, device=dev)
    out = _launch_attention(g, el, er, z, slope, heads_per_warp(H, F),
                            row_split(g))
    fused_attention_csr.launches += 1
    return out


fused_attention_csr.launches = 0


def _launch_attention(g, el: torch.Tensor, er: torch.Tensor,
                      z: torch.Tensor, slope: float, hg: int, rs
                      ) -> torch.Tensor:
    """Launch B2 on checked operands with ``hg`` heads per warp over work
    list ``rs`` (the wrapper passes :func:`heads_per_warp` and the graph's
    cached list; ``benchmarks/torch_rowsplit_sweep.py`` also times one
    head per warp and other caps K). Counts nothing."""
    dev = z.device
    _, H, F = z.shape
    out = torch.empty((g.n_dst, H, F), dtype=torch.float32, device=dev)
    # one workspace: (n_partials, H, F) accumulators, then (n_partials, H,
    # 2) running (max, sum) pairs
    pacc = pml = None
    if rs.n_partials:
        ws = torch.empty(rs.n_partials * H * (F + 2), dtype=torch.float32,
                         device=dev)
        pacc = ws.data_ptr()
        pml = pacc + 4 * rs.n_partials * H * F
    fn = _lib()
    with device_guard(dev):
        rc = fn(ptr(rs.seg), rs.n_segments, ptr(rs.split), rs.n_split,
                ptr(g.src), ptr(el), ptr(er), ptr(z), ptr(out), pacc, pml,
                H, F, int(hg), float(slope), stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    return out


def _softmax_lib():
    lib = _build.library(_SOFTMAX_KERNEL)
    fn = lib.edge_softmax_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def edge_softmax_plain(g, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of ``logits`` (n_edges, H), caller edge order, over each
    destination's in-edges, in canonical order: gather by ``eid``,
    ``scatter_reduce("amax")`` from −1e30, exp, ``index_add_``, divide by
    max(sum, 1e-38), un-permute by ``eid_inv``. The −1e30 floor and the
    1e-38 floor are the Pallas kernel's; on logits above −1e30 this is
    also ``repro.core.edge_softmax.edge_softmax_fused``. The reference the
    kernel is held against."""
    dst = g.long("dst")
    x = logits.index_select(0, g.long("eid"))                    # (E, H)
    mx = torch.full((g.n_dst,) + tuple(x.shape[1:]), _NEG, dtype=x.dtype,
                    device=x.device)
    idx = dst.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    mx = mx.scatter_reduce(0, idx, x, "amax", include_self=True)
    ex = torch.exp(x - mx.index_select(0, dst))
    zs = torch.zeros_like(mx)
    zs.index_add_(0, dst, ex)
    out = ex / zs.clamp(min=_TINY).index_select(0, dst)
    return out.index_select(0, g.long("eid_inv"))


def edge_softmax_csr(g, logits: torch.Tensor) -> torch.Tensor:
    """B5 wrapper: the CUDA kernel for CUDA ``logits``, the plain version
    for CPU ``logits``. ``logits``: (n_edges, H) fp32 in caller edge
    order; returns α of the same shape and order.

    ``edge_softmax_csr.launches`` counts kernel launches (CUDA only).
    """
    if logits.device.type == "cpu":
        return edge_softmax_plain(g, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"{_SOFTMAX_KERNEL}: unsupported device "
                         f"{logits.device}")
    dev = logits.device
    check_operand(_SOFTMAX_KERNEL, "indptr_dst", g.indptr_dst, torch.int32,
                  (g.n_dst + 1,), dev)
    check_operand(_SOFTMAX_KERNEL, "eid", g.eid, torch.int32, (g.n_edges,),
                  dev)
    check_operand(_SOFTMAX_KERNEL, "logits", logits, torch.float32,
                  (g.n_edges, None), dev)
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    fn = _softmax_lib()
    with device_guard(dev):
        rc = fn(ptr(g.indptr_dst), ptr(g.eid), ptr(logits), ptr(out),
                g.n_dst, logits.shape[1], stream_handle(dev))
    raise_on_error(_SOFTMAX_KERNEL, rc)
    edge_softmax_csr.launches += 1
    return out


edge_softmax_csr.launches = 0
