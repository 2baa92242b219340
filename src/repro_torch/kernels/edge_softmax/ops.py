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
  The CUDA source is ``../csrc/edge_softmax_csr.cu``: over the same work
  list at K = 128, 16 lanes per segment (two segments per warp) over
  (edge, head) fold the logits into an online (max, sum) and write α
  through ``eid`` in caller order (no stripe, no scatter-back); a heavy
  row's segments leave their (max, sum) pairs in a workspace, and a
  second launch of the same call, one block per such row, merges them in
  segment order and writes the row's α.

Each source's header says what bounds it on the H100 (bytes) and what
its design does about hub rows and narrow head counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...substrate.nn import leaky_relu
from .. import _build
from ..common import (check_operand, device_guard, graph_index_ptrs, ptr,
                      raise_on_error, stream_handle)
from ..rowsplit import row_split

__all__ = ["fused_attention_csr", "fused_attention_plain", "attention_alpha",
           "MAX_F",
           "heads_per_warp", "edge_softmax_csr", "edge_softmax_plain",
           "MAX_HEADS", "SOFTMAX_SEGMENT_EDGES"]

_KERNEL = "fused_attention_csr"
_SOFTMAX_KERNEL = "edge_softmax_csr"
MAX_F = 128  # a warp's lanes hold ≤ 128 floats of z[src] (4 per lane)
_MAX_HEADS_PER_WARP = 8  # the kernel's register state for heads (HMAX)
MAX_HEADS = 4096  # B5's merge keeps a (max, sum) pair per head in smem
# B5's work-list cap: with 16 lanes per segment, K = 128 beat 256 and 512
# at H = 4 and 1 (chip_smoke's sweep rows; PERF.md §6)
SOFTMAX_SEGMENT_EDGES = 128
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


def attention_alpha(g, el: torch.Tensor, er: torch.Tensor,
                    slope: float = 0.2):
    """Canonical-order α (E, H) — the softmax over each destination's
    in-edges of ``leaky(el[u] + er[v])`` — and the raw logits before the
    leaky-relu (for its mask), as ``repro.core.edge_softmax.
    _attention_alpha`` computes them: gather, ``scatter_reduce("amax")``,
    exp, ``index_add_``, divide by max(sum, 1e-38)."""
    src, dst = g.long("src"), g.long("dst")
    H = el.shape[-1]
    m_raw = el.index_select(0, src) + er.index_select(0, dst)   # (E, H)
    m = leaky_relu(m_raw, slope)
    idx = dst[:, None].expand(-1, H)
    mx = torch.full((g.n_dst, H), float("-inf"), dtype=m.dtype,
                    device=m.device)
    mx = mx.scatter_reduce(0, idx, m, "amax", include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.exp(m - mx.index_select(0, dst))
    zs = torch.zeros((g.n_dst, H), dtype=m.dtype, device=m.device)
    zs.index_add_(0, dst, ex)
    return ex / zs.clamp(min=_TINY).index_select(0, dst), m_raw


def fused_attention_plain(g, el: torch.Tensor, er: torch.Tensor,
                          z: torch.Tensor, slope: float = 0.2
                          ) -> torch.Tensor:
    """:func:`attention_alpha`, then ``index_add_``: ``out[v,h,:] = Σ_e
    α_e·z[u,h,:]``. Zero-degree rows are 0. ``el`` (n_src, H), ``er``
    (n_dst, H), ``z`` (n_src, H, F) → (n_dst, H, F)."""
    alpha, _ = attention_alpha(g, el, er, slope)
    msg = alpha[..., None] * z.index_select(0, g.long("src"))  # (E, H, F)
    out = torch.zeros((g.n_dst,) + tuple(z.shape[1:]), dtype=z.dtype,
                      device=z.device)
    out.index_add_(0, g.long("dst"), msg)
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
    dev = g.device
    if z.ndim != 3:
        raise ValueError(f"{_KERNEL}: z must be (n_src, H, F), got "
                         f"{tuple(z.shape)}")
    _, H, F = z.shape
    if F > MAX_F:
        raise ValueError(f"{_KERNEL}: F={F} > {MAX_F} is not supported")
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
    idx = graph_index_ptrs(_KERNEL, g)
    fn = _lib()
    with device_guard(dev):
        rc = fn(ptr(rs.seg), rs.n_segments, ptr(rs.split), rs.n_split,
                idx["src"], ptr(el), ptr(er), ptr(z), ptr(out), pacc, pml,
                H, F, int(hg), float(slope), stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    return out


@functools.cache
def _softmax_lib():
    lib = _build.library(_SOFTMAX_KERNEL)
    fn = lib.edge_softmax_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 5 + [
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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

    ``edge_softmax_csr.launches`` counts calls that launched the kernel
    (CUDA only); a heavy row's merge pass is part of the same call.
    """
    if logits.device.type == "cpu":
        return edge_softmax_plain(g, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"{_SOFTMAX_KERNEL}: unsupported device "
                         f"{logits.device}")
    check_operand(_SOFTMAX_KERNEL, "logits", logits, torch.float32,
                  (g.n_edges, None), g.device)
    if logits.shape[1] > MAX_HEADS:
        raise ValueError(f"{_SOFTMAX_KERNEL}: H={logits.shape[1]} > "
                         f"{MAX_HEADS} is not supported")
    if logits.numel() == 0:
        return torch.empty_like(logits)
    out = _launch_softmax(g, logits, row_split(g, SOFTMAX_SEGMENT_EDGES))
    edge_softmax_csr.launches += 1
    return out


edge_softmax_csr.launches = 0


def _launch_softmax(g, logits: torch.Tensor, rs, lanes: int = 0
                    ) -> torch.Tensor:
    """Launch B5 on checked logits over work list ``rs`` with ``lanes``
    lanes per segment (0: the kernel's default; the wrapper passes the
    graph's cached list and 0, ``chip_smoke.py`` also times other caps K
    and lane counts). Counts nothing."""
    dev = logits.device
    H = logits.shape[1]
    out = torch.empty_like(logits)
    # the split rows' segments' (max, sum) pairs, (n_partials, H, 2)
    pml = (torch.empty(rs.n_partials * H * 2, dtype=torch.float32,
                       device=dev) if rs.n_partials else None)
    idx = graph_index_ptrs(_SOFTMAX_KERNEL, g)
    fn = _softmax_lib()
    with device_guard(dev):
        rc = fn(ptr(rs.seg), rs.n_segments, ptr(rs.split), rs.n_split,
                idx["indptr_dst"], idx["eid"], ptr(logits), ptr(out),
                ptr(pml), H, int(lanes), stream_handle(dev))
    raise_on_error(_SOFTMAX_KERNEL, rc)
    return out
