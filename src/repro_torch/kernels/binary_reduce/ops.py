"""Fused Binary-Reduce (ROADMAP B4): the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``src/repro/kernels/binary_reduce/kernel.py::_br_kernel`` (the
TPU kernel built by ``binary_reduce_pallas_call`` and launched from
``repro/kernels/binary_reduce/ops.py::binary_reduce``). The CUDA source
is ``../csrc/binary_reduce_csr.cu``: over the row-segment work list
(``../rowsplit.py``) at ``BR_SEGMENT_EDGES`` edges, 16 lanes per segment
at d <= 16 (two segments per warp), it walks the CSR by destination and
reads the edge operand in caller order through ``eid``, so no TilePack is
built and no edge feature is permuted first; a heavy row's segments'
sums are folded in edge order, in the same launch, by whichever of them
finishes last. Its header says what bounds it on the H100 (bytes) and how
narrow rows keep the warp's lanes busy. The edge operand's width divides
the node width: ``d`` (element for element), 1 (a scalar per edge) or a
head count ``H`` (a value per head over its ``d / H`` consecutive
features: GAT's per-head α times its (n, H, F) features as (n, H·F)).
Its operands are all fp32 or all bf16 (a bf16 step's pairs); the output
takes their dtype, and both the kernel and the plain version sum in fp32
and round once.
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Dict, Optional

import torch

from ...optim.precision import accum_dtype
from .. import _build
from ..common import (FEATURE_DTYPES, check_operand, device_guard,
                      graph_index_ptrs, ptr, raise_on_error, stream_handle)
from ..rowsplit import row_split

__all__ = ["BINOPS", "BR_SEGMENT_EDGES", "binary_reduce",
           "binary_reduce_csr", "binary_reduce_plain"]

_KERNEL = "binary_reduce_csr"
# B4's work-list cap: B5's (edge_softmax.ops.SOFTMAX_SEGMENT_EDGES), so a
# GAT refresh builds no list of its own; chip_smoke's sweep rows time 256
BR_SEGMENT_EDGES = 128
BINOPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "copy_lhs": 4,
          "copy_rhs": 5}

_PLAIN = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "copy_lhs": lambda a, b: a,
    "copy_rhs": lambda a, b: b,
}


def _lib(dtype: torch.dtype = torch.float32):
    lib = _build.library(_KERNEL)
    fn = getattr(lib, {torch.float32: "binary_reduce_csr_f32",
                       torch.bfloat16: "binary_reduce_csr_bf16"}[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def binary_reduce_plain(g, B: Optional[torch.Tensor], E: torch.Tensor,
                        binop: str = "mul", mean: bool = False
                        ) -> torch.Tensor:
    """``C[v] = Σ_{e=(u→v)} B[u] ⊗ E[e]`` (÷ max(deg, 1) when ``mean``)
    with ``index_select`` + ``index_add_``; ``E`` (n_edges, de) in caller
    edge order with ``de`` dividing d (feature j takes ``E[e, j / (d /
    de)]``), ``B`` (n_src, d) or None for ``copy_rhs``. Empty rows are 0.
    The output takes ``B``'s dtype (``E``'s for ``copy_rhs``);
    half-precision operands sum in fp32 and are rounded once, as the
    kernel does. The reference the kernel is held against."""
    dtype = E.dtype if B is None else B.dtype
    acc = accum_dtype(dtype if B is None else torch.promote_types(
        B.dtype, E.dtype))
    e_val = E.index_select(0, g.long("eid")).to(acc)
    b_val = None if B is None else B.index_select(0, g.long("src")).to(acc)
    de = e_val.shape[-1]
    if B is not None and de not in (1, B.shape[-1]):    # a value per head
        b_val = b_val.reshape(-1, de, B.shape[-1] // de)
        e_val = e_val[:, :, None]
    msg = _PLAIN[binop](b_val, e_val)
    if B is not None:
        msg = msg.expand(-1, *b_val.shape[1:]).reshape(-1, B.shape[-1])
    out = torch.zeros((g.n_dst, msg.shape[-1]), dtype=acc,
                      device=msg.device)
    out.index_add_(0, g.long("dst"), msg)
    if mean:
        out = out / g.in_degrees.clamp(min=1).to(acc)[:, None]
    return out.to(dtype)


def binary_reduce_csr(g, B: Optional[torch.Tensor], E: torch.Tensor,
                      binop: str = "mul", mean: bool = False
                      ) -> torch.Tensor:
    """B4 wrapper: the CUDA kernel for a CUDA ``E``, the plain version for
    a CPU ``E``. ``B``: (n_src, d), None only for ``copy_rhs``; ``E``:
    (n_edges, de) in caller edge order, ``de`` dividing d (d, 1, or a
    value per head); both fp32 or both bf16. Returns (n_dst, d) in their
    dtype.

    ``binary_reduce_csr.launches`` counts calls that launched the kernel
    (CUDA only).
    """
    if binop not in BINOPS:
        raise ValueError(f"{_KERNEL}: unknown binop {binop!r}; expected one "
                         f"of {tuple(BINOPS)}")
    if B is None and binop != "copy_rhs":
        raise ValueError(f"{_KERNEL}: binop {binop!r} needs the node "
                         f"operand B")
    if E.device.type == "cpu":
        return binary_reduce_plain(g, B, E, binop, mean)
    if E.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {E.device}")
    dev = g.device
    check_operand(_KERNEL, "E", E, FEATURE_DTYPES, (g.n_edges, None), dev)
    de = E.shape[1]
    d = de
    if B is not None:
        check_operand(_KERNEL, "B", B, E.dtype, (g.n_src, None), dev)
        d = B.shape[1]
    if de == 0 or d % de:
        raise ValueError(f"{_KERNEL}: edge feature width {de} does not "
                         f"divide the node width {d}")
    if g.n_dst * d == 0:
        return torch.empty((g.n_dst, d), dtype=E.dtype, device=dev)
    out = _launch_br(g, B, E, binop, mean, row_split(g, BR_SEGMENT_EDGES))
    binary_reduce_csr.launches += 1
    return out


binary_reduce_csr.launches = 0


# per graph and stream: the split rows' counts of finished segments, all 0
# between launches (the kernel's fold resets them); one array per stream,
# so launches on two streams never share one
_counters: "weakref.WeakKeyDictionary[object, Dict[int, torch.Tensor]]" = (
    weakref.WeakKeyDictionary())
_counters_lock = threading.Lock()


def _row_counters(g, stream: int) -> torch.Tensor:
    per_graph = _counters.get(g)
    cnt = None if per_graph is None else per_graph.get(stream)
    if cnt is None:
        with _counters_lock:
            per_graph = _counters.setdefault(g, {})
            cnt = per_graph.get(stream)
            if cnt is None:
                cnt = torch.zeros(g.n_dst, dtype=torch.int32,
                                  device=g.device)
                per_graph[stream] = cnt
    return cnt


def _launch_br(g, B: Optional[torch.Tensor], E: torch.Tensor, binop: str,
               mean: bool, rs, lanes: int = 0) -> torch.Tensor:
    """Launch B4 on checked operands over work list ``rs`` with ``lanes``
    lanes per segment (0: the kernel's default, max(lpe, 16); the wrapper
    passes the graph's cached list and 0, ``chip_smoke.py`` also times
    other caps K and lane counts). Counts nothing."""
    dev = E.device
    d = E.shape[1] if B is None else B.shape[1]
    out = torch.empty((g.n_dst, d), dtype=E.dtype, device=dev)
    partial = (torch.empty((rs.n_partials, d), dtype=torch.float32,
                           device=dev) if rs.n_partials else None)
    idx = graph_index_ptrs(_KERNEL, g)
    fn = _lib(E.dtype)
    with device_guard(dev):
        stream = stream_handle(dev)
        cnt = _row_counters(g, stream) if rs.n_split else None
        rc = fn(ptr(rs.seg), rs.n_segments, rs.n_split, idx["indptr_dst"],
                idx["src"], idx["eid"], ptr(B), ptr(E), ptr(out),
                ptr(partial), ptr(cnt), rs.K, d, E.shape[1], BINOPS[binop],
                int(bool(mean)), int(lanes), stream)
    raise_on_error(_KERNEL, rc)
    return out


def binary_reduce(g, B: Optional[torch.Tensor], E: torch.Tensor,
                  binop: str = "mul", reduce_op: str = "sum"
                  ) -> torch.Tensor:
    """Fused ``u_⊗_e_{add,mean}_v``: ``C[v] = ⊕_(u→v)=e B[u] ⊗ E[e]``, as
    in ``repro.kernels.binary_reduce.ops.binary_reduce``.

    ``E``: (n_edges, de) or (n_edges,) in the caller's edge order, ``de``
    dividing d: a scalar edge feature broadcasts across the feature dim, a
    value per head across its head's features. ``B`` may be None for
    ``copy_rhs`` (``e_copy_*_v``), where the JAX package passes a zero
    node operand that is never read.
    """
    if reduce_op not in ("sum", "mean"):
        raise ValueError("binary_reduce supports sum/mean")
    E = E.reshape(E.shape[0], -1)
    if B is not None and (E.shape[1] == 0 or B.shape[-1] % E.shape[1]):
        raise ValueError(f"edge feature dim {E.shape[1]} does not divide "
                         f"node dim {B.shape[-1]}")
    return binary_reduce_csr(g, None if B is None else B.contiguous(),
                             E.contiguous(), binop, mean=reduce_op == "mean")
