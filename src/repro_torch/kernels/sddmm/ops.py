"""gSDDMM (ROADMAP B3): the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``src/repro/kernels/sddmm/kernel.py::_binary_kernel`` and
``::_copy_kernel`` (the TPU kernels built by ``sddmm_pallas_call`` and
launched from ``repro/kernels/sddmm/ops.py::sddmm``). There the caller
gathers the operands into canonical (dst-sorted) edge order, the kernel
applies ⊗ to the streams, and the caller un-permutes the result by
``eid_inv``. The CUDA source ``../csrc/sddmm_csr.cu`` walks the caller's
edge order instead, as the JAX ``gather`` plan does:
``out[e] = lhs[ia[e]] ⊗ rhs[ib[e]]``, with ``ia`` / ``ib`` the graph's
caller-order endpoints (``Graph.src_caller`` for ``u``,
``Graph.dst_caller`` for ``v``) and no index at all for ``e``. Nothing
goes through ``eid``; the output and edge operands are contiguous. Bytes
bound it on the H100 (its header says how the design meets that).

The graph's index arrays are fixed at construction, so the wrapper checks
them once per graph; each call checks only its operands. Operands are both
fp32 or both bf16, and the output takes their dtype; a bf16 op runs in
fp32 and is rounded once, in the kernel and its plain version alike.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from ...optim.precision import accum_dtype
from .. import _build
from ..common import (FEATURE_DTYPES, check_operand, device_guard,
                      graph_index_ptrs, ptr, raise_on_error, stream_handle)

__all__ = ["OPS", "TARGET_INDEX", "CALLER_INDEX", "sddmm_csr", "sddmm_plain",
           "out_width"]

_KERNEL = "sddmm_csr"
OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "dot": 4, "copy": 5}
# the canonical index array that gathers each operand target
TARGET_INDEX = {"u": "src", "v": "dst", "e": "eid"}
# the caller-order index array of each operand target; an 'e' operand is
# read at the caller edge id itself
CALLER_INDEX = {"u": "src_caller", "v": "dst_caller", "e": None}

_PLAIN = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "dot": lambda a, b: torch.sum(a * b, dim=-1, keepdim=True),
    "copy": lambda a, b: a,
}


@functools.cache
def _lib(dtype: torch.dtype = torch.float32):
    lib = _build.library(_KERNEL)
    fn = getattr(lib, {torch.float32: "sddmm_csr_f32",
                       torch.bfloat16: "sddmm_csr_bf16"}[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def out_width(op: str, dl: int, dr: Optional[int]) -> Optional[int]:
    """Width of ``op``'s output for operand widths ``dl`` / ``dr``, or
    None when the widths neither match nor broadcast from 1."""
    if op == "copy":
        return dl
    if dl != dr and 1 not in (dl, dr):
        return None
    return 1 if op == "dot" else max(dl, dr)


def sddmm_plain(g, op: str, lhs_target: str, lhs: torch.Tensor,
                rhs_target: Optional[str] = None,
                rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's two-step: gather each operand into canonical edge
    order, apply ⊗ (width-1 operands broadcast, ``dot`` gives width 1),
    un-permute by ``eid_inv`` into caller order. Half-precision operands
    are widened and the result (the operands' promoted dtype) rounded
    once, as the kernel computes in fp32. The reference the kernel is held
    against."""
    dtype = lhs.dtype if rhs is None else torch.promote_types(lhs.dtype,
                                                              rhs.dtype)
    acc = accum_dtype(dtype)
    lhs_val = lhs.index_select(0, g.long(TARGET_INDEX[lhs_target])).to(acc)
    rhs_val = (None if rhs is None else rhs.index_select(
        0, g.long(TARGET_INDEX[rhs_target])).to(acc))
    return _PLAIN[op](lhs_val, rhs_val).index_select(
        0, g.long("eid_inv")).to(dtype)


def _rows(g, target: str) -> int:
    return {"u": g.n_src, "v": g.n_dst, "e": g.n_edges}[target]


def _index(ptrs, target: str) -> Optional[int]:
    """The caller-order index array of an operand target (None: ``e``)."""
    name = CALLER_INDEX[target]
    return None if name is None else ptrs[name]


def sddmm_csr(g, op: str, lhs_target: str, lhs: torch.Tensor,
              rhs_target: Optional[str] = None,
              rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3 wrapper: the CUDA kernel for a CUDA ``lhs``, the plain version
    for a CPU ``lhs``. Operands are (rows of their target, width), both
    fp32 or both bf16, indexed by node id or caller edge id; ``rhs`` is
    None for ``copy``. Returns (n_edges, width) in caller edge order, in
    the operands' dtype.

    ``sddmm_csr.launches`` counts kernel launches (CUDA only), and
    ``sddmm_csr.op_launches`` counts them by ``op``.
    """
    if op not in OPS:
        raise ValueError(f"{_KERNEL}: unknown op {op!r}; expected one of "
                         f"{tuple(OPS)}")
    if (rhs is None) != (op == "copy"):
        raise ValueError(f"{_KERNEL}: op {op!r} "
                         f"{'takes no' if op == 'copy' else 'needs an'} rhs")
    if lhs.device.type == "cpu":
        return sddmm_plain(g, op, lhs_target, lhs, rhs_target, rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: unsupported device {lhs.device}")
    dev = g.device
    check_operand(_KERNEL, "lhs", lhs, FEATURE_DTYPES,
                  (_rows(g, lhs_target), None), dev)
    dl, dr, idx_r = lhs.shape[1], 0, None
    idx = graph_index_ptrs(_KERNEL, g)
    if rhs is not None:
        check_operand(_KERNEL, "rhs", rhs, lhs.dtype,
                      (_rows(g, rhs_target), None), dev)
        dr, idx_r = rhs.shape[1], _index(idx, rhs_target)
    d = out_width(op, dl, dr)
    if d is None or dl == 0:
        raise ValueError(f"{_KERNEL}: widths {dl} and {dr} neither match "
                         f"nor broadcast from 1")
    out = torch.empty((g.n_edges, d), dtype=lhs.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = _lib(lhs.dtype)
    with device_guard(dev):
        rc = fn(_index(idx, lhs_target), idx_r, lhs.data_ptr(), ptr(rhs),
                out.data_ptr(), g.n_edges, dl, dr, OPS[op],
                stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    sddmm_csr.launches += 1
    sddmm_csr.op_launches[op] += 1
    return out


sddmm_csr.launches = 0
sddmm_csr.op_launches = collections.Counter()
