"""gSDDMM (ROADMAP B3): the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``src/repro/kernels/sddmm/kernel.py::_binary_kernel`` and
``::_copy_kernel`` (the TPU kernels built by ``sddmm_pallas_call`` and
launched from ``repro/kernels/sddmm/ops.py::sddmm``). There the caller
gathers the operands into canonical (dst-sorted) edge order, the kernel
applies ⊗ to the streams, and the caller un-permutes the result by
``eid_inv``. The CUDA source ``../csrc/sddmm_csr.cu`` does all three in
one pass: ``out[eid[k]] = lhs[idx_l[k]] ⊗ rhs[idx_r[k]]``, with each
index array taken from its operand's target (``u`` → src, ``v`` → dst,
``e`` → eid). Its header says what bounds it on the H100 (bytes).
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from .. import _build
from ..common import (check_operand, device_guard, ptr, raise_on_error,
                      stream_handle)

__all__ = ["OPS", "TARGET_INDEX", "sddmm_csr", "sddmm_plain", "out_width"]

_KERNEL = "sddmm_csr"
OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "dot": 4, "copy": 5}
# the canonical index array that gathers each operand target
TARGET_INDEX = {"u": "src", "v": "dst", "e": "eid"}

_PLAIN = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "dot": lambda a, b: torch.sum(a * b, dim=-1, keepdim=True),
    "copy": lambda a, b: a,
}


def _lib():
    lib = _build.library(_KERNEL)
    fn = lib.sddmm_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
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
    un-permute by ``eid_inv`` into caller order. The reference the kernel
    is held against."""
    lhs_val = lhs.index_select(0, g.long(TARGET_INDEX[lhs_target]))
    rhs_val = (None if rhs is None else
               rhs.index_select(0, g.long(TARGET_INDEX[rhs_target])))
    return _PLAIN[op](lhs_val, rhs_val).index_select(0, g.long("eid_inv"))


def _rows(g, target: str) -> int:
    return {"u": g.n_src, "v": g.n_dst, "e": g.n_edges}[target]


def sddmm_csr(g, op: str, lhs_target: str, lhs: torch.Tensor,
              rhs_target: Optional[str] = None,
              rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3 wrapper: the CUDA kernel for a CUDA ``lhs``, the plain version
    for a CPU ``lhs``. Operands are (rows of their target, width) fp32,
    indexed by node id or caller edge id; ``rhs`` is None for ``copy``.
    Returns (n_edges, width) in caller edge order.

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
    dev = lhs.device
    idx_l = getattr(g, TARGET_INDEX[lhs_target])
    check_operand(_KERNEL, "idx_l", idx_l, torch.int32, (g.n_edges,), dev)
    check_operand(_KERNEL, "eid", g.eid, torch.int32, (g.n_edges,), dev)
    check_operand(_KERNEL, "lhs", lhs, torch.float32,
                  (_rows(g, lhs_target), None), dev)
    dl, dr, idx_r = lhs.shape[1], 0, None
    if rhs is not None:
        idx_r = getattr(g, TARGET_INDEX[rhs_target])
        check_operand(_KERNEL, "idx_r", idx_r, torch.int32, (g.n_edges,),
                      dev)
        check_operand(_KERNEL, "rhs", rhs, torch.float32,
                      (_rows(g, rhs_target), None), dev)
        dr = rhs.shape[1]
    d = out_width(op, dl, dr)
    if d is None or dl == 0:
        raise ValueError(f"{_KERNEL}: widths {dl} and {dr} neither match "
                         f"nor broadcast from 1")
    out = torch.empty((g.n_edges, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _lib()
    with device_guard(dev):
        rc = fn(ptr(idx_l), ptr(idx_r), ptr(g.eid), ptr(lhs), ptr(rhs),
                ptr(out), g.n_edges, dl, dr, OPS[op], stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    sddmm_csr.launches += 1
    sddmm_csr.op_launches[op] += 1
    return out


sddmm_csr.launches = 0
sddmm_csr.op_launches = collections.Counter()
