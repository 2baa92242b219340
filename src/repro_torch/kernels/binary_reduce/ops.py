"""Fused Binary-Reduce (ROADMAP B4): the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``src/repro/kernels/binary_reduce/kernel.py::_br_kernel`` (the
TPU kernel built by ``binary_reduce_pallas_call`` and launched from
``repro/kernels/binary_reduce/ops.py::binary_reduce``). The CUDA source
is ``../csrc/binary_reduce_csr.cu``: one warp per destination row walks
the CSR by destination, reading the edge operand in caller order through
``eid``, so no TilePack is built and no edge feature is permuted first.
Its header says what bounds it on the H100 (bytes) and how narrow rows
keep the warp's lanes busy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..common import (check_operand, device_guard, graph_index_ptrs, ptr,
                      raise_on_error, stream_handle)

__all__ = ["BINOPS", "binary_reduce", "binary_reduce_csr",
           "binary_reduce_plain"]

_KERNEL = "binary_reduce_csr"
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


def _lib():
    lib = _build.library(_KERNEL)
    fn = lib.binary_reduce_csr_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def binary_reduce_plain(g, B: Optional[torch.Tensor], E: torch.Tensor,
                        binop: str = "mul", mean: bool = False
                        ) -> torch.Tensor:
    """``C[v] = Σ_{e=(u→v)} B[u] ⊗ E[e]`` (÷ max(deg, 1) when ``mean``)
    with ``index_select`` + ``index_add_``; ``E`` (n_edges, d) or
    (n_edges, 1) in caller edge order, ``B`` (n_src, d) or None for
    ``copy_rhs``. Empty rows are 0. The reference the kernel is held
    against."""
    e_val = E.index_select(0, g.long("eid"))
    b_val = None if B is None else B.index_select(0, g.long("src"))
    msg = _PLAIN[binop](b_val, e_val)
    if msg.shape[-1] == 1 and B is not None and B.shape[-1] != 1:
        msg = msg.expand(-1, B.shape[-1])      # copy_rhs of a scalar E
    out = torch.zeros((g.n_dst, msg.shape[-1]), dtype=msg.dtype,
                      device=msg.device)
    out.index_add_(0, g.long("dst"), msg)
    if mean:
        out = out / g.in_degrees.clamp(min=1).to(out.dtype)[:, None]
    return out


def binary_reduce_csr(g, B: Optional[torch.Tensor], E: torch.Tensor,
                      binop: str = "mul", mean: bool = False
                      ) -> torch.Tensor:
    """B4 wrapper: the CUDA kernel for a CUDA ``E``, the plain version for
    a CPU ``E``. ``B``: (n_src, d) fp32, None only for ``copy_rhs``;
    ``E``: (n_edges, d) or (n_edges, 1) fp32 in caller edge order.
    Returns (n_dst, d).

    ``binary_reduce_csr.launches`` counts kernel launches (CUDA only).
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
    check_operand(_KERNEL, "E", E, torch.float32, (g.n_edges, None), dev)
    de = E.shape[1]
    d = de
    if B is not None:
        check_operand(_KERNEL, "B", B, torch.float32, (g.n_src, None), dev)
        d = B.shape[1]
    if de not in (d, 1):
        raise ValueError(f"{_KERNEL}: edge feature width {de} is neither "
                         f"the node width {d} nor 1")
    out = torch.empty((g.n_dst, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    idx = graph_index_ptrs(_KERNEL, g)
    fn = _lib()
    with device_guard(dev):
        rc = fn(idx["indptr_dst"], idx["src"], idx["eid"], ptr(B), ptr(E),
                ptr(out), g.n_dst, d, de, BINOPS[binop], int(bool(mean)),
                stream_handle(dev))
    raise_on_error(_KERNEL, rc)
    binary_reduce_csr.launches += 1
    return out


binary_reduce_csr.launches = 0


def binary_reduce(g, B: Optional[torch.Tensor], E: torch.Tensor,
                  binop: str = "mul", reduce_op: str = "sum"
                  ) -> torch.Tensor:
    """Fused ``u_⊗_e_{add,mean}_v``: ``C[v] = ⊕_(u→v)=e B[u] ⊗ E[e]``, as
    in ``repro.kernels.binary_reduce.ops.binary_reduce``.

    ``E``: (n_edges, d), (n_edges, 1) or (n_edges,) in the caller's edge
    order; a scalar edge feature broadcasts across the feature dim. ``B``
    may be None for ``copy_rhs`` (``e_copy_*_v``), where the JAX package
    passes a zero node operand that is never read.
    """
    if reduce_op not in ("sum", "mean"):
        raise ValueError("binary_reduce supports sum/mean")
    E = E.reshape(E.shape[0], -1)
    if B is not None and E.shape[1] not in (1, B.shape[-1]):
        raise ValueError(f"edge feature dim {E.shape[1]} != node dim "
                         f"{B.shape[-1]}")
    return binary_reduce_csr(g, None if B is None else B.contiguous(),
                             E.contiguous(), binop, mean=reduce_op == "mean")
