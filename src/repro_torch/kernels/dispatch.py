"""Dispatch from a BRSpec onto the port's kernels (port of
``repro/kernels/dispatch.py``).

Node outputs (``gspmm_kernel``), as the JAX package routes them:

* B1, the Copy-Reduce SpMM: ``u_copy_*_v``, and ``u_mul_e_*_v`` with a
  scalar edge weight (the cheaper kernel for that spec);
* B4, the fused Binary-Reduce: ``e_copy_*_v`` (``copy_rhs``, the node
  operand never read), ``u_⊗_e_*_v`` for ⊗ ∈ add/sub/mul/div, and
  ``e_⊗_u_*_v`` for the commutative add/mul (operands flipped).

Both take rank-2 fp32 operands and sum/mean only, as
``repro.core.planner.supports("pallas", ...)`` decides. Edge outputs
(``sddmm_kernel_supports``) go to B3 for rank-2 fp32 streams whose
widths match or broadcast from 1, as ``planner.sddmm_supports`` decides.
"""
from __future__ import annotations

from typing import Optional

import torch

from .binary_reduce.ops import binary_reduce
from .sddmm.ops import OPS as SDDMM_OPS
from .sddmm.ops import out_width
from .spmm.ops import spmm

__all__ = ["kernel_supports", "gspmm_kernel", "sddmm_kernel_supports"]

_BR_BINOPS = ("add", "sub", "mul", "div")


def _fp32_rank2(*ts: Optional[torch.Tensor]) -> bool:
    return all(t is None or (t.ndim == 2 and t.dtype == torch.float32)
               for t in ts)


def kernel_supports(spec, lhs: torch.Tensor,
                    rhs: Optional[torch.Tensor]) -> bool:
    """Does a node-output kernel (B1 or B4) compute ``spec`` on these
    operands?"""
    if spec.out != "v" or spec.reduce not in ("sum", "mean"):
        return False
    if not _fp32_rank2(lhs, rhs):
        return False
    if spec.op == "copy":
        return spec.lhs in ("u", "e")
    if spec.lhs == "u" and spec.rhs == "e" and spec.op in _BR_BINOPS:
        node, edge = lhs, rhs
    elif spec.lhs == "e" and spec.rhs == "u" and spec.op in ("add", "mul"):
        node, edge = rhs, lhs
    else:
        return False
    return edge.shape[-1] in (1, node.shape[-1])


def gspmm_kernel(g, spec, lhs_data: torch.Tensor,
                 rhs_data: Optional[torch.Tensor]) -> torch.Tensor:
    """Route a parsed BR config to B1 or B4 (out target 'v' only)."""
    if not kernel_supports(spec, lhs_data, rhs_data):
        raise NotImplementedError(
            f"no kernel computes {spec.name} on these operands (rank-2 "
            f"fp32, sum/mean, the specs of kernels/dispatch.py); use "
            f"strategy='segment' or 'auto'")
    red = spec.reduce
    if spec.op == "copy" and spec.lhs == "u":
        return spmm(g, lhs_data.contiguous(), red)
    if spec.op == "copy":                                   # e_copy_*_v
        return binary_reduce(g, None, lhs_data, "copy_rhs", red)
    if spec.lhs == "u":
        if spec.op == "mul" and rhs_data.shape[-1] == 1:   # scalar weight
            return spmm(g, lhs_data.contiguous(), red, weight=rhs_data[:, 0])
        return binary_reduce(g, lhs_data, rhs_data, spec.op, red)
    return binary_reduce(g, rhs_data, lhs_data, spec.op, red)   # e_⊗_u


def sddmm_kernel_supports(spec, lhs: torch.Tensor,
                          rhs: Optional[torch.Tensor]) -> bool:
    """Does the B3 kernel compute edge-output ``spec`` on these operands?"""
    if spec.out != "e" or spec.op not in SDDMM_OPS:
        return False
    if not _fp32_rank2(lhs, rhs):
        return False
    return out_width(spec.op, lhs.shape[-1],
                     None if rhs is None else rhs.shape[-1]) is not None
