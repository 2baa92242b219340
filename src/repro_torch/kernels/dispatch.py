"""Dispatch from a BRSpec onto the port's kernels (port of
``repro/kernels/dispatch.py``).

This slice has one node-output kernel, the Copy-Reduce SpMM (B1). It
serves ``u_copy_{add,mean}_v`` and ``u_mul_e_{add,mean}_v`` with a scalar
edge weight — GCN's and GraphSAGE's aggregations. The fused
Binary-Reduce kernel that takes the other specs is ROADMAP B4.
"""
from __future__ import annotations

from typing import Optional

import torch

from .spmm.ops import spmm

__all__ = ["kernel_supports", "gspmm_kernel"]


def kernel_supports(spec, lhs: torch.Tensor,
                    rhs: Optional[torch.Tensor]) -> bool:
    """Does the B1 kernel compute ``spec`` on these operands?"""
    if spec.out != "v" or spec.reduce not in ("sum", "mean"):
        return False
    if spec.lhs != "u" or lhs.ndim != 2:
        return False
    if spec.op == "copy":
        return True
    return (spec.op == "mul" and spec.rhs == "e" and rhs is not None
            and rhs.ndim == 2 and rhs.shape[-1] == 1)


def gspmm_kernel(g, spec, lhs_data: torch.Tensor,
                 rhs_data: Optional[torch.Tensor]) -> torch.Tensor:
    """Route a parsed BR config to the B1 kernel (out target 'v' only)."""
    if not kernel_supports(spec, lhs_data, rhs_data):
        raise NotImplementedError(
            f"no kernel for {spec.name} on these operands yet: the fused "
            f"Binary-Reduce kernel is ROADMAP B4; use strategy='segment' "
            f"or 'auto'")
    weight = rhs_data[:, 0] if spec.op == "mul" else None
    return spmm(g, lhs_data.contiguous(), spec.reduce, weight=weight)
