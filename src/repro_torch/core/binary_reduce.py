"""The Binary-Reduce / Copy-Reduce lattice (port of
``repro/core/binary_reduce.py``).

``BR(x, y, ⊗, ⊕, z) : z ← ⊕(⊗(x, y), z)`` with operands on source nodes
(``u``), destination nodes (``v``) or edges (``e``), named DGL-style
(``u_mul_e_add_v``, ``u_copy_mean_v``, ``u_add_v_copy_e``, ...) exactly
as in the JAX package.

Strategies of :func:`gspmm` (node outputs):

* ``"segment"`` — per-edge messages, then the plain segment reduction
  (``strategies.pull_segment``), every reducer. The reference.
* ``"kernel"`` — the CUDA Copy-Reduce (B1) or Binary-Reduce (B4) kernel
  through ``kernels/dispatch.py``; raises for a spec neither covers.
* ``"auto"`` — the kernel for a CUDA tensor whose spec a kernel covers,
  segment otherwise. Without the planner (ROADMAP A9) there is no cost
  model to consult.

Strategies of :func:`gsddmm` (edge outputs):

* ``"canonical"`` — gather in canonical (dst-sorted) order, ⊗, one
  un-permute by ``eid_inv`` (the B3 kernel's plain version);
* ``"gather"`` — operands gathered straight into caller order;
* ``"kernel"`` — the CUDA gSDDMM kernel (B3);
* ``"auto"`` — the kernel for a CUDA operand that B3 covers, canonical
  otherwise.

The JAX package's other strategies are queued; asking for them raises
``NotImplementedError`` naming the item. No backward yet: the kernel
wrappers raise on operands that require grad.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from . import strategies as S
from ..kernels.dispatch import (gspmm_kernel, kernel_supports,
                                sddmm_kernel_supports)
from ..kernels.sddmm.ops import (CALLER_INDEX, TARGET_INDEX, sddmm_csr,
                                 sddmm_plain)

__all__ = ["BRSpec", "parse_op", "gspmm", "gsddmm", "copy_reduce",
           "BINARY_OPS", "REDUCE_OPS", "OP_TARGETS", "STRATEGIES",
           "SDDMM_STRATEGIES", "SDDMM_FOR"]

OP_TARGETS = ("u", "v", "e")

BINARY_OPS: Dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "dot": lambda a, b: torch.sum(a * b, dim=-1, keepdim=True),
    "copy": lambda a, b: a,  # unary: rhs ignored (CR, Eq. 3)
}

REDUCE_OPS: Dict[str, str] = {
    "add": "sum", "sum": "sum", "max": "max", "min": "min",
    "mul": "prod", "prod": "prod", "mean": "mean", "copy": "none",
}

STRATEGIES = ("auto", "segment", "kernel")
SDDMM_STRATEGIES = ("auto", "canonical", "gather", "kernel")
# a gspmm strategy name pinned on an edge output, as the sddmm lattice
# reads it (repro/core/binary_reduce.py:195-199 in port names): the
# baseline pins the caller-order gather (the JAX package's other names,
# not ported, pin the canonical stream)
SDDMM_FOR = {"auto": "auto", "kernel": "kernel", "segment": "gather"}

# the JAX package's strategy names this slice does not run, and where
# each one is queued
_QUEUED = {
    "push": "ROADMAP A3 (push-scatter strategy)",
    "ell": "ROADMAP A2/A3 (ELL packs and the blocked-pull strategy)",
    "onehot": "ROADMAP A2/A3 (TilePack and the one-hot strategy)",
    "ring": "ROADMAP A12 (partitioned ring execution)",
    "pallas": "ROADMAP B1 (the TPU kernel's port is strategy='kernel')",
}


@dataclasses.dataclass(frozen=True)
class BRSpec:
    """Parsed configuration of a Binary-Reduce."""
    lhs: str
    op: str
    rhs: Optional[str]
    reduce: str
    out: str

    @property
    def name(self) -> str:
        r = "copy" if self.reduce == "none" else (
            "add" if self.reduce == "sum" else
            "mul" if self.reduce == "prod" else self.reduce)
        if self.op == "copy":
            return f"{self.lhs}_copy_{r}_{self.out}"
        return f"{self.lhs}_{self.op}_{self.rhs}_{r}_{self.out}"


def parse_op(name: str) -> BRSpec:
    """Parse a DGL-style op name into a :class:`BRSpec`.

    CR: ``<x>_copy_<red>_<z>``; BR: ``<x>_<op>_<y>_<red>_<z>``.
    """
    toks = name.split("_")
    if len(toks) == 4 and toks[1] == "copy":
        lhs, _, red, out = toks
        rhs = None
        op = "copy"
    elif len(toks) == 5:
        lhs, op, rhs, red, out = toks
        if rhs not in OP_TARGETS:
            raise ValueError(f"bad rhs target in {name!r}")
    else:
        raise ValueError(f"cannot parse BR op name {name!r}")
    if lhs not in OP_TARGETS or out not in OP_TARGETS:
        raise ValueError(f"bad operand targets in {name!r}")
    if op not in BINARY_OPS:
        raise ValueError(f"unknown binary op in {name!r}")
    if red not in REDUCE_OPS:
        raise ValueError(f"unknown reduce op in {name!r}")
    return BRSpec(lhs=lhs, op=op, rhs=rhs, reduce=REDUCE_OPS[red], out=out)


def _edge_val(g, target: str, data: torch.Tensor) -> torch.Tensor:
    """Per-edge operand values in canonical edge order."""
    return data.index_select(0, g.long(TARGET_INDEX[target]))


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def gspmm(g, op_name: str, *, u: Optional[torch.Tensor] = None,
          v: Optional[torch.Tensor] = None,
          e: Optional[torch.Tensor] = None,
          strategy: str = "auto") -> torch.Tensor:
    """Generalized sparse aggregation onto nodes (paper Eq. 1/3).

    Operands are indexed by node/edge id: ``u``: (n_src, d) or (n_src,),
    ``v``: (n_dst, d), ``e``: (n_edges, d) in the caller's original edge
    order. Returns features on ``spec.out`` (``'v'`` or ``'u'``).
    """
    spec = parse_op(op_name)
    if strategy not in STRATEGIES:
        if strategy in _QUEUED:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet: {_QUEUED[strategy]}")
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{STRATEGIES}")
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    if spec.out == "e":
        return gsddmm(g, op_name, u=u, v=v, e=e,
                      strategy=SDDMM_FOR[strategy])
    if spec.reduce == "none":
        raise ValueError(f"{op_name}: copy-reduce to nodes needs a reducer")

    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None

    if strategy == "auto":
        strategy = ("kernel" if lhs_data.device.type == "cuda"
                    and kernel_supports(spec, lhs_data, rhs_data)
                    else "segment")
    if strategy == "kernel":
        out = gspmm_kernel(g, spec, lhs_data, rhs_data)
    else:
        out = _execute_segment(g, spec, lhs_data, rhs_data)
    # node outputs keep the feature operand's floating dtype
    if (lhs_data.dtype.is_floating_point and out.dtype.is_floating_point
            and out.dtype != lhs_data.dtype):
        out = out.to(lhs_data.dtype)
    return out


def _execute_segment(g, spec: BRSpec, lhs_data, rhs_data) -> torch.Tensor:
    """Per-edge messages, then the plain segment reduction."""
    lhs_val = _edge_val(g, spec.lhs, lhs_data)
    rhs_val = (_edge_val(g, spec.rhs, rhs_data)
               if spec.rhs is not None else None)
    msg = BINARY_OPS[spec.op](lhs_val, rhs_val)
    if spec.out == "v":
        tgt, n_tgt, deg = g.long("dst"), g.n_dst, g.in_degrees
    else:  # 'u': reduce in the src-sorted (push) order
        perm = g.long("perm_src")
        msg = msg.index_select(0, perm)
        tgt = g.long("src").index_select(0, perm)
        n_tgt, deg = g.n_src, g.out_degrees
    return S.pull_segment(msg, tgt, n_tgt, spec.reduce, deg)


def gsddmm(g, op_name: str, *, u: Optional[torch.Tensor] = None,
           v: Optional[torch.Tensor] = None,
           e: Optional[torch.Tensor] = None,
           strategy: str = "auto") -> torch.Tensor:
    """Generalized SDDMM: per-edge ⊗ of node/edge operands (attention
    logits, the edge softmax's shift and divide, bilinear edge scores).

    Operand conventions match :func:`gspmm`; the op's ``out`` target must
    be ``e`` (its reducer is ignored). Returns (n_edges, d) in the
    caller's edge order; 1-D operands widen to d = 1.
    """
    spec = parse_op(op_name)
    if spec.out != "e":
        raise ValueError(f"{op_name}: gsddmm computes edge outputs "
                         f"(got out={spec.out!r}); use gspmm")
    if strategy == "pallas":
        raise NotImplementedError(
            "sddmm strategy 'pallas' is the TPU kernel; its port is "
            "strategy='kernel' (ROADMAP B3)")
    if strategy not in SDDMM_STRATEGIES:
        raise ValueError(f"unknown sddmm strategy {strategy!r}; expected "
                         f"one of {SDDMM_STRATEGIES}")
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None

    if strategy == "auto":
        strategy = ("kernel" if lhs_data.device.type == "cuda"
                    and sddmm_kernel_supports(spec, lhs_data, rhs_data)
                    else "canonical")
    if strategy == "kernel":
        if not sddmm_kernel_supports(spec, lhs_data, rhs_data):
            raise NotImplementedError(
                f"the sddmm kernel does not compute {spec.name} on these "
                f"operands (rank-2 fp32, widths equal or 1); use "
                f"strategy='canonical' or 'auto'")
        return sddmm_csr(g, spec.op, spec.lhs, lhs_data.contiguous(),
                         spec.rhs,
                         None if rhs_data is None else rhs_data.contiguous())
    if strategy == "gather":
        # caller-order view of the endpoints, one gather per operand
        def fetch(target, x):
            name = CALLER_INDEX[target]
            return x if name is None else x.index_select(0, g.long(name))

        return BINARY_OPS[spec.op](
            fetch(spec.lhs, lhs_data),
            None if rhs_data is None else fetch(spec.rhs, rhs_data))
    return sddmm_plain(g, spec.op, spec.lhs, lhs_data, spec.rhs, rhs_data)


def copy_reduce(g, x: torch.Tensor, reduce: str = "sum",
                strategy: str = "auto") -> torch.Tensor:
    """CR: ``u_copy_<reduce>_v`` (paper Eq. 3/4)."""
    red = {"sum": "add", "prod": "mul"}.get(reduce, reduce)
    return gspmm(g, f"u_copy_{red}_v", u=x, strategy=strategy)
