"""The Binary-Reduce / Copy-Reduce lattice (port of
``repro/core/binary_reduce.py``).

``BR(x, y, ⊗, ⊕, z) : z ← ⊕(⊗(x, y), z)`` with operands on source nodes
(``u``), destination nodes (``v``) or edges (``e``), named DGL-style
(``u_mul_e_add_v``, ``u_copy_mean_v``, ``u_add_v_copy_e``, ...) exactly
as in the JAX package.

Strategies of :func:`gspmm` (node outputs):

* ``"segment"`` — per-edge messages, then the plain segment reduction
  (``strategies.pull_segment``), every reducer. The reference.
* ``"push"`` — the same messages scatter-reduced into an identity-filled
  output (``strategies.push_scatter``, paper Alg. 1), every reducer.
* ``"ell"`` — the blocked pull (paper Alg. 3) over the graph's
  degree-bucketed ELL pack (``planner.get_plan_cache(g).ell()``), the ⊗
  fused into each class's chunk gather; destination outputs only.
* ``"onehot"`` — the one-hot formulation over the graph's ``TilePack``
  (``strategies.onehot_spmm``): ``u_copy`` or ``u_mul_e`` with a scalar
  edge weight, rank-2 operands, sum or mean, destination outputs.
* ``"kernel"`` (JAX's ``"pallas"``, which names it here too) — the CUDA
  Copy-Reduce (B1) or Binary-Reduce (B4) kernel through
  ``kernels/dispatch.py``; on a CPU tensor, the kernels' plain versions.
* ``"auto"`` — the planner's choice (``core/planner.plan_gspmm``): the
  cost model's row for the operands' device, or a measured winner in
  autotune mode.

Every call goes through ``planner.plan_gspmm`` and its plan log. A pinned
strategy that cannot run a spec falls back down the planner's chain
(``kernel → onehot → ell → segment``; ``"ring"``, which waits for
partitioning (ROADMAP A12), to ``ell``) with a one-time warning; a kernel
that fails to build or launch still raises. The packs are built once per
graph, on the host, at first use. ``push``, ``ell`` and ``onehot`` are
plain PyTorch: ELL and tiles are TPU layouts, and the kernels walk the
CSR. A call under ``torch.no_grad`` runs under ``obs.events.timed`` as
``<op>`` (fenced); with grad mode on it is not timed, so a training
step's ops gain no fence (JAX times an op only outside a trace).

Strategies of :func:`gsddmm` (edge outputs), planned by
``planner.plan_sddmm`` and timed as ``sddmm:<op>``:

* ``"canonical"`` — gather in canonical (dst-sorted) order, ⊗, one
  un-permute by ``eid_inv`` (the B3 kernel's plain version);
* ``"gather"`` — operands gathered straight into caller order;
* ``"kernel"`` (or ``"pallas"``) — the CUDA gSDDMM kernel (B3); a spec or
  operands it does not take fall back to ``"canonical"``;
* ``"auto"`` — the planner's choice.

Gradients. The gather, push, ell and onehot routes differentiate by
plain autograd, as the JAX package takes them by autodiff. The segment
route's sum and mean, and the canonical route of ``gsddmm``, have the JAX
package's scatter-free adjoint
(:func:`_pull_grads`): per-edge cotangent products, then one sorted
segment reduce — over the src-sorted view ``perm_src``, which is Gᵀ's
canonical order, for a ``u`` operand; over G's canonical order for a
``v`` operand; none for an ``e`` operand, whose rows are its edges — so,
with ``pull_segment``'s sorted sums, both routes are bit-identical from
call to call on the card, where autograd's ``index_add_`` adds by
atomics (the segment route's max, min and prod keep autograd: their
adjoint onto an edge operand is one row per edge). Each kernel route is a
``torch.autograd.Function`` whose backward runs the port's own kernels,
because every adjoint of a spec they compute forward is again an
operator they compute (the kernel wrappers take no autograd input, so
the Functions hand them detached operands). A mean's 1/deg_in is folded
into the cotangent first (never B1 mean on Gᵀ); Gᵀ is
:func:`~repro_torch.core.graph.reverse`, whose edges keep their ids:

* ∂ of the node operand: B1 on Gᵀ — unweighted for ``copy``, ``add``
  and ``sub``, with the same weights for a scalar ``mul`` — or B4 on Gᵀ
  (ct ⊗ e, the same caller-order ``e``) for a vector ``mul`` and ``div``;
* ∂e, per edge on B3: ``copy`` of ct from the destination for
  ``e_copy_*_v`` and ``add`` (for ``sub`` negated, for a scalar ``e``
  summed over the width, both at the node first); ``u_mul_v`` (vector
  ``e``) or ``u_dot_v`` (scalar ``e``) for ``mul``, the same ÷ −e² for
  ``div``;
* gSDDMM on B3 (:func:`_sddmm_grads`): per-edge factors on B3 (``mul`` /
  ``div`` by a node operand), node sums on B4 ``copy_rhs`` — over G for a
  ``v`` operand, over Gᵀ for a ``u`` operand; an ``e`` operand's grad
  stays per edge.

A backward computes only the grads ``ctx.needs_input_grad`` asks for.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import planner
from . import strategies as S
from .graph import reverse
from .planner import get_plan_cache
from ..kernels.binary_reduce.ops import binary_reduce_csr
from ..kernels.dispatch import gspmm_kernel
from ..obs.events import timed as _timed
from ..kernels.sddmm.ops import (CALLER_INDEX, TARGET_INDEX, sddmm_csr,
                                 sddmm_plain)
from ..kernels.spmm.ops import spmm

__all__ = ["BRSpec", "parse_op", "gspmm", "gsddmm", "copy_reduce",
           "binary_reduce", "onehot_supports", "BINARY_OPS", "REDUCE_OPS",
           "OP_TARGETS", "STRATEGIES", "SDDMM_STRATEGIES", "SDDMM_FOR"]

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

STRATEGIES = ("auto", "segment", "push", "ell", "onehot", "kernel")
SDDMM_STRATEGIES = ("auto", "canonical", "gather", "kernel")
# a gspmm strategy name pinned on an edge output, as the sddmm lattice
# reads it (repro/core/binary_reduce.py:195-199 in port names): the
# baselines pin the caller-order gather, the optimized names (and any
# other, as in JAX) the canonical stream
SDDMM_FOR = {"auto": "auto", "kernel": "kernel", "segment": "gather",
             "push": "gather", "ell": "canonical", "onehot": "canonical"}


def _kernel_name(strategy: str) -> str:
    """JAX's name of the kernel route, ``"pallas"``, names the port's."""
    return "kernel" if strategy == "pallas" else strategy


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


class _TakeRows(torch.autograd.Function):
    """``x.index_select(0, idx)`` whose backward sums each row's
    cotangents in fp32 and rounds once to ``x``'s dtype: autograd's own
    ``index_add_`` would add a half-precision cotangent to a half-precision
    sum one edge at a time."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = tuple(x.shape)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=ct.device)
        return acc.index_add_(0, idx, ct.float()).to(ct.dtype), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)`` for the plain routes autograd
    differentiates: a half-precision ``x`` that needs a gradient goes
    through :class:`_TakeRows`, so its ∂x accumulates in fp32 (the
    lattice's rule); anything else is the plain ``index_select``."""
    if x.dtype in (torch.bfloat16, torch.float16) and _needs_grad(x):
        return _TakeRows.apply(x, idx)
    return x.index_select(0, idx)


def _edge_val(g, target: str, data: torch.Tensor) -> torch.Tensor:
    """Per-edge operand values in canonical edge order."""
    return take_rows(data, g.long(TARGET_INDEX[target]))


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def _detach(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.detach()


def _as_dtypes(grads: Sequence[Optional[torch.Tensor]],
               inputs: Sequence[Optional[torch.Tensor]]) -> tuple:
    """Each gradient in its input's dtype (a bf16 step's kernels hand an
    fp32 weight's gradient back in bf16), as the JAX VJPs cast theirs."""
    return tuple(None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, inputs))


def _needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    """Will autograd want a gradient of some tensor in ``ts``?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _timed_eager(op: str, thunk):
    """``thunk()`` timed as ``op`` (``obs.events.timed``, which fences)
    under ``torch.no_grad`` / ``inference_mode`` only: with grad mode on,
    autograd may be recording a training step — the port's analogue of
    JAX's traced vjp, where JAX times nothing — so a step gains no fence
    per op, not even for an op on inputs that need no grad."""
    if torch.is_grad_enabled():
        return thunk()
    return _timed(op, thunk)


# --------------------------------------------------------------------- #
# ⊗-adjoint machinery (repro/core/binary_reduce.py:121-158)
# --------------------------------------------------------------------- #
def _unbroadcast(grad: torch.Tensor, feat_shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """Reduce a per-edge gradient ``(E, *G)`` to an operand's per-edge
    shape ``(E, *feat_shape)`` (right-aligned broadcasting adjoint)."""
    extra = (grad.ndim - 1) - len(feat_shape)
    if extra > 0:
        grad = grad.sum(dim=tuple(range(1, 1 + extra)))
    axes = tuple(i + 1 for i, w in enumerate(feat_shape)
                 if w == 1 and grad.shape[i + 1] != 1)
    if axes:
        grad = grad.sum(dim=axes, keepdim=True)
    return grad


# ⊗-adjoint factors: which operand values the partial derivative needs
_NEEDS_OTHER = ("mul", "div", "dot")


def _dmsg(op: str, side: str, lhs_val, rhs_val, ct_e):
    """Per-edge cotangent of ``msg = lhs ⊗ rhs`` w.r.t. one side."""
    if op in ("copy", "add"):
        return ct_e
    if op == "sub":
        return ct_e if side == "l" else -ct_e
    if op in ("mul", "dot"):    # dot: ct_e has a trailing 1 — broadcasts
        return ct_e * (rhs_val if side == "l" else lhs_val)
    if op == "div":
        if side == "l":
            return ct_e / rhs_val
        return -ct_e * lhs_val / (rhs_val * rhs_val)
    raise ValueError(f"no ⊗-adjoint for {op!r}")


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
    strategy = _kernel_name(strategy)
    if strategy != "auto" and strategy not in planner.STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{planner.STRATEGIES + ('auto',)}")
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    if spec.out == "e":
        return gsddmm(g, op_name, u=u, v=v, e=e,
                      strategy=SDDMM_FOR.get(strategy, "canonical"))
    if spec.reduce == "none":
        raise ValueError(f"{op_name}: copy-reduce to nodes needs a reducer")

    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None

    runner = None
    if planner.get_mode() == "autotune" and strategy == "auto":
        def runner(s):              # measures the forward alone
            with torch.no_grad():
                return gspmm(g, op_name, u=u, v=v, e=e, strategy=s)

    plan = planner.plan_gspmm(g, spec, lhs_data, rhs_data,
                              requested=strategy, runner=runner)
    if plan.strategy == "ell":      # packs build outside the timing
        get_plan_cache(g).ell()
    elif plan.strategy == "onehot":
        get_plan_cache(g).tiles()
    out = _timed_eager(spec.name, lambda: _execute(
        g, spec, lhs_data, rhs_data, plan.strategy))
    # node outputs keep the feature operand's floating dtype
    if (lhs_data.dtype.is_floating_point and out.dtype.is_floating_point
            and out.dtype != lhs_data.dtype):
        out = out.to(lhs_data.dtype)
    return out


def _execute(g, spec: BRSpec, lhs_data, rhs_data,
             chosen: str) -> torch.Tensor:
    """Run one node-output BR with a strategy the planner resolved."""
    if chosen == "kernel":
        if _needs_grad(lhs_data, rhs_data):
            return _KernelGspmm.apply(g, spec, lhs_data, rhs_data)
        return gspmm_kernel(g, spec, lhs_data, rhs_data)
    if chosen == "ell":
        return _gspmm_ell(g, spec, get_plan_cache(g).ell(), lhs_data,
                          rhs_data)
    if chosen == "onehot":
        return _gspmm_onehot(g, spec, lhs_data, rhs_data)
    if chosen == "push":
        return _execute_segment(g, spec, lhs_data, rhs_data, push=True)
    if spec.reduce in ("sum", "mean") and _needs_grad(lhs_data, rhs_data):
        return _SegmentGspmm.apply(g, spec, lhs_data, rhs_data)
    return _execute_segment(g, spec, lhs_data, rhs_data)


def _execute_segment(g, spec: BRSpec, lhs_data, rhs_data,
                     push: bool = False) -> torch.Tensor:
    """Per-edge messages, then the plain segment reduction (with
    ``push``, the scatter of ``strategies.push_scatter``)."""
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
    reduce = S.push_scatter if push else S.pull_segment
    return reduce(msg, tgt, n_tgt, spec.reduce, deg)


def _gspmm_ell(g, spec: BRSpec, pack, lhs_data, rhs_data,
               raw: bool = False) -> torch.Tensor:
    """Blocked pull with the ⊗ fused into each class's chunk gather
    (``repro/core/binary_reduce.py:520``); ``raw`` as in
    ``strategies.pull_ell_reduce``."""
    def chunk_fetch(cls, target: str, data):
        if target == "v":           # the row's own value, broadcast on W
            return take_rows(data, cls.long("chunk_row")).unsqueeze(1)
        idx = cls.long("chunk_cols" if target == "u" else "chunk_eids")
        return take_rows(data, idx.reshape(-1)).reshape(
            tuple(idx.shape) + tuple(data.shape[1:]))     # (C, W, *feat)

    def msg_fn(cls):
        lhs_val = chunk_fetch(cls, spec.lhs, lhs_data)
        rhs_val = (chunk_fetch(cls, spec.rhs, rhs_data)
                   if spec.rhs is not None else None)
        return BINARY_OPS[spec.op](lhs_val, rhs_val)

    return S.pull_ell_reduce(pack, msg_fn, spec.reduce, deg=g.in_degrees,
                             raw=raw)


def onehot_supports(spec: BRSpec, lhs_data, rhs_data) -> bool:
    """Can the one-hot route compute this spec (``planner.supports``)? A
    destination output, a sum or mean, rank-2 operands, lhs on ``u``,
    and ⊗ ``copy`` or ``mul`` by a scalar edge weight."""
    return planner.supports("onehot", spec, lhs_data, rhs_data)


def _gspmm_onehot(g, spec: BRSpec, lhs_data, rhs_data) -> torch.Tensor:
    """The one-hot route over the graph's default ``TilePack``
    (``repro/core/binary_reduce.py:542``), on a spec the planner found it
    supports."""
    tiles = get_plan_cache(g).tiles()
    w = None
    if spec.op == "mul":
        w = rhs_data[:, 0].index_select(0, tiles.long("eids").reshape(-1)
                                        ).reshape(tiles.eids.shape)
    return S.onehot_spmm(tiles, lhs_data, spec.reduce, edge_weight=w,
                         deg=g.in_degrees)


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
    strategy = _kernel_name(strategy)
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None
    if spec.op == "dot":
        d = 1
    elif rhs_data is None:
        d = math.prod(lhs_data.shape[1:])
    else:
        d = max(math.prod(lhs_data.shape[1:]), math.prod(rhs_data.shape[1:]))

    runner = None
    if planner.get_mode() == "autotune" and strategy == "auto":
        def runner(s):
            with torch.no_grad():
                return _sddmm_execute(g, spec, lhs_data, rhs_data, s)

    chosen = planner.plan_sddmm((g.n_src, g.n_dst, g.n_edges), spec, d,
                                requested=strategy, lhs_data=lhs_data,
                                rhs_data=rhs_data, runner=runner)
    return _timed_eager(f"sddmm:{spec.name}", lambda: _sddmm_execute(
        g, spec, lhs_data, rhs_data, chosen))


def _sddmm_execute(g, spec: BRSpec, lhs_data, rhs_data,
                   chosen: str) -> torch.Tensor:
    """Run one edge-output BR with a strategy the planner resolved."""
    if chosen == "kernel":
        if _needs_grad(lhs_data, rhs_data):
            return _KernelGsddmm.apply(g, spec, lhs_data, rhs_data)
        return _sddmm_kernel(g, spec, lhs_data, rhs_data)
    if chosen == "canonical" and _needs_grad(lhs_data, rhs_data):
        return _CanonicalGsddmm.apply(g, spec, lhs_data, rhs_data)
    if chosen == "gather":
        # caller-order view of the endpoints, one gather per operand
        def fetch(target, x):
            name = CALLER_INDEX[target]
            return x if name is None else take_rows(x, g.long(name))

        return BINARY_OPS[spec.op](
            fetch(spec.lhs, lhs_data),
            None if rhs_data is None else fetch(spec.rhs, rhs_data))
    return sddmm_plain(g, spec.op, spec.lhs, lhs_data, spec.rhs, rhs_data)


def _sddmm_kernel(g, spec: BRSpec, lhs_data: torch.Tensor,
                  rhs_data: Optional[torch.Tensor]) -> torch.Tensor:
    return sddmm_csr(g, spec.op, spec.lhs, lhs_data.contiguous(), spec.rhs,
                     None if rhs_data is None else rhs_data.contiguous())


def copy_reduce(g, x: torch.Tensor, reduce: str = "sum",
                strategy: str = "auto") -> torch.Tensor:
    """CR: ``u_copy_<reduce>_v`` (paper Eq. 3/4)."""
    red = {"sum": "add", "prod": "mul"}.get(reduce, reduce)
    return gspmm(g, f"u_copy_{red}_v", u=x, strategy=strategy)


def binary_reduce(g, op_name: str, lhs: torch.Tensor,
                  rhs: Optional[torch.Tensor] = None,
                  strategy: str = "auto") -> torch.Tensor:
    """Positional-operand flavour of :func:`gspmm`: ``lhs`` and ``rhs``
    go to the targets the op name gives them."""
    spec = parse_op(op_name)
    ops: Dict[str, torch.Tensor] = {spec.lhs: lhs}
    if spec.rhs is not None:
        if rhs is None:
            raise ValueError(f"{op_name} needs two operands")
        if spec.rhs == spec.lhs:
            raise ValueError(f"{op_name}: operands share a target; use gspmm")
        ops[spec.rhs] = rhs
    return gspmm(g, op_name, strategy=strategy, **ops)


# --------------------------------------------------------------------- #
# the segment route's backward (module docstring: "Gradients")
# --------------------------------------------------------------------- #
def edge_order(g, order: str) -> Tuple[torch.Tensor, torch.Tensor,
                                       Optional[torch.Tensor]]:
    """int64 ``(src, dst, eid)`` of ``g``'s edges in ``order``:
    ``"canon"`` (G's canonical, dst-sorted order), ``"srcsort"`` (sorted
    by source through ``perm_src``: Gᵀ's canonical order, and a block's
    reverse table) or ``"caller"`` (caller edge order; ``eid`` is then
    None, the identity). Made once per graph."""
    if order == "canon":
        return g.long("src"), g.long("dst"), g.long("eid")
    key = f"{order}_order"
    t = g._derived.get(key)
    if t is None:
        slots = g.long("perm_src" if order == "srcsort" else "eid_inv")
        src, dst = (g.long(n).index_select(0, slots) for n in ("src", "dst"))
        t = (src, dst, g.long("eid").index_select(0, slots)
             if order == "srcsort" else None)
        g._derived[key] = t
    return t


def _pull_grads(g, spec: BRSpec, lhs, rhs, ct, needs: Sequence[bool],
                select: Optional[Callable] = None):
    """Scatter-free (∂lhs, ∂rhs) of a node-output sum or mean BR, or of
    an edge-output BR, on the plain path (the JAX package's
    ``_sddmm_grads`` / block ``_reverse_grads``): the per-edge cotangent
    — ``ct[out_e]`` (a mean's 1/deg folded in first), or an edge
    output's own row — times the other operand's value by ``_dmsg``,
    then one sorted reduce onto the operand's target — ``pull_segment``
    over the src-sorted order for ``u``, the canonical order for ``v`` —
    or, for ``e``, the rows in caller order as they are. ``select(order)``
    (the extrema backward of a block) masks the per-edge cotangent in
    ``order`` to each output element's winning edge. Only the grads
    ``needs`` asks for."""
    out_v = spec.out == "v"
    out_e = spec.out == "e"
    if spec.reduce == "mean" and not out_e:
        deg = g.in_degrees if out_v else g.out_degrees
        ct = ct / deg.clamp(min=1).to(ct.dtype).reshape(
            (-1,) + (1,) * (ct.ndim - 1))
    data = {"l": lhs, "r": rhs}
    targets = {"l": spec.lhs, "r": spec.rhs}

    def fetch(target, x, src, dst, eid):
        if target == "u":
            return x.index_select(0, src)
        if target == "v":
            return x.index_select(0, dst)
        return x if eid is None else x.index_select(0, eid)

    def grad_for(side: str):
        target, x = targets[side], data[side]
        order = {"u": "srcsort", "v": "canon", "e": "caller"}[target]
        src, dst, eid = edge_order(g, order)
        if out_e:                   # ct is per edge, in caller order
            ct_e = ct if eid is None else ct.index_select(0, eid)
        else:
            ct_e = ct.index_select(0, dst if out_v else src)
        if select is not None:
            ct_e = torch.where(select(order), ct_e, ct_e.new_zeros(()))
        lhs_val = rhs_val = None
        if spec.op in _NEEDS_OTHER:
            other = "r" if side == "l" else "l"
            val = fetch(targets[other], data[other], src, dst, eid)
            lhs_val, rhs_val = (None, val) if side == "l" else (val, None)
            if spec.op == "div" and side == "r":
                rhs_val = fetch(target, x, src, dst, eid)  # d/dr needs both
        gmsg = _dmsg(spec.op, side, lhs_val, rhs_val, ct_e)
        # a dot's cotangent has width 1: broadcast it to the operand's
        # per-edge shape first, so the wider side gets its full rows
        gmsg = _unbroadcast(gmsg.expand(torch.broadcast_shapes(
            gmsg.shape, (gmsg.shape[0],) + tuple(x.shape[1:]))),
            tuple(x.shape[1:]))
        if target == "e":
            return gmsg.to(x.dtype)
        if target == "u":
            out = S.pull_segment(gmsg, src, g.n_src, "sum", g.out_degrees)
        else:
            out = S.pull_segment(gmsg, dst, g.n_dst, "sum", g.in_degrees)
        return out.to(x.dtype)

    return tuple(grad_for(side) if n else None
                 for side, n in zip("lr", needs))


class _SegmentGspmm(torch.autograd.Function):
    """gspmm's segment route for a sum or mean, with the scatter-free
    backward of :func:`_pull_grads`."""

    @staticmethod
    def forward(ctx, g, spec, lhs, rhs):
        ctx.g, ctx.spec = g, spec
        ctx.save_for_backward(lhs, rhs)
        return _execute_segment(g, spec, lhs, rhs)

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs = ctx.saved_tensors
        return (None, None) + _pull_grads(ctx.g, ctx.spec, lhs, rhs,
                                          ct.contiguous(),
                                          ctx.needs_input_grad[2:])


class _CanonicalGsddmm(torch.autograd.Function):
    """gsddmm's canonical route (B3's plain version) with the
    scatter-free backward of :func:`_pull_grads`."""

    @staticmethod
    def forward(ctx, g, spec, lhs, rhs):
        ctx.g, ctx.spec = g, spec
        ctx.save_for_backward(lhs, rhs)
        return sddmm_plain(g, spec.op, spec.lhs, lhs, spec.rhs, rhs)

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs = ctx.saved_tensors
        return (None, None) + _pull_grads(ctx.g, ctx.spec, lhs, rhs,
                                          ct.contiguous(),
                                          ctx.needs_input_grad[2:])


# --------------------------------------------------------------------- #
# the kernel routes' backward (module docstring: "Gradients")
# --------------------------------------------------------------------- #
def _node_sum(g, target: str, gmsg: torch.Tensor) -> torch.Tensor:
    """Σ of caller-order per-edge rows onto an operand target: B4
    ``copy_rhs`` over G (``v``: in-edges) or over Gᵀ (``u``: out-edges);
    an ``e`` target keeps the rows."""
    if target == "e":
        return gmsg
    gr = g if target == "v" else reverse(g)
    return binary_reduce_csr(gr, None, gmsg.contiguous(), "copy_rhs")


def _gspmm_grads(g, spec: BRSpec, lhs, rhs, ct, needs: Sequence[bool]):
    """(∂lhs, ∂rhs) of a node-output BR that ran on B1 or B4 — any spec
    ``kernels.dispatch.kernel_supports`` admits — on the kernels (module
    docstring: "Gradients")."""
    if spec.reduce == "mean":       # fold 1/deg_in into the cotangent
        ct = ct / g.in_degrees.clamp(min=1).to(ct.dtype)[:, None]
    ct = ct.contiguous()
    if spec.op == "copy":
        if not needs[0]:
            return None, None
        if spec.lhs == "e":         # e_copy_*_v: ct[dst_e] per edge
            return sddmm_csr(g, "copy", "v", ct), None
        return spmm(reverse(g), ct, "sum"), None
    flip = spec.lhs == "e"          # e_⊗_u: add and mul commute
    u, e = (rhs, lhs) if flip else (lhs, rhs)
    need_u, need_e = needs[::-1] if flip else needs
    scalar = e.shape[-1] == 1
    du = de = None
    if need_u:                      # Σ over out-edges: pulls over Gᵀ
        if spec.op in ("add", "sub"):
            du = spmm(reverse(g), ct, "sum")
        elif spec.op == "mul" and scalar:
            du = spmm(reverse(g), ct, "sum", weight=e)
        else:
            du = binary_reduce_csr(reverse(g), ct, e, spec.op)
    if need_e:
        if spec.op in ("add", "sub"):
            c = ct.sum(-1, keepdim=True) if scalar else ct
            de = sddmm_csr(g, "copy", "v",
                           (-c if spec.op == "sub" else c).contiguous())
        else:                       # u[src_e] ⊙ ct[dst_e], summed if scalar
            de = sddmm_csr(g, "dot" if scalar else "mul", "u",
                           u.contiguous(), "v", ct)
            if spec.op == "div":
                de = -de / (e * e)
    return (de, du) if flip else (du, de)


def _sddmm_grads(g, spec: BRSpec, lhs, rhs, out, ct,
                 needs: Sequence[bool]):
    """(∂lhs, ∂rhs) of an edge-output BR that ran on B3 (port of
    ``repro/core/binary_reduce.py:335``, on the kernels): the per-edge
    cotangent of each side, by ``_dmsg`` where every value it reads is
    already per edge, else by B3 (``ct ⊗ other`` with ⊗ = ``mul`` or
    ``div`` against a node operand); then summed onto the side's target
    (:func:`_node_sum`). ``out`` is the forward's output (``div`` only).
    """
    def grad_for(side: str):
        target, data = (spec.lhs, lhs) if side == "l" else (spec.rhs, rhs)
        other_t, other = (spec.rhs, rhs) if side == "l" else (spec.lhs, lhs)
        divide = False
        if spec.op in ("copy", "add", "sub"):
            gmsg = _dmsg(spec.op, side, None, None, ct)
        elif spec.op == "div" and side == "r":
            # -ct·l/r² = -(ct·out)/r; r holds one value per target row,
            # so it divides after the sum
            gmsg, divide = ct * out, True
        elif other_t == "e":
            gmsg = _dmsg(spec.op, side, lhs, rhs, ct)
        else:
            gmsg = sddmm_csr(g, "div" if spec.op == "div" else "mul", "e",
                             ct, other_t, other.contiguous())
        grad = _node_sum(g, target, _unbroadcast(gmsg, tuple(data.shape[1:])))
        return -grad / data if divide else grad

    return tuple(grad_for(side) if n else None
                 for side, n in zip("lr", needs))


class _KernelGspmm(torch.autograd.Function):
    """gspmm's kernel route (B1 / B4) with the backward of
    :func:`_gspmm_grads`."""

    @staticmethod
    def forward(ctx, g, spec, lhs, rhs):
        ctx.g, ctx.spec = g, spec
        ctx.save_for_backward(lhs, rhs)
        return gspmm_kernel(g, spec, lhs.detach(), _detach(rhs))

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs = ctx.saved_tensors
        return (None, None) + _as_dtypes(_gspmm_grads(
            ctx.g, ctx.spec, lhs.detach(), _detach(rhs), ct,
            ctx.needs_input_grad[2:]), (lhs, rhs))


class _KernelGsddmm(torch.autograd.Function):
    """gsddmm's kernel route (B3) with the backward of
    :func:`_sddmm_grads`."""

    @staticmethod
    def forward(ctx, g, spec, lhs, rhs):
        ctx.g, ctx.spec = g, spec
        out = _sddmm_kernel(g, spec, lhs.detach(), _detach(rhs))
        ctx.save_for_backward(lhs, rhs, out if spec.op == "div" else None)
        return out

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs, out = ctx.saved_tensors
        return (None, None) + _as_dtypes(_sddmm_grads(
            ctx.g, ctx.spec, lhs.detach(), _detach(rhs), out,
            ct.contiguous(), ctx.needs_input_grad[2:]), (lhs, rhs))
