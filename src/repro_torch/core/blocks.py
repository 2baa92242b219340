"""Minibatch block-graph execution (port of ``repro/core/blocks.py``).

A *block* is the bipartite graph of one message-passing layer of a
sampled minibatch: sources are the layer-l frontier nodes, destinations
the layer-(l+1) seeds. Blocks from :class:`repro_torch.data.NeighborSampler`
are padded to static shapes (node pads into a trailing dummy source
slot, edge pads into a trailing dummy destination row).

Every real destination row holds at most ``fanout`` sampled in-edges, so
the sampler also emits a dense ``(n_dst_real, fanout)`` neighbor table
(:attr:`BlockGraph.nbr`): the uniform blocked pull over it is the JAX
block path's default strategy and the reference here.

Strategies of :func:`block_gspmm` (node outputs, real rows only):

* ``"ell"`` — the uniform masked pull over the neighbor table, plain
  PyTorch;
* ``"segment"`` — the segment route on the padded graph ``bg.g``;
* ``"push"`` — the push route on the padded graph, the scatter baseline
  (the JAX package's generic COO path);
* ``"kernel"`` — B1 / B4 (``kernels/dispatch.gspmm_kernel``) on the
  padded graph, whose dummy row soaks up every pad edge;
* ``"auto"`` — the planner's choice (``planner.plan_block_gspmm``,
  logged ``block:<op>``, memoized per shape signature): the cost model
  on the operands' device row among ell, segment and — where it takes
  the operands — the kernel.

``"onehot"``, ``"pallas"`` and ``"ring"`` are no block strategy, as in
JAX (a tile pack is built per graph, and blocks change every batch): a
pinned one, or a pinned ``"kernel"`` on operands it does not take, falls
back to ``"ell"`` with a one-time warning.

Edge outputs go to :func:`~repro_torch.core.binary_reduce.gsddmm` on
``bg.g``.

Training (the block VJP). ``bwd_strategy`` picks how a node output is
differentiated, planned per shape signature by
:func:`~repro_torch.core.planner.plan_block_vjp`:

* ``"gather"`` — the JAX reverse-table VJP: an operand's adjoint is a
  masked pull that gathers the (mean-scaled, zero-padded) cotangents at
  each edge's destination and reduces each sorted segment — over the
  block's Gᵀ for a ``u`` operand (:func:`_reverse_grads`: plain torch,
  ``strategies.pull_segment``, no scatter). A kernel forward's gather
  backward runs on the kernels instead (``binary_reduce._gspmm_grads``):
  B1 on Gᵀ for ∂u, B3 per edge, B4 for ∂ of a vector ``mul`` / ``div``.
  Gᵀ is the one the trainer's sampler built from its draw
  (``core/graph.reverse_from_draw``), or is made on first use. Every pad
  edge leaves the dummy destination row, whose cotangent is zero, so no
  pad value reaches a real gradient. For max / min the forward records
  the winning slot per output element (:func:`_block_arg_extrema`) and
  the pull zeroes every other edge's cotangent.
* ``"scatter"`` — autograd of the plain forward (the baseline); a kernel
  forward has only its gather backward.
* ``"auto"`` — the planner's choice (``planner.plan_block_vjp``, logged
  ``block_bwd:<op>``): JAX's cost model on the device's row. A kernel
  forward has only its gather backward, so after one auto takes
  ``gather``.

Eager calls are timed through :func:`repro_torch.obs.events.timed` as
``block:<op>`` (the forward) and ``block_bwd:<op>`` (its backward).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels.dispatch import kernel_supports
from ..obs.events import timed as _timed
from ..optim.precision import accum_dtype
from . import planner
from .binary_reduce import (BINARY_OPS, BRSpec, _as2d, _as_dtypes, _detach,
                            _execute, _gspmm_grads, _kernel_name,
                            _needs_grad, _pull_grads, edge_order, gsddmm,
                            parse_op, take_rows)
from .graph import Graph, reverse, reverse_built
from .strategies import REDUCE_IDENTITY

__all__ = ["BlockGraph", "BLOCK_STRATEGIES", "SDDMM_FOR_BLOCK",
           "block_gspmm", "block_supports", "check_block_strategy",
           "serve_block_signature"]

BLOCK_STRATEGIES = ("auto", "ell", "segment", "push", "kernel")
# the gspmm names no block route runs: accepted, and planned as JAX plans
# them on a block (a fallback to ell)
_FALLBACK_NAMES = ("onehot", "pallas", "ring")
# the gsddmm strategy an edge output of a block runs under each block
# strategy: the plain routes keep the canonical-order reference
SDDMM_FOR_BLOCK = {"auto": "auto", "kernel": "kernel", "ell": "canonical",
                   "segment": "canonical", "push": "canonical"}


def serve_block_signature(batch_size: int, fanouts, n_layers=None):
    """Predict ``MiniBatch.shape_signature()`` for a sampler config:
    the ``(n_src_pad, n_dst, n_edges_pad, fanout)`` of every block of a
    ``batch_size`` batch under ``fanouts`` (an int with ``n_layers``, or
    a per-layer sequence), outermost hop first — without sampling."""
    if isinstance(fanouts, int):
        if n_layers is None:
            raise ValueError("int fanout needs n_layers")
        fanouts = [fanouts] * int(n_layers)
    fanouts = list(fanouts)
    sizes = [int(batch_size)]
    for f in reversed(fanouts):
        sizes.append(sizes[-1] * (int(f) + 1))
    sigs = [(sizes[li + 1], sizes[li], sizes[li] * int(f), int(f))
            for li, f in enumerate(reversed(fanouts))]
    return tuple(reversed(sigs))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockGraph:
    """One sampled bipartite layer with its uniform neighbor table.

    ``g`` is the padded block graph (``n_dst = n_dst_real + 1``: the
    extra row absorbs pad edges). ``nbr[j, k]`` is the source *slot* of
    destination ``j``'s k-th sampled in-edge (pad slots point at the
    dummy source and are masked out), ``nbr_eid[j, k]`` the matching
    caller-order edge id, ``real_deg[j]`` the number of real sampled
    in-edges. The reverse table (``rev_src`` / ``rev_dst`` / ``rev_eid``)
    views the same edges sorted by source slot, pad edges last, pointing
    at the dummy row: it is Gᵀ's canonical order (``reverse(g)``, built
    by the trainer's sampler or on first use).
    """
    g: Graph
    nbr: torch.Tensor        # (n_dst_real, fanout) int32 source slots
    nbr_eid: torch.Tensor    # (n_dst_real, fanout) int32 caller edge ids
    nbr_mask: torch.Tensor   # (n_dst_real, fanout) bool, True = real edge
    real_deg: torch.Tensor   # (n_dst_real,) int32
    n_dst_real: int
    fanout: int
    _long: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def signature(self) -> Tuple[int, int, int, int]:
        """Static shape signature ``(n_src, n_dst_real, n_edges, fanout)``."""
        return (self.g.n_src, self.n_dst_real, self.g.n_edges, self.fanout)

    def long(self, name: str) -> torch.Tensor:
        """int64 copy of table ``name`` ('nbr' | 'nbr_eid'), made once."""
        t = self._long.get(name)
        if t is None:
            t = getattr(self, name).long()
            self._long[name] = t
        return t

    @property
    def has_reverse(self) -> bool:
        """Is the block's Gᵀ (and so its reverse table) built already?
        Serving never builds it."""
        return reverse_built(self.g)

    @property
    def rev_src(self) -> torch.Tensor:
        """(n_edges,) int32 source slot of each edge, sorted by source."""
        return reverse(self.g).dst

    @property
    def rev_dst(self) -> torch.Tensor:
        """(n_edges,) int32 destination row of each ``rev_src`` edge."""
        return reverse(self.g).src

    @property
    def rev_eid(self) -> torch.Tensor:
        """(n_edges,) int32 caller edge id of each ``rev_src`` edge."""
        return reverse(self.g).eid

    def __repr__(self):
        return (f"BlockGraph(n_src={self.g.n_src}, "
                f"n_dst_real={self.n_dst_real}, fanout={self.fanout})")


def block_supports(strategy: str, spec: BRSpec) -> bool:
    """Can ``strategy`` execute this spec on a block? Destination outputs
    with a reducer only; the kernel route also needs the operands
    :func:`~repro_torch.kernels.dispatch.kernel_supports` covers, which
    the planner checks."""
    if spec.out != "v" or spec.reduce == "none":
        return False
    return strategy in ("ell", "segment", "push", "kernel")


def check_block_strategy(strategy: str) -> None:
    """Raise unless ``strategy`` is one of :data:`BLOCK_STRATEGIES` or a
    gspmm name the planner falls back from on a block."""
    if strategy not in BLOCK_STRATEGIES + _FALLBACK_NAMES:
        raise ValueError(f"unknown block strategy {strategy!r}; expected "
                         f"one of {BLOCK_STRATEGIES + _FALLBACK_NAMES}")


def _nbr_fetch(bg: BlockGraph, target: str, data: torch.Tensor
               ) -> torch.Tensor:
    """Operand values laid out on the (n_dst_real, fanout) slot grid."""
    if target in ("u", "e"):                         # (nd, F, *feat)
        nbr = bg.long("nbr" if target == "u" else "nbr_eid")
        return take_rows(data, nbr.reshape(-1)).reshape(
            tuple(nbr.shape) + tuple(data.shape[1:]))
    if target == "v":
        # v operands are sized like g.n_dst (they include the pad row)
        return data[: bg.n_dst_real].unsqueeze(1)    # (nd, 1, *feat)
    raise ValueError(target)


def _block_pull(bg: BlockGraph, spec: BRSpec, lhs_data: torch.Tensor,
                rhs_data: Optional[torch.Tensor]) -> torch.Tensor:
    """Uniform blocked pull: a dense masked reduce over the fanout axis."""
    lhs_val = _nbr_fetch(bg, spec.lhs, lhs_data)
    rhs_val = (_nbr_fetch(bg, spec.rhs, rhs_data)
               if spec.rhs is not None else None)
    msg = BINARY_OPS[spec.op](lhs_val, rhs_val)      # (nd, F, *feat)
    red = spec.reduce
    dtype = msg.dtype
    if red in ("sum", "mean"):      # half precision sums in fp32
        msg = msg.to(accum_dtype(dtype))
    mask = bg.nbr_mask.reshape(bg.nbr_mask.shape + (1,) * (msg.ndim - 2))
    msg = torch.where(mask, msg, msg.new_full((), REDUCE_IDENTITY[red]))
    if red in ("sum", "mean"):
        out = msg.sum(dim=1)
    elif red == "max":
        out = msg.amax(dim=1)
    elif red == "min":
        out = msg.amin(dim=1)
    elif red == "prod":
        out = msg.prod(dim=1)
    else:
        raise ValueError(f"unknown reduce op {red!r}")
    deg = bg.real_deg.reshape((out.shape[0],) + (1,) * (out.ndim - 1))
    if red == "mean":
        out = out / deg.clamp(min=1).to(out.dtype)
    # DGL semantics: rows with no (real) incoming edge are 0 for every ⊕
    if red != "sum":
        out = torch.where(deg > 0, out, out.new_zeros(()))
    return out.to(dtype)


def block_gspmm(bg: BlockGraph, op_name: str, *,
                u: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                e: Optional[torch.Tensor] = None,
                strategy: str = "auto",
                bwd_strategy: str = "auto") -> torch.Tensor:
    """Generalized sparse aggregation over one sampled block.

    Operand conventions are :func:`~repro_torch.core.binary_reduce.gspmm`'s
    on ``bg.g``: ``u`` (n_src_pad, d), ``v`` (n_dst_real + 1, d) (callers
    pad one dummy row), ``e`` (n_edges_pad, d) in caller edge order. Node
    outputs are returned for REAL destination rows only, (n_dst_real,
    d); edge outputs for every edge of ``bg.g`` (``bwd_strategy`` does not
    apply: their autograd is gather-shaped already). ``bwd_strategy``
    ('auto' | 'gather' | 'scatter') picks the differentiation path of a
    node output (module docstring).
    """
    spec = parse_op(op_name)
    check_block_strategy(strategy)
    if bwd_strategy != "auto" and \
            bwd_strategy not in planner.BLOCK_BWD_STRATEGIES:
        raise ValueError(
            f"unknown block backward strategy {bwd_strategy!r}; expected "
            f"one of {planner.BLOCK_BWD_STRATEGIES + ('auto',)}")
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    if spec.out == "e":
        how = SDDMM_FOR_BLOCK.get(_kernel_name(strategy), "canonical")
        return gsddmm(bg.g, op_name, u=u, v=v, e=e, strategy=how)
    if spec.out != "v":
        raise ValueError(f"{op_name}: blocks only produce destination or "
                         f"edge outputs (got {spec.out!r})")
    if spec.reduce == "none":
        raise ValueError(f"{op_name}: copy-reduce to nodes needs a reducer")

    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None
    d = math.prod(lhs_data.shape[1:])
    device = planner.device_of(lhs_data)
    autotune = planner.get_mode() == "autotune"
    runner = None
    if autotune and strategy == "auto":
        def runner(s):
            with torch.no_grad():
                return _block_execute(bg, spec, lhs_data, rhs_data, s)

    chosen = planner.plan_block_gspmm(
        bg.signature, spec, d, requested=strategy, runner=runner,
        dtype=lhs_data.dtype, device=device,
        kernel_ok=kernel_supports(spec, lhs_data, rhs_data))

    bwd_runner = None
    if (autotune and bwd_strategy == "auto" and chosen != "kernel"
            and lhs_data.is_floating_point()):
        def bwd_runner(s):          # the differentiated call, as trained
            with torch.enable_grad():
                x = lhs_data.detach().requires_grad_()
                fn = _BlockGather if s == "gather" else _BlockScatter
                out = fn.apply(bg, spec, chosen, x, _detach(rhs_data))
                return torch.autograd.grad(out.sum(), x)

    bwd = planner.plan_block_vjp(
        bg.signature, spec, d, requested=bwd_strategy, runner=bwd_runner,
        dtype=lhs_data.dtype, device=device,
        kernel_forward=chosen == "kernel",
        scatter_available=chosen != "kernel")
    return _run_block(bg, spec, chosen, bwd, lhs_data, rhs_data)


def _run_block(bg: BlockGraph, spec: BRSpec, chosen: str, bwd: str,
               lhs_data, rhs_data) -> torch.Tensor:
    """One planned block aggregation, timed as ``block:<op>``; under
    autograd through the block VJP ``bwd`` names (a kernel forward's is
    the gather)."""
    name = f"block:{spec.name}"
    if not _needs_grad(lhs_data, rhs_data):
        return _timed(name, lambda: _block_execute(bg, spec, lhs_data,
                                                   rhs_data, chosen))
    fn = (_BlockGather if bwd == "gather" or chosen == "kernel"
          else _BlockScatter)
    return _timed(name, lambda: fn.apply(bg, spec, chosen, lhs_data,
                                         rhs_data))


def _block_execute(bg: BlockGraph, spec: BRSpec, lhs_data, rhs_data,
                   chosen: str) -> torch.Tensor:
    """Run one block aggregation with a resolved strategy; real rows. The
    padded graph's routes run directly, not through ``gspmm``'s planner,
    which would make a plan cache and stats for every per-batch graph."""
    if chosen == "ell":
        return _block_pull(bg, spec, lhs_data, rhs_data)
    out = _execute(bg.g, spec, lhs_data, rhs_data, chosen)[: bg.n_dst_real]
    # every route returns its messages' (the operands' promoted) dtype, as
    # JAX's block path does; a kernel writes its feature operand's
    if rhs_data is not None and out.is_floating_point():
        out = out.to(torch.promote_types(lhs_data.dtype, rhs_data.dtype))
    return out


# --------------------------------------------------------------------- #
# the block VJP (module docstring: "Training")
# --------------------------------------------------------------------- #
def _slot_of_edge(bg: BlockGraph) -> torch.Tensor:
    """(n_edges,) int64: each caller edge's slot ``k`` on the neighbor
    grid (``nbr[dst, k]``), -1 for pad edges. Made once per block."""
    k_of = bg._long.get("slot_of_edge")
    if k_of is None:
        nd, fanout = bg.nbr.shape
        mask = bg.nbr_mask.reshape(-1)
        slots = torch.arange(fanout, device=mask.device).repeat(nd)
        k_of = torch.full((bg.g.n_edges,), -1, dtype=torch.long,
                          device=mask.device)
        k_of[bg.long("nbr_eid").reshape(-1)[mask]] = slots[mask]
        bg._long["slot_of_edge"] = k_of
    return k_of


def _block_arg_extrema(bg: BlockGraph, spec: BRSpec, lhs_data, rhs_data
                       ) -> torch.Tensor:
    """Winning slot per (destination row, feature element) of a max / min
    reduce on the neighbor grid (the first, on ties); -1 for rows with no
    real in-edge."""
    lhs_val = _nbr_fetch(bg, spec.lhs, lhs_data)
    rhs_val = (_nbr_fetch(bg, spec.rhs, rhs_data)
               if spec.rhs is not None else None)
    msg = BINARY_OPS[spec.op](lhs_val, rhs_val)      # (nd, F, *feat)
    mask = bg.nbr_mask.reshape(bg.nbr_mask.shape + (1,) * (msg.ndim - 2))
    msg = torch.where(mask, msg,
                      msg.new_full((), REDUCE_IDENTITY[spec.reduce]))
    arg = (torch.argmax if spec.reduce == "max" else torch.argmin)(msg, 1)
    has = (bg.real_deg > 0).reshape((arg.shape[0],) + (1,) * (arg.ndim - 1))
    return torch.where(has, arg, arg.new_full((), -1))


def _reverse_grads(bg: BlockGraph, spec: BRSpec, lhs_data, rhs_data,
                   ct_pad, needs: Sequence[bool], arg=None):
    """Gather-based adjoints of one block aggregation on the plain path,
    from ``ct_pad``, the cotangent with a zero row for the dummy
    destination (pad edges, and only they, point at it):
    :func:`~repro_torch.core.binary_reduce._pull_grads` on ``bg.g`` —
    ∂u a sorted pull over the reverse table, ∂v over the canonical order,
    ∂e per edge. With ``arg`` (max / min) only the winning slot's edge
    keeps its cotangent: the dummy row's arg is -1 and pad edges carry
    slot -1, so they select each other, with a zero cotangent."""
    select = None
    if arg is not None:
        k_of = _slot_of_edge(bg)
        arg_pad = torch.cat([arg, arg.new_full((1,) + tuple(arg.shape[1:]),
                                               -1)])
        lead = (1,) * (arg_pad.ndim - 1)

        def select(order):
            _, dst, eid = edge_order(bg.g, order)
            k_e = k_of if eid is None else k_of.index_select(0, eid)
            return (arg_pad.index_select(0, dst)
                    == k_e.reshape((-1,) + lead))

    return _pull_grads(bg.g, spec, lhs_data, rhs_data, ct_pad, needs,
                       select)


class _BlockGather(torch.autograd.Function):
    """A block aggregation with the gather backward: on the kernels for a
    kernel forward (B1 / B3 / B4 over the block's G and Gᵀ), else
    :func:`_reverse_grads`; timed as ``block_bwd:<op>``."""

    @staticmethod
    def forward(ctx, bg, spec, chosen, lhs, rhs):
        ctx.bg, ctx.spec, ctx.chosen = bg, spec, chosen
        ctx.save_for_backward(lhs, rhs)
        lhs, rhs = lhs.detach(), _detach(rhs)   # the wrappers take no grad
        out = _block_execute(bg, spec, lhs, rhs, chosen)
        ctx.arg = (_block_arg_extrema(bg, spec, lhs, rhs)
                   if spec.reduce in ("max", "min") else None)
        return out

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs = (_detach(t) for t in ctx.saved_tensors)
        bg, spec, arg = ctx.bg, ctx.spec, ctx.arg
        needs = ctx.needs_input_grad[3:]

        def grads():
            ct_pad = torch.cat([ct, ct.new_zeros((1,) + tuple(ct.shape[1:]))])
            if ctx.chosen == "kernel":
                return _as_dtypes(_gspmm_grads(bg.g, spec, lhs, rhs, ct_pad,
                                               needs), (lhs, rhs))
            return _reverse_grads(bg, spec, lhs, rhs, ct_pad, needs, arg)

        return (None, None, None) + tuple(
            _timed(f"block_bwd:{spec.name}", grads))


class _BlockScatter(torch.autograd.Function):
    """A plain block aggregation differentiated by autograd of its
    forward (the 'scatter' baseline), replayed inside ``timed`` so its
    backward is measured as ``block_bwd:<op>`` like the gather one."""

    @staticmethod
    def forward(ctx, bg, spec, chosen, lhs, rhs):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip((lhs, rhs), need)]
            out = _block_execute(bg, spec, ins[0], ins[1], chosen)
        ctx.spec, ctx.out = spec, out
        ctx.ins = [t if n else None for t, n in zip(ins, need)]
        return out.detach()

    @staticmethod
    def backward(ctx, ct):
        ins, out = ctx.ins, ctx.out
        del ctx.ins, ctx.out
        wrt = [t for t in ins if t is not None]
        got = iter(_timed(f"block_bwd:{ctx.spec.name}",
                          lambda: torch.autograd.grad(out, wrt, ct)))
        return (None, None, None) + tuple(
            None if t is None else next(got) for t in ins)
