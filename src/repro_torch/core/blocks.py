"""Minibatch block-graph execution, forward (port of
``repro/core/blocks.py``).

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
* ``"segment"`` — ``gspmm(bg.g, ..., "segment")`` on the padded graph;
* ``"kernel"`` — B1 / B4 (``kernels/dispatch.gspmm_kernel``) on the
  padded graph ``bg.g``, whose dummy row soaks up every pad edge;
* ``"auto"`` — the kernel for a CUDA operand a kernel covers, ``"ell"``
  otherwise (``e_copy_max_v`` and GAT's rank-3 ``u_mul_e_add_v`` among
  them, as the JAX planner keeps those off its kernels);
* ``"push"`` is queued (ROADMAP A3).

Edge outputs go to :func:`~repro_torch.core.binary_reduce.gsddmm` on
``bg.g``. The reverse table (``rev_src`` / ``rev_dst`` / ``rev_eid``),
built on first use, is for the block VJP of sampled training (ROADMAP
A10, queue A item 4); full-graph training differentiates on G and Gᵀ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels.dispatch import kernel_supports
from .binary_reduce import BINARY_OPS, BRSpec, _as2d, gspmm, gsddmm, parse_op
from .graph import Graph
from .strategies import REDUCE_IDENTITY

__all__ = ["BlockGraph", "BLOCK_STRATEGIES", "SDDMM_FOR_BLOCK",
           "block_gspmm", "block_supports", "check_block_strategy",
           "serve_block_signature"]

BLOCK_STRATEGIES = ("auto", "ell", "segment", "kernel")
# the gsddmm strategy an edge output of a block runs under each block
# strategy: the plain pulls keep the canonical-order reference
SDDMM_FOR_BLOCK = {"auto": "auto", "kernel": "kernel", "ell": "canonical",
                   "segment": "canonical"}


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
    in-edges. The reverse table views the same edges sorted by source
    slot (pad edges last, pointing at the dummy row); it is built on
    first use from ``g``'s caller-order endpoints.
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
    _rev: Dict[str, torch.Tensor] = dataclasses.field(
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
    def rev_src(self) -> torch.Tensor:
        """(n_edges,) int32 source slot of each edge, sorted by source."""
        return self._reverse()["src"]

    @property
    def rev_dst(self) -> torch.Tensor:
        """(n_edges,) int32 destination row of each ``rev_src`` edge."""
        return self._reverse()["dst"]

    @property
    def rev_eid(self) -> torch.Tensor:
        """(n_edges,) int32 caller edge id of each ``rev_src`` edge."""
        return self._reverse()["eid"]

    def _reverse(self) -> Dict[str, torch.Tensor]:
        """The reverse table, built on first use: caller-order edges
        stably sorted by source slot, so pad edges (dummy source = last
        slot) sort last. Serving never reads it."""
        if not self._rev:
            src, order = torch.sort(self.g.src_caller, stable=True)
            self._rev.update(src=src, eid=order.int(),
                             dst=self.g.dst_caller.index_select(0, order))
        return self._rev

    def __repr__(self):
        return (f"BlockGraph(n_src={self.g.n_src}, "
                f"n_dst_real={self.n_dst_real}, fanout={self.fanout})")


def block_supports(strategy: str, spec: BRSpec) -> bool:
    """Can ``strategy`` execute this spec on a block? Destination outputs
    with a reducer only; the kernel route also needs the operands
    :func:`~repro_torch.kernels.dispatch.kernel_supports` covers."""
    if spec.out != "v" or spec.reduce == "none":
        return False
    return strategy in ("ell", "segment", "kernel")


def check_block_strategy(strategy: str) -> None:
    """Raise unless ``strategy`` is one of :data:`BLOCK_STRATEGIES`."""
    if strategy == "push":
        raise NotImplementedError(
            "block strategy 'push' is not ported yet: ROADMAP A3 "
            "(push-scatter strategy)")
    if strategy not in BLOCK_STRATEGIES:
        raise ValueError(f"unknown block strategy {strategy!r}; expected "
                         f"one of {BLOCK_STRATEGIES}")


def _nbr_fetch(bg: BlockGraph, target: str, data: torch.Tensor
               ) -> torch.Tensor:
    """Operand values laid out on the (n_dst_real, fanout) slot grid."""
    if target == "u":
        return data[bg.long("nbr")]                  # (nd, F, *feat)
    if target == "e":
        return data[bg.long("nbr_eid")]              # (nd, F, *feat)
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
    return out


def block_gspmm(bg: BlockGraph, op_name: str, *,
                u: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                e: Optional[torch.Tensor] = None,
                strategy: str = "auto") -> torch.Tensor:
    """Generalized sparse aggregation over one sampled block.

    Operand conventions are :func:`~repro_torch.core.binary_reduce.gspmm`'s
    on ``bg.g``: ``u`` (n_src_pad, d), ``v`` (n_dst_real + 1, d) (callers
    pad one dummy row), ``e`` (n_edges_pad, d) in caller edge order. Node
    outputs are returned for REAL destination rows only, (n_dst_real,
    d); edge outputs for every edge of ``bg.g``.
    """
    spec = parse_op(op_name)
    check_block_strategy(strategy)
    data = {"u": u, "v": v, "e": e}
    if data[spec.lhs] is None:
        raise ValueError(f"{op_name}: operand {spec.lhs!r} missing")
    if spec.rhs is not None and data[spec.rhs] is None:
        raise ValueError(f"{op_name}: operand {spec.rhs!r} missing")
    if spec.out == "e":
        return gsddmm(bg.g, op_name, u=u, v=v, e=e,
                      strategy=SDDMM_FOR_BLOCK[strategy])
    if spec.out != "v":
        raise ValueError(f"{op_name}: blocks only produce destination or "
                         f"edge outputs (got {spec.out!r})")
    if spec.reduce == "none":
        raise ValueError(f"{op_name}: copy-reduce to nodes needs a reducer")

    lhs_data = _as2d(data[spec.lhs])
    rhs_data = _as2d(data[spec.rhs]) if spec.rhs is not None else None
    if strategy == "auto":
        strategy = ("kernel" if lhs_data.device.type == "cuda"
                    and kernel_supports(spec, lhs_data, rhs_data)
                    else "ell")
    if strategy == "ell":
        return _block_pull(bg, spec, lhs_data, rhs_data)
    out = gspmm(bg.g, op_name, u=u, v=v, e=e, strategy=strategy)
    return out[: bg.n_dst_real]
