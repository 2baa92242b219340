"""Partitioned-graph execution (port of ``repro/core/partition.py``): the
emulated ring on one device and the mesh ring over a ``torch.distributed``
process group.

The paper's Alg. 2 argument — owner-computes pull aggregation over
bounded K-block working sets — lifted one level up, to vertex shards
(DistGNN's lift of the same kernels):

* :class:`PartitionedGraph` — a host-planned vertex partition: each of
  ``n_shards`` shards owns a padded block of ``rows`` destination rows,
  and every edge lives in exactly one ``(dst_shard, src_shard)`` bucket
  of ``eb`` slots. :func:`build_partition` is numpy, array for array the
  JAX package's plan (``to_pad``, ``from_pad``, the (S, S, eb) bucket
  arrays, ``eb_ij``, the stats).
* :func:`ring_gspmm` — the differentiable sharded weighted Copy-Reduce
  ``out[v] = Σ_{e=(u→v)} w_e·x[u]`` in the padded layout, with int8
  exchanges (``comm="int8"``, error feedback, ``optim/compression.py``);
  :func:`ring_gspmm_delayed` — the DistGNN-style delayed halo;
  :func:`local_gspmm` — the owner-local (diagonal) part alone;
  :func:`ring_edge_values` / :func:`bucket_softmax` — GAT's per-edge
  logits and destination softmax on the bucketed layout.

Two routes compute each op (``strategy``):

* ``"plain"`` — the JAX package's ring, bucket by bucket
  (``_stage_reduce`` over the buckets, the transposed ring as the
  backward of a ``torch.autograd.Function``): the reference.
* ``"kernel"`` (and ``"auto"``) — the ring on the card's kernels. Each
  :class:`PartitionedGraph` builds, once, on the host, a **stage graph**
  per non-empty ring diagonal ``s``: a :class:`~repro_torch.core.graph.
  Graph` on padded ids (``n_pad × n_pad``) holding the real slots of the
  buckets ``((j + s) % S, j)``, its caller edge order the bucketed slot
  order, so a bucketed weight is one gather away. Pad slots are never
  edges. A pass is B1 (``spmm_csr``, fp32 or its bf16 form) per stage,
  summed in fp32 in stage order and cast once; its backward B1 on each
  stage graph's reverse (∂x) and B3 ``dot`` on each stage graph (∂w, 0 on
  pad slots). ``ring_edge_values`` is B3 ``add`` per stage, its backward
  B4 ``copy_rhs`` on each stage's reverse (∂el) and on the stage (∂er);
  ``bucket_softmax`` is B5 on one graph of every bucket by padded
  destination, with ``_EdgeSoftmaxKernel``'s backward (fp32; a bf16
  operand takes the plain form). The owner-local part is the diagonal-0
  stage; int8's and the delayed halo's remote part one graph of every
  off-diagonal bucket. A per-head weight (GAT's α, (S, S, eb, H) against
  (n_pad, H, F) features) runs per stage graph on gspmm's sorted segment
  route (full-graph GAT's ``u_mul_e_add_v`` takes B4 with an edge value
  per head; the ring's stage sums do not). On a CPU tensor the wrappers
  run their plain versions; on the card a kernel that fails to build or
  launch fails.

``mesh`` — a ``torch.distributed`` process group of ``n_shards`` ranks
(anything else raises ``TypeError``) — runs the mesh ring, JAX's
``shard_map`` path (``repro/core/partition.py:431-549, 677-760``): every
rank runs the same program on its own shard. The ops then take and
return the rank's blocks: a node array (n_pad, …) as the rank's (rows, …)
rows, a bucket array (S, S, eb[, H]) as the rank's destination row
(1, S, eb[, H]). Each rank builds, once, its :class:`RankPlan` from the
same host partition: per ring stage ``s`` the graph (on local ids, rows ×
rows) of bucket ``(me, (me - s) % S)``, which the forward reduces, and of
bucket ``((me + s) % S, me)``, whose reverse the backward reduces. Source
blocks go round the ring by ``isend`` / ``irecv`` (``core/transport.py``),
the next hop posted before the stage's reduce, stopping after the last
non-empty diagonal; the backward is the transposed ring (the x blocks
forward, the cotangent blocks and weight rows backward). The stage
reduces are the routes' own: B1 / B3 / B4 / B5 on the rank's graphs, or
the plain loop.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.binary_reduce.ops import binary_reduce_csr
from ..kernels.common import FEATURE_DTYPES
from ..kernels.sddmm.ops import sddmm_csr
from ..kernels.spmm.ops import spmm_csr
from ..obs import metrics as _metrics
from ..optim.compression import BLOCK, compress_payload, wire_bytes
from ..optim.precision import accum_dtype
from .graph import Graph, from_coo, reverse
from .transport import Hop, all_gather_rows, process_group, rank_of

__all__ = ["PartitionStats", "PartitionedGraph", "build_partition",
           "ring_gspmm", "ring_edge_values", "bucket_softmax",
           "local_gspmm", "offdiag_weights", "ring_gspmm_delayed",
           "ring_reference", "stage_plan", "rank_plan", "RankPlan",
           "PARTITION_MODES", "COMM_MODES", "RING_STRATEGIES"]

PARTITION_MODES = ("contiguous", "hash", "uniform")
COMM_MODES = ("none", "int8")
RING_STRATEGIES = ("auto", "kernel", "plain")


# --------------------------------------------------------------------- #
# the partition plan (repro/core/partition.py:100-298)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PartitionStats:
    """Static, hashable features of a partition — the planner's view."""
    n_shards: int
    rows_per_shard: int
    eb: int                 # padded edge slots per (dst, src) bucket
    n_edges: int
    cut_fraction: float     # edges whose endpoints live on different shards
    pad_ratio: float        # S*S*eb / n_edges — bucket padding waste
    balance: float          # max / mean edges owned per dst shard
    # slots the per-diagonal-max schedule touches (S · Σ_s w_s), the last
    # non-empty bucket diagonal (-1: unknown, assume S-1), and
    # ragged_slots / n_edges
    ragged_slots: int = 0
    ragged_stages: int = -1
    ragged_pad_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class PartitionHost:
    """Host (numpy) copies of a partition's arrays, as JAX holds them."""
    to_pad: np.ndarray       # (n,) int32
    from_pad: np.ndarray     # (n_pad,) int32, -1 on pad slots
    src_local: np.ndarray    # (S, S, eb) int32
    dst_local: np.ndarray    # (S, S, eb) int32
    eid: np.ndarray          # (S, S, eb) int32 caller-order edge id
    mask: np.ndarray         # (S, S, eb) bool


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionedGraph:
    """Host-planned vertex partition + per-(dst, src)-shard edge buckets,
    the JAX package's fields, as tensors on the graph's device (int32
    indices, a bool mask) with their numpy copies in ``host``.

    Vertices map to padded slots ``shard * rows + local`` (``to_pad`` /
    ``from_pad``); each edge occupies one slot of bucket ``(shard(dst),
    shard(src))`` with its endpoints as local offsets and its caller-order
    id in ``eid``. Bucket fill is contiguous from slot 0, so
    ``[:eb_ij[i][j]]`` is exactly bucket ``(i, j)``'s real edges."""
    to_pad: torch.Tensor
    from_pad: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor
    eid: torch.Tensor
    mask: torch.Tensor
    n_shards: int
    rows: int
    eb: int
    n: int
    n_edges: int
    mode: str
    stats: PartitionStats
    eb_ij: Tuple[Tuple[int, ...], ...]
    host: PartitionHost
    _derived: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.to_pad.device

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows

    def bucket_width(self, i: int, j: int) -> int:
        """Real slot count of bucket (i, j)."""
        return self.eb_ij[i][j]

    def long(self, name: str) -> torch.Tensor:
        """int64 copy of index tensor ``name``, made once."""
        key = f"long:{name}"
        t = self._derived.get(key)
        if t is None:
            t = self._derived[key] = getattr(self, name).long()
        return t

    # -- layout converters (repro/core/partition.py:174-200) ------------
    def scatter_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """(n_rows, *feat) vertex-ordered -> (n_pad, *feat) padded, 0 on
        pad rows (differentiable)."""
        out = x.new_zeros((self.n_pad,) + tuple(x.shape[1:]))
        return out.index_copy(0, self.long("to_pad")[: x.shape[0]], x)

    def gather_nodes(self, xp: torch.Tensor,
                     n_rows: Optional[int] = None) -> torch.Tensor:
        """(n_pad, *feat) padded -> (n_rows, *feat) vertex-ordered."""
        n_rows = self.n if n_rows is None else n_rows
        return xp.index_select(0, self.long("to_pad")[:n_rows])

    def scatter_edges(self, w: torch.Tensor) -> torch.Tensor:
        """(n_edges, ...) caller-order edge values -> bucketed
        (S, S, eb, ...), 0 on pad slots."""
        vals = w.index_select(0, self.long("eid").reshape(-1)).reshape(
            tuple(self.eid.shape) + tuple(w.shape[1:]))
        mask = self.mask.reshape(tuple(self.mask.shape)
                                 + (1,) * (vals.ndim - 3))
        return torch.where(mask, vals, vals.new_zeros(()))

    def gather_edges(self, wb: torch.Tensor) -> torch.Tensor:
        """Bucketed (S, S, eb, ...) -> (n_edges, ...) caller order."""
        flat = wb.reshape((-1,) + tuple(wb.shape[3:]))
        real = self.mask.reshape(-1)
        out = wb.new_zeros((self.n_edges,) + tuple(wb.shape[3:]))
        return out.index_copy(0, self.long("eid").reshape(-1)[real],
                              flat[real])

    def __repr__(self):
        return (f"PartitionedGraph(S={self.n_shards}, rows={self.rows}, "
                f"eb={self.eb}, n={self.n}, mode={self.mode!r})")


def _shard_assignment(g: Graph, n_shards: int, mode: str
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """vertex id -> (shard, local offset); returns (shard, local, rows)."""
    n = max(g.n_src, g.n_dst)
    ids = np.arange(n, dtype=np.int64)
    if mode == "hash":
        shard = ids % n_shards
        local = ids // n_shards
    elif mode == "uniform":
        rows = -(-n // n_shards)
        return ids // rows, ids % rows, rows
    elif mode == "contiguous":
        # degree-balanced contiguous ranges: split the cumulative edge
        # mass (in + out degree) into n_shards nearly-equal chunks
        deg = np.zeros(n, np.int64)
        deg[: g.n_dst] += g.host.in_degrees.astype(np.int64)
        deg[: g.n_src] += g.host.out_degrees.astype(np.int64)
        cum = np.cumsum(deg + 1)            # +1 keeps empty rows spread
        targets = cum[-1] * (np.arange(1, n_shards) / n_shards)
        bounds = np.searchsorted(cum, targets, side="left")
        shard = np.searchsorted(bounds, ids, side="right")
        starts = np.concatenate([[0], bounds])
        local = ids - starts[shard]
    else:
        raise ValueError(f"unknown partition mode {mode!r}; expected one "
                         f"of {PARTITION_MODES}")
    rows = int(np.bincount(shard, minlength=n_shards).max()) if n else 1
    return shard, local, max(rows, 1)


def build_partition(g: Graph, n_shards: int,
                    mode: str = "contiguous") -> PartitionedGraph:
    """Host-side partition planning, vectorized as JAX's (one stable sort
    and one scatter), on ``g``'s host index; the tensors go to
    ``g.device``."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    shard, local, rows = _shard_assignment(g, n_shards, mode)
    n = max(g.n_src, g.n_dst)
    S = n_shards

    src = g.host.src.astype(np.int64)
    dst = g.host.dst.astype(np.int64)
    eid = g.host.eid.astype(np.int64)      # canonical slot -> caller id
    E = src.shape[0]

    i = shard[dst] if E else np.zeros(0, np.int64)   # dst (owner) shard
    j = shard[src] if E else np.zeros(0, np.int64)   # src shard
    key = i * S + j
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=S * S)
    eb = max(1, int(counts.max())) if E else 1
    offs = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(E) - offs[key[order]]            # slot within bucket

    SL = np.zeros((S * S, eb), np.int32)
    DL = np.zeros((S * S, eb), np.int32)
    EID = np.zeros((S * S, eb), np.int32)
    MK = np.zeros((S * S, eb), bool)
    SL[key[order], pos] = local[src[order]]
    DL[key[order], pos] = local[dst[order]]
    EID[key[order], pos] = eid[order]
    MK[key[order], pos] = True

    to_pad = (shard * rows + local).astype(np.int32)
    from_pad = np.full(S * rows, -1, np.int32)
    from_pad[to_pad] = np.arange(n, dtype=np.int32)

    owned = np.bincount(i, minlength=S) if E else np.zeros(S)
    cut = int((i != j).sum()) if E else 0
    counts2 = counts.reshape(S, S)
    eb_ij = tuple(tuple(int(c) for c in rowc) for rowc in counts2)
    ws = [max(int(counts2[(jj + s) % S, jj]) for jj in range(S))
          for s in range(S)]
    nz = [s for s in range(S) if ws[s] > 0]
    ragged_slots = int(S * sum(ws))
    stats = PartitionStats(
        n_shards=S, rows_per_shard=rows, eb=eb, n_edges=E,
        cut_fraction=float(cut / max(E, 1)),
        pad_ratio=float(S * S * eb / max(E, 1)),
        balance=float(owned.max() / max(owned.mean(), 1e-9)),
        ragged_slots=ragged_slots, ragged_stages=nz[-1] if nz else 0,
        ragged_pad_ratio=float(ragged_slots / max(E, 1)))
    host = PartitionHost(to_pad=to_pad, from_pad=from_pad,
                         src_local=SL.reshape(S, S, eb),
                         dst_local=DL.reshape(S, S, eb),
                         eid=EID.reshape(S, S, eb),
                         mask=MK.reshape(S, S, eb))
    dev = g.device
    return PartitionedGraph(
        **{f.name: torch.from_numpy(getattr(host, f.name)).to(dev)
           for f in dataclasses.fields(host)},
        n_shards=S, rows=rows, eb=eb, n=n, n_edges=E, mode=mode,
        stats=stats, eb_ij=eb_ij, host=host)


def _diag_widths(pg: PartitionedGraph) -> Tuple[int, ...]:
    """Max real bucket width along each ring diagonal ``s`` (the buckets
    ``((j + s) % S, j)``); ``ws[0]`` is the owner-local diagonal."""
    S = pg.n_shards
    return tuple(max(pg.eb_ij[(j + s) % S][j] for j in range(S))
                 for s in range(S))


def _count_exchange(pg: PartitionedGraph, x: torch.Tensor, comm: str,
                    plan: Optional["RankPlan"] = None) -> None:
    """Account one full ring exchange in the obs metrics registry
    (repro/core/partition.py:69): S · stages block-sends of ``rows ×
    feat`` elements, ``raw_bytes`` at ``x``'s dtype, ``wire_bytes`` under
    ``comm``, and the bucket slots the ragged schedule touches beyond the
    real edges (``pad_slots``). On the mesh ring (``plan``, the rank's) a
    rank counts what it sends, ``stages`` blocks, and its share of the
    pad slots (Σ_s ws[s] less its own row's real slots), so the sums over
    the ranks equal the emulated pass's counts."""
    if not _metrics.enabled() or pg.n_shards < 2:
        return
    st = pg.stats
    elems = pg.rows * int(np.prod(x.shape[1:], dtype=np.int64))
    raw, wire = wire_bytes(elems, x.element_size(), comm)
    stages = st.ragged_stages if st.ragged_stages >= 0 else pg.n_shards - 1
    if plan is None:
        hops = pg.n_shards * stages
        slots = st.ragged_slots if st.ragged_slots > 0 else (
            pg.n_shards * pg.n_shards * pg.eb)
        pad = max(slots - pg.n_edges, 0)
    else:
        hops, pad = stages, plan.pad_slots
    _metrics.counter("comm.ring.raw_bytes").inc(hops * raw)
    _metrics.counter("comm.ring.wire_bytes").inc(hops * wire)
    _metrics.counter("comm.ring.pad_slots").inc(pad)


# --------------------------------------------------------------------- #
# the stage graphs (the kernel route's layout)
# --------------------------------------------------------------------- #
class StagePart:
    """One graph of real bucket slots on padded ids, for the kernels.

    ``g``'s caller edge order is the order of ``slots`` (flat indices
    ``(i·S + j)·eb + k`` into the (S, S, eb) bucket layout); ``canon`` is
    the slot of each of ``g``'s canonical edges and :attr:`rev_canon` of
    each of ``reverse(g)``'s (built at first use), so a bucketed weight is
    one gather from the order B1 reads on either graph. ``stage`` is the
    ring diagonal (-1 for a union of several)."""

    def __init__(self, stage: int, g: Graph, slots: np.ndarray):
        dev = g.device
        self.stage, self.g = stage, g
        self._host_slots = slots
        self.slots = torch.from_numpy(slots).to(dev)
        self.canon = torch.from_numpy(slots[g.host.eid]).to(dev)
        self._rev_canon: Optional[torch.Tensor] = None

    @property
    def rev(self) -> Graph:
        return reverse(self.g)

    @property
    def rev_canon(self) -> torch.Tensor:
        if self._rev_canon is None:
            self._rev_canon = torch.from_numpy(
                self._host_slots[self.rev.host.eid]).to(self.g.device)
        return self._rev_canon


def _diag_buckets(S: int, s: int) -> List[Tuple[int, int]]:
    """The buckets (i, j) of ring diagonal ``s``: i - j ≡ s (mod S)."""
    return [((j + s) % S, j) for j in range(S)]


def _make_part(pg: PartitionedGraph, stage: int,
               buckets) -> Optional[StagePart]:
    """The :class:`StagePart` of ``buckets``' real slots, or None."""
    h, S, rows, eb = pg.host, pg.n_shards, pg.rows, pg.eb
    src, dst, slots = [], [], []
    for i, j in buckets:
        k = pg.eb_ij[i][j]
        if not k:
            continue
        src.append(j * rows + h.src_local[i, j, :k].astype(np.int64))
        dst.append(i * rows + h.dst_local[i, j, :k].astype(np.int64))
        slots.append((i * S + j) * eb + np.arange(k, dtype=np.int64))
    if not slots:
        return None
    g = from_coo(np.concatenate(src), np.concatenate(dst), n_src=pg.n_pad,
                 n_dst=pg.n_pad, device=pg.device)
    return StagePart(stage, g, np.concatenate(slots))


class StagePlan:
    """Every kernel-route graph of one partition, each built on the host
    at first use: :attr:`stages` (one :class:`StagePart` per non-empty
    ring diagonal, in stage order), :attr:`local` (diagonal 0, or None),
    :attr:`remote` (every off-diagonal bucket, or None) and
    :attr:`everything` (every bucket, by padded destination:
    ``bucket_softmax``'s graph; None without edges)."""

    def __init__(self, pg: PartitionedGraph):
        self._pg = pg

    @functools.cached_property
    def stages(self) -> Tuple[StagePart, ...]:
        S = self._pg.n_shards
        return tuple(p for p in (_make_part(self._pg, s,
                                            _diag_buckets(S, s))
                                 for s in range(S)) if p is not None)

    @property
    def local(self) -> Optional[StagePart]:
        return next((p for p in self.stages if p.stage == 0), None)

    @functools.cached_property
    def remote(self) -> Optional[StagePart]:
        S = self._pg.n_shards
        return _make_part(self._pg, -1, [b for s in range(1, S)
                                         for b in _diag_buckets(S, s)])

    @functools.cached_property
    def everything(self) -> Optional[StagePart]:
        S = self._pg.n_shards
        return _make_part(self._pg, -1, [(i, j) for i in range(S)
                                         for j in range(S)])


def stage_plan(pg: PartitionedGraph) -> StagePlan:
    """The partition's :class:`StagePlan`, kept on ``pg``."""
    plan = pg._derived.get("stage_plan")
    if plan is None:
        plan = pg._derived["stage_plan"] = StagePlan(pg)
    return plan


# --------------------------------------------------------------------- #
# the kernel route
# --------------------------------------------------------------------- #
def _stage_sum(outs, like: torch.Tensor) -> torch.Tensor:
    """Σ of the per-stage outputs ``outs`` in stage order, accumulated in
    the accumulation dtype of ``like`` (fp32 for bf16) and cast once to
    ``like``'s dtype; zeros like ``like`` when there are none. The first
    output (widened) is the accumulator, the rest add into it in place
    (no autograd runs here)."""
    acc = None
    for o in outs:
        if acc is None:
            acc = o.to(accum_dtype(like.dtype))
        else:
            acc.add_(o)
    return torch.zeros_like(like) if acc is None else acc.to(like.dtype)


class _RingKernel(torch.autograd.Function):
    """Σ over ``parts`` of B1 (scalar weight per slot), in part order, in
    fp32, cast once to ``x``'s dtype; backward B1 on each part's reverse
    (∂x) and B3 ``dot`` per part (∂w, 0 on pad slots)."""

    @staticmethod
    def forward(ctx, parts, x, w):
        ctx.parts = parts
        ctx.save_for_backward(x, w)
        xd, wf = x.detach(), w.detach().reshape(-1)
        return _stage_sum((spmm_csr(p.g, xd, wf.index_select(
            0, p.canon).float()) for p in parts), x)

    @staticmethod
    def backward(ctx, ct):
        x, w = (t.detach() for t in ctx.saved_tensors)
        ct = ct.to(x.dtype).contiguous()
        wf = w.reshape(-1)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = _stage_sum((spmm_csr(p.rev, ct, wf.index_select(
                0, p.rev_canon).float()) for p in ctx.parts), x)
        if ctx.needs_input_grad[2]:
            dwf = torch.zeros(wf.shape, dtype=torch.float32,
                              device=x.device)
            for p in ctx.parts:
                d = sddmm_csr(p.g, "dot", "u", x, "v", ct)
                dwf.index_copy_(0, p.slots, d[:, 0].float())
            dw = dwf.to(w.dtype).reshape(w.shape)
        return None, dx, dw


def _stage_segment_sum(parts, x: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Σ over ``parts`` of ``u_mul_e_add_v`` with a per-head weight
    (``w`` (S, S, eb, H), ``x`` (n_pad, H, F)) on gspmm's sorted segment
    route per stage graph, in fp32, cast once. Autograd differentiates
    it (the segment route's scatter-free backward, bit-identical from
    call to call)."""
    from .binary_reduce import _execute, parse_op   # binary_reduce is heavy

    spec = parse_op("u_mul_e_add_v")
    wf = w.reshape((-1,) + tuple(w.shape[3:]))
    acc = None
    for p in parts:
        e = wf.index_select(0, p.slots)
        e = e.reshape(tuple(e.shape) + (1,) * (x.ndim - e.ndim))
        out = _execute(p.g, spec, x, e, "segment").to(accum_dtype(x.dtype))
        acc = out if acc is None else acc + out
    return torch.zeros_like(x) if acc is None else acc.to(x.dtype)


def _kernel_sum(parts, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel route of a weighted sum over ``parts``: B1 per part for
    a scalar weight per slot (features of any rank flattened to one
    width), else the per-stage segment route."""
    parts = tuple(p for p in parts if p is not None)
    if w.ndim > 3:
        return _stage_segment_sum(parts, x, w)
    if not parts:
        return torch.zeros_like(x)
    x2 = x.reshape(x.shape[0], -1).contiguous()
    return _RingKernel.apply(parts, x2, w).reshape(x.shape)


# --------------------------------------------------------------------- #
# the plain route: the JAX package's emulated ring
# (repro/core/partition.py:304-424)
# --------------------------------------------------------------------- #
def _stage_reduce(block, gather_idx, scatter_idx, wb, out):
    """Consume one bucket's real slots: gather from the resident block,
    weight (at the weight's own dtype), scatter-add into the accumulator.
    The transposed ring swaps the two index roles."""
    vals = block.index_select(0, gather_idx)
    if wb is not None:
        vals = vals * wb.reshape(tuple(wb.shape)
                                 + (1,) * (vals.ndim - wb.ndim))
    return out.index_add(0, scatter_idx, vals.to(out.dtype))


def _edge_dot(xg, cg, head_rank: int):
    """Per-slot <x, ct> over the trailing feature axes the weight does
    not carry: (k,) for scalar weights, (k, H) per-head."""
    acc = accum_dtype(torch.promote_types(xg.dtype, cg.dtype))
    prod = xg.to(acc) * cg.to(acc)
    axes = tuple(range(1 + head_rank, prod.ndim))
    return prod.sum(dim=axes) if axes else prod


def _buckets(pg: PartitionedGraph):
    """(i, j, k, src_local, dst_local) of every non-empty bucket, the
    index slices int64, in (i, j) order."""
    out = pg._derived.get("buckets")
    if out is None:
        sl, dl = pg.long("src_local"), pg.long("dst_local")
        out = pg._derived["buckets"] = [
            (i, j, pg.eb_ij[i][j], sl[i, j, :pg.eb_ij[i][j]],
             dl[i, j, :pg.eb_ij[i][j]])
            for i in range(pg.n_shards) for j in range(pg.n_shards)
            if pg.eb_ij[i][j]]
    return out


def _ring_fwd_emu(pg: PartitionedGraph, x, w):
    S, rows = pg.n_shards, pg.rows
    feat = tuple(x.shape[1:])
    xs = x.reshape((S, rows) + feat)
    acc = accum_dtype(x.dtype)
    outs = [torch.zeros((rows,) + feat, dtype=acc, device=x.device)
            for _ in range(S)]
    for i, j, k, sl, dl in _buckets(pg):
        outs[i] = _stage_reduce(xs[j], sl, dl, w[i, j, :k], outs[i])
    return torch.stack(outs).reshape((S * rows,) + feat).to(x.dtype)


def _ring_bwd_emu(pg: PartitionedGraph, x, w, ct):
    S, rows = pg.n_shards, pg.rows
    feat = tuple(x.shape[1:])
    head_rank = w.ndim - 3
    xs = x.reshape((S, rows) + feat)
    cts = ct.reshape((S, rows) + feat)
    acc = accum_dtype(x.dtype)
    dxs = [torch.zeros((rows,) + feat, dtype=acc, device=x.device)
           for _ in range(S)]
    dw = torch.zeros(w.shape, dtype=accum_dtype(
        torch.promote_types(x.dtype, ct.dtype)), device=x.device)
    for i, j, k, sl, dl in sorted(_buckets(pg), key=lambda b: (b[1], b[0])):
        # transposed: gather at dst, scatter at src (source shard j)
        dxs[j] = _stage_reduce(cts[i], dl, sl, w[i, j, :k], dxs[j])
        dw[i, j, :k] = _edge_dot(xs[j].index_select(0, sl),
                                 cts[i].index_select(0, dl), head_rank)
    dx = torch.stack(dxs).reshape((S * rows,) + feat).to(x.dtype)
    return dx, dw.to(w.dtype)


class _RingPlain(torch.autograd.Function):
    """JAX's emulated ring with its transposed-ring custom VJP."""

    @staticmethod
    def forward(ctx, pg, x, w):
        ctx.pg = pg
        ctx.save_for_backward(x, w)
        return _ring_fwd_emu(pg, x.detach(), w.detach())

    @staticmethod
    def backward(ctx, ct):
        x, w = (t.detach() for t in ctx.saved_tensors)
        dx, dw = _ring_bwd_emu(ctx.pg, x, w, ct)
        return (None, dx if ctx.needs_input_grad[1] else None,
                dw if ctx.needs_input_grad[2] else None)


# --------------------------------------------------------------------- #
# the mesh ring: one shard per rank of a process group
# (repro/core/partition.py:431-549, 677-760)
# --------------------------------------------------------------------- #
_FWD, _BWD_X, _BWD_CT = 0, 1, 2     # the three hop directions' tag bits


def _rank_part(pg: PartitionedGraph, stage: int, i: int,
               js) -> Optional[StagePart]:
    """The :class:`StagePart` of buckets ``(i, j)``, ``j`` in ``js``, on
    local ids (rows × rows: ``src_local`` → ``dst_local``), its slots
    ``j·eb + k`` in row ``i`` of the bucket layout; None without edges."""
    h, rows, eb = pg.host, pg.rows, pg.eb
    src, dst, slots = [], [], []
    for j in js:
        k = pg.eb_ij[i][j]
        src.append(h.src_local[i, j, :k].astype(np.int64))
        dst.append(h.dst_local[i, j, :k].astype(np.int64))
        slots.append(j * eb + np.arange(k, dtype=np.int64))
    slots = np.concatenate(slots)
    if not slots.size:
        return None
    g = from_coo(np.concatenate(src), np.concatenate(dst), n_src=rows,
                 n_dst=rows, device=pg.device)
    return StagePart(stage, g, slots)


class RankBucket:
    """Bucket ``(i, j)`` as the rank reducing it holds it: ``src`` /
    ``dst`` its real slots' local offsets (int64, slot order) and ``k``
    their count, for the plain route; :attr:`part`, built on the host at
    first use, its graph for the kernel route."""

    def __init__(self, pg: PartitionedGraph, stage: int, i: int, j: int):
        self.stage, self.i, self.j = stage, i, j
        self.k = pg.eb_ij[i][j]
        self.src = pg.long("src_local")[i, j, :self.k]
        self.dst = pg.long("dst_local")[i, j, :self.k]
        self._pg = pg

    @functools.cached_property
    def part(self) -> StagePart:
        return _rank_part(self._pg, self.stage, self.i, (self.j,))


class RankPlan:
    """One rank's view of a partition for the mesh ring (rank ``me`` of
    ``S``): per ring stage ``s``, ``fwd[s]`` — bucket ``(me, (me - s) %
    S)``, the forward's (or None when empty) — and ``bwd[s]`` — bucket
    ``((me + s) % S, me)``, whose reverse the backward reduces; ``s_max``
    the last non-empty diagonal (the ring's hops); :attr:`row` every
    bucket of the rank's row by local destination (the bucket softmax's
    graph); ``pad_slots`` the rank's share of the ragged schedule's pad
    slots. Every ring op draws a call number (:meth:`next_call`) that
    tags its messages with (call, stage, direction)."""

    def __init__(self, pg: PartitionedGraph, me: int):
        S = pg.n_shards
        ws = _diag_widths(pg)
        self.me, self.pg = me, pg
        self.s_max = max((s for s in range(S) if ws[s]), default=0)
        self.fwd = tuple(RankBucket(pg, s, me, (me - s) % S)
                         if pg.eb_ij[me][(me - s) % S] else None
                         for s in range(S))
        self.bwd = tuple(RankBucket(pg, s, (me + s) % S, me)
                         if pg.eb_ij[(me + s) % S][me] else None
                         for s in range(S))
        self.pad_slots = sum(ws) - sum(pg.eb_ij[me])
        self.calls = 0

    @functools.cached_property
    def row(self) -> Optional[StagePart]:
        return _rank_part(self.pg, -1, self.me, range(self.pg.n_shards))

    def next_call(self) -> int:
        self.calls += 1
        return self.calls

    @staticmethod
    def tag(call: int, stage: int, direction: int) -> int:
        """The base tag of a hop (4 tensors at most, ``tag + k``)."""
        return ((((call % 65536) << 10) | stage) << 4) | (direction << 2)


def rank_plan(pg: PartitionedGraph, group) -> RankPlan:
    """The calling rank's :class:`RankPlan` of ``pg`` on ``group`` (its
    size must be ``pg.n_shards``), built once and kept on ``pg``."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    if size != pg.n_shards:
        raise ValueError(f"the process group has {size} ranks; the "
                         f"partition has {pg.n_shards} shards")
    key = f"rank_plan:{rank_of(group)}"
    plan = pg._derived.get(key)
    if plan is None:
        plan = pg._derived[key] = RankPlan(pg, rank_of(group))
    return plan


def _check_shard(pg: PartitionedGraph, x: Optional[torch.Tensor] = None,
                 w: Optional[torch.Tensor] = None) -> None:
    """A rank's operands: (rows, …) node rows, a (1, S, eb[, H]) row."""
    if x is not None and x.shape[0] != pg.rows:
        raise ValueError(f"a rank's node block has {pg.rows} rows (the "
                         f"partition's); got {tuple(x.shape)}")
    if w is not None and tuple(w.shape[:3]) != (1, pg.n_shards, pg.eb):
        raise ValueError(f"a rank's bucket row is (1, {pg.n_shards}, "
                         f"{pg.eb}, …); got {tuple(w.shape)}")


def _rank_slots(w_row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries ``idx`` of a (S, eb[, H]) weight row, flattened."""
    return w_row.reshape((-1,) + tuple(w_row.shape[2:])).index_select(0, idx)


def _segment_stage(g, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``u_mul_e_add_v`` of a per-head weight ``e`` (caller order) on
    gspmm's sorted segment route, in the accumulation dtype."""
    from .binary_reduce import _execute, parse_op   # binary_reduce is heavy

    e = e.reshape(tuple(e.shape) + (1,) * (x.ndim - e.ndim))
    return _execute(g, parse_op("u_mul_e_add_v"), x, e, "segment").to(
        accum_dtype(x.dtype))


def _flat2(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).contiguous()


def _mesh_fwd_stage(route: str, b: RankBucket, block, w_row):
    """Bucket ``b``'s weighted sum of ``block`` into its local rows."""
    if route == "kernel":
        return spmm_csr(b.part.g, _flat2(block), _rank_slots(
            w_row, b.part.canon).float()).reshape(block.shape)
    if route == "segment":
        return _segment_stage(b.part.g, block, _rank_slots(w_row,
                                                           b.part.slots))
    out = torch.zeros(block.shape, dtype=accum_dtype(block.dtype),
                      device=block.device)
    return _stage_reduce(block, b.src, b.dst, w_row[b.j, :b.k], out)


def _mesh_dx_stage(route: str, b: RankBucket, ct, w_row):
    """∂x of bucket ``b`` (sources mine): gather at dst, scatter at src,
    ``w_row`` the destination shard's weight row."""
    if route == "kernel":
        return spmm_csr(b.part.rev, _flat2(ct), _rank_slots(
            w_row, b.part.rev_canon).float()).reshape(ct.shape)
    if route == "segment":
        return _segment_stage(b.part.rev, ct, _rank_slots(w_row,
                                                          b.part.slots))
    out = torch.zeros(ct.shape, dtype=accum_dtype(ct.dtype), device=ct.device)
    return _stage_reduce(ct, b.dst, b.src, w_row[b.j, :b.k], out)


def _mesh_dw_stage(route: str, b: RankBucket, block, ct, head_rank: int):
    """∂w of bucket ``b`` (destinations mine): ⟨x[src], ct[dst]⟩ per
    slot."""
    if route == "kernel":
        return sddmm_csr(b.part.g, "dot", "u", _flat2(block), "v",
                         _flat2(ct))[:, 0]
    return _edge_dot(block.index_select(0, b.src),
                     ct.index_select(0, b.dst), head_rank)


class _Int8Wire:
    """The int8 payload of a rank's block (``comm="int8"``): ``q`` in the
    padded layout's 256-value blocks over this block's span, front-padded
    by the block's offset into its first one, and one fp32 scale per
    block; :meth:`decode` dequantizes shard ``r``'s payload."""

    def __init__(self, shape, dtype, q, scales):
        self.shape, self.dtype, self.tensors = tuple(shape), dtype, [q, scales]

    def offset(self, shard: int) -> int:
        return (shard * int(np.prod(self.shape))) % BLOCK

    def decode(self, tensors, shard: int) -> torch.Tensor:
        q, scales = tensors
        n = int(np.prod(self.shape))
        off = self.offset(shard)
        deq = (q.reshape(-1, BLOCK).to(torch.float32) * scales[:, None])
        return deq.reshape(-1)[off:off + n].reshape(self.shape).to(
            self.dtype)


def _compress_shard(plan: RankPlan, group, x: torch.Tensor,
                    residual: torch.Tensor):
    """``compress_payload`` of this rank's block with the whole padded
    array's 256-value blocks (the emulated and JAX's quantization): a
    block straddling two ranks' spans takes the amax of both, from one
    ``all_gather`` of each rank's two end blocks. Returns ``(y,
    new_residual, wire)``."""
    n = x.numel()
    start = plan.me * n
    off = start % BLOCK
    length = (n // BLOCK + 2) * BLOCK
    target = x.detach().to(torch.float32).reshape(-1) + residual.reshape(-1)
    blocks = torch.nn.functional.pad(target, (off, length - off - n)
                                     ).reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1)
    # this span's first and last block: local row and padded-layout id
    ends = ((0, start // BLOCK), ((off + n - 1) // BLOCK,
                                  (start + n - 1) // BLOCK))
    mine = torch.tensor([[v for row, gid in ends
                          for v in (gid, float(amax[row]))]],
                        dtype=torch.float64, device=x.device)
    for b0, a0, b1, a1 in all_gather_rows(mine, group).tolist():
        for row, gid in ends:
            for b, a in ((b0, a0), (b1, a1)):
                if b == gid and a > float(amax[row]):
                    amax[row] = a
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127).to(
        torch.int8)
    deq = (q.to(torch.float32) * scales[:, None]).reshape(-1)[
        off:off + n].reshape(x.shape)
    y = x + (deq.to(x.dtype) - x).detach()
    wire = _Int8Wire(x.shape, x.dtype, q.reshape(-1), scales)
    return y, (target.reshape(x.shape) - deq).detach(), wire


class _MeshPass:
    """One weighted sum on the mesh ring: stages ``first``..``last`` of
    ``plan`` reduced on ``route`` ("plain", "kernel" or, for a per-head
    weight, "segment"), the source blocks sent raw or on ``wire``."""

    def __init__(self, plan: RankPlan, group, route: str, first: int,
                 last: int, wire: Optional[_Int8Wire]):
        self.plan, self.group, self.route = plan, group, route
        self.first, self.last, self.wire = first, last, wire
        self.call = plan.next_call()

    def _hop(self, tensors, step: int, stage: int, direction: int) -> Hop:
        return Hop(self.group, tensors, step,
                   self.plan.tag(self.call, stage, direction))

    def forward(self, x, w):
        S, me = self.plan.pg.n_shards, self.plan.me
        w_row = w[0]
        held = x
        wire = self.wire.tensors if self.wire is not None else [x]
        outs = []
        for s in range(self.last + 1):
            # post the next block's hop before this stage's reduce
            hop = self._hop(wire, 1, s, _FWD) if s < self.last else None
            b = self.plan.fwd[s]
            if b is not None and s >= self.first:
                outs.append(_mesh_fwd_stage(self.route, b, held, w_row))
            if hop is not None:
                wire = hop.wait()
                held = (wire[0] if self.wire is None
                        else self.wire.decode(wire, (me - s - 1) % S))
        return _stage_sum(outs, x)

    def backward(self, x, w, ct, need_dx: bool, need_dw: bool):
        """The transposed ring: x blocks forward (∂w of bucket (me, j)),
        cotangent blocks and weight rows backward (∂x of bucket (i, me))."""
        w_row = w[0]
        ct = ct.to(x.dtype).contiguous()
        xb, cb, wb = x, ct, w_row
        dxs = []
        dw = torch.zeros(w_row.shape, dtype=accum_dtype(
            torch.promote_types(x.dtype, ct.dtype)), device=x.device)
        for s in range(self.last + 1):
            hx = hc = None
            if s < self.last:
                hx = self._hop([xb], 1, s, _BWD_X) if need_dw else None
                hc = self._hop([cb, wb], -1, s, _BWD_CT) if need_dx else None
            if s >= self.first:
                bb, fb = self.plan.bwd[s], self.plan.fwd[s]
                if need_dx and bb is not None:
                    dxs.append(_mesh_dx_stage(self.route, bb, cb, wb))
                if need_dw and fb is not None:
                    dw[fb.j, :fb.k] = _mesh_dw_stage(self.route, fb, xb, ct,
                                                     w.ndim - 3)
            if hx is not None:
                xb, = hx.wait()
            if hc is not None:
                cb, wb = hc.wait()
        return (_stage_sum(dxs, x) if need_dx else None,
                dw.to(w.dtype)[None] if need_dw else None)


class _MeshRing(torch.autograd.Function):
    """A :class:`_MeshPass` and its transposed-ring backward."""

    @staticmethod
    def forward(ctx, op, x, w):
        ctx.op = op
        ctx.save_for_backward(x, w)
        return op.forward(x.detach(), w.detach())

    @staticmethod
    def backward(ctx, ct):
        x, w = (t.detach() for t in ctx.saved_tensors)
        dx, dw = ctx.op.backward(x, w, ct, ctx.needs_input_grad[1],
                                 ctx.needs_input_grad[2])
        return None, dx, dw


def _mesh_sum(pg: PartitionedGraph, group, part: str, x, w, strategy: str,
              wire: Optional[_Int8Wire] = None) -> torch.Tensor:
    """One weighted sum over ``part`` ('ring': every stage; 'remote': the
    off-diagonal buckets; 'local': the diagonal one, no exchange) of this
    rank's block ``x`` with its weight row ``w`` on the mesh ring."""
    plan = rank_plan(pg, group)
    _check_shard(pg, x, w)
    route = _resolve(strategy, x)
    if route == "kernel" and w.ndim > 3:
        route = "segment"
    first, last = {"ring": (0, plan.s_max), "remote": (1, plan.s_max),
                   "local": (0, 0)}[part]
    return _MeshRing.apply(_MeshPass(plan, group, route, first, last, wire),
                           x, w)


class _MeshRev:
    """``ring_edge_values`` on the mesh ring: the ``el`` blocks rotate
    forward, ``er`` stays local; B3 ``add`` (``kernel``) or the gather
    sum per stage. The backward: ∂er local over the rank's row, ∂el the
    transposed ring of cotangent rows (B4 ``copy_rhs``, or
    ``index_add``)."""

    def __init__(self, plan: RankPlan, group, kernel: bool):
        self.plan, self.group, self.kernel = plan, group, kernel
        self.call = plan.next_call()

    def forward(self, el, er):
        pg = self.plan.pg
        feat = tuple(el.shape[1:])
        out = torch.zeros((pg.n_shards, pg.eb) + feat,
                          dtype=torch.promote_types(el.dtype, er.dtype),
                          device=el.device)
        held = el
        for s in range(self.plan.s_max + 1):
            hop = (Hop(self.group, [held], 1,
                       self.plan.tag(self.call, s, _FWD))
                   if s < self.plan.s_max else None)
            b = self.plan.fwd[s]
            if b is not None:
                out[b.j, :b.k] = (
                    sddmm_csr(b.part.g, "add", "u", held, "v", er)
                    if self.kernel else held.index_select(0, b.src)
                    + er.index_select(0, b.dst))
            if hop is not None:
                held, = hop.wait()
        return out[None]

    def _scatter(self, b: RankBucket, vals, rev: bool):
        if self.kernel:
            return binary_reduce_csr(b.part.rev if rev else b.part.g, None,
                                     vals.contiguous(), "copy_rhs")
        acc = accum_dtype(vals.dtype)
        out = torch.zeros((self.plan.pg.rows,) + tuple(vals.shape[1:]),
                          dtype=acc, device=vals.device)
        return out.index_add(0, b.src if rev else b.dst, vals.to(acc))

    def backward(self, ct):
        row = ct[0].contiguous()
        like = row.new_empty((self.plan.pg.rows,) + tuple(row.shape[2:]))
        d_er = _stage_sum([self._scatter(b, row[b.j, :b.k], False)
                           for b in self.plan.fwd if b is not None], like)
        outs, cb = [], row
        for s in range(self.plan.s_max + 1):
            hop = (Hop(self.group, [cb], -1,
                       self.plan.tag(self.call, s, _BWD_CT))
                   if s < self.plan.s_max else None)
            b = self.plan.bwd[s]
            if b is not None:
                outs.append(self._scatter(b, cb[b.j, :b.k], True))
            if hop is not None:
                cb, = hop.wait()
        return _stage_sum(outs, like), d_er


class _MeshRevFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, el, er):
        ctx.op, ctx.dtypes = op, (el.dtype, er.dtype)
        return op.forward(el.detach().contiguous(), er.detach().contiguous())

    @staticmethod
    def backward(ctx, ct):
        d_el, d_er = ctx.op.backward(ct)
        return None, d_el.to(ctx.dtypes[0]), d_er.to(ctx.dtypes[1])


# --------------------------------------------------------------------- #
# the public ops
# --------------------------------------------------------------------- #
def _resolve(strategy: str, x: torch.Tensor) -> str:
    """``"plain"`` or ``"kernel"`` for ``strategy`` on features ``x``:
    auto takes the kernels wherever they load the feature dtype."""
    if strategy not in RING_STRATEGIES:
        raise ValueError(f"unknown ring strategy {strategy!r}; expected "
                         f"one of {RING_STRATEGIES}")
    if strategy == "auto":
        return "kernel" if x.dtype in FEATURE_DTYPES else "plain"
    return strategy


def _ring_sum(pg: PartitionedGraph, part: str, x, w, strategy: str,
              group=None, wire: Optional[_Int8Wire] = None) -> torch.Tensor:
    """One weighted sum over ``part`` ('ring': every stage; 'remote': the
    off-diagonal buckets) on the resolved route; on the mesh ring with a
    ``group``."""
    if group is not None:
        return _mesh_sum(pg, group, part, x, w, strategy, wire)
    if _resolve(strategy, x) == "plain":
        if part == "remote":
            w = offdiag_weights(pg, w)
        return _RingPlain.apply(pg, x, w)
    plan = stage_plan(pg)
    parts = plan.stages if part == "ring" else (plan.remote,)
    return _kernel_sum(parts, x, w)


def ring_gspmm(pg: PartitionedGraph, x: torch.Tensor, w: torch.Tensor, *,
               mesh=None, axis: str = "data", comm: str = "none",
               residual: Optional[torch.Tensor] = None,
               strategy: str = "auto"):
    """Sharded weighted CR-sum: ``out[v] = Σ_{e=(u→v)} w_e · x[u]``.

    ``x``: (n_pad, *feat) in the padded layout
    (:meth:`PartitionedGraph.scatter_nodes`); ``w``: bucketed weights,
    (S, S, eb) scalar or (S, S, eb, H) per head against (H, F) features
    (:meth:`~PartitionedGraph.scatter_edges`; fold 1/deg into ``w`` for
    mean). Returns (n_pad, *feat) destination sums, differentiable in
    ``x`` and ``w``. With a process group ``mesh`` every operand and the
    result are the rank's: ``x`` (rows, *feat), ``w`` (1, S, eb[, H]).

    ``comm="int8"`` puts the cross-shard payload on the compressed wire:
    the source blocks are quantized once, at their owner (blockwise int8,
    an fp32 scale per 256 values of the padded layout), with the
    error-feedback ``residual`` ((n_pad, *feat) fp32 — the rank's rows on
    the mesh — required) folded in; owner-local (diagonal) edges read the
    raw features, the remote ones the dequantized values (on the mesh the
    int8 payload and its scales travel the ring), straight-through for
    autograd. Returns ``(out, new_residual)``.
    """
    group = process_group(mesh)
    if comm not in COMM_MODES:
        raise ValueError(f"comm must be one of {COMM_MODES}: {comm!r}")
    plan = None if group is None else rank_plan(pg, group)
    if comm == "none":
        _count_exchange(pg, x, "none", plan)
        return _ring_sum(pg, "ring", x, w, strategy, group)
    if residual is None:
        raise ValueError('comm="int8" needs the error-feedback residual '
                         "(init with torch.zeros((n_pad, *feat)))")
    y, new_residual, wire = _compress(plan, group, x, residual)
    _count_exchange(pg, x, "int8", plan)
    out = (local_gspmm(pg, x, w, mesh=group, strategy=strategy)
           + _ring_sum(pg, "remote", y, w, strategy, group, wire))
    return out, new_residual


def _compress(plan: Optional[RankPlan], group, x, residual):
    """``(y, new_residual, wire)`` of the int8 exchange: the whole padded
    array's (``compress_payload``, no wire) or the rank's block's."""
    if group is None:
        return compress_payload(x, residual) + (None,)
    return _compress_shard(plan, group, x, residual)


def ring_reference(pg: PartitionedGraph, x: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device oracle (same padded layout, the plain loop, no
    autograd). ``w`` defaults to 1 on every real slot, fp32."""
    if w is None:
        w = pg.mask.to(torch.float32)
    with torch.no_grad():
        return _ring_fwd_emu(pg, x, w)


# --------------------------------------------------------------------- #
# per-edge operand assembly + destination softmax (GAT)
# (repro/core/partition.py:623-816)
# --------------------------------------------------------------------- #
def _rev_fwd_emu(pg: PartitionedGraph, el, er):
    S, rows, eb = pg.n_shards, pg.rows, pg.eb
    feat = tuple(el.shape[1:])
    els = el.reshape((S, rows) + feat)
    ers = er.reshape((S, rows) + feat)
    out = torch.zeros((S, S, eb) + feat,
                      dtype=torch.promote_types(el.dtype, er.dtype),
                      device=el.device)
    for i, j, k, sl, dl in _buckets(pg):
        out[i, j, :k] = els[j].index_select(0, sl) + ers[i].index_select(0, dl)
    return out


def _rev_bwd_emu(pg: PartitionedGraph, ct):
    S, rows = pg.n_shards, pg.rows
    feat = tuple(ct.shape[3:])
    acc = accum_dtype(ct.dtype)
    dels = [torch.zeros((rows,) + feat, dtype=acc, device=ct.device)
            for _ in range(S)]
    ders = [torch.zeros((rows,) + feat, dtype=acc, device=ct.device)
            for _ in range(S)]
    for i, j, k, sl, dl in _buckets(pg):
        dels[j] = dels[j].index_add(0, sl, ct[i, j, :k].to(acc))
        ders[i] = ders[i].index_add(0, dl, ct[i, j, :k].to(acc))
    return (torch.stack(dels).reshape((S * rows,) + feat).to(ct.dtype),
            torch.stack(ders).reshape((S * rows,) + feat).to(ct.dtype))


class _RevPlain(torch.autograd.Function):
    """JAX's emulated ``ring_edge_values`` with its custom VJP."""

    @staticmethod
    def forward(ctx, pg, el, er):
        ctx.pg = pg
        ctx.dtypes = (el.dtype, er.dtype)
        return _rev_fwd_emu(pg, el.detach(), er.detach())

    @staticmethod
    def backward(ctx, ct):
        d_el, d_er = _rev_bwd_emu(ctx.pg, ct)
        return None, d_el.to(ctx.dtypes[0]), d_er.to(ctx.dtypes[1])


class _RevKernel(torch.autograd.Function):
    """B3 ``add`` u,v per stage graph into the bucket layout; backward B4
    ``copy_rhs`` on each stage's reverse (∂el) and on the stage (∂er)."""

    @staticmethod
    def forward(ctx, pg, el, er):
        ctx.pg = pg
        ctx.dtypes = (el.dtype, er.dtype)
        S, eb = pg.n_shards, pg.eb
        el, er = el.detach().contiguous(), er.detach().contiguous()
        out = torch.zeros((S * S * eb, el.shape[1]), dtype=el.dtype,
                          device=el.device)
        for p in stage_plan(pg).stages:
            out.index_copy_(0, p.slots, sddmm_csr(p.g, "add", "u", el,
                                                  "v", er))
        return out.reshape(S, S, eb, el.shape[1])

    @staticmethod
    def backward(ctx, ct):
        pg = ctx.pg
        ctf = ct.reshape(-1, ct.shape[-1])
        like = ctf.new_empty((pg.n_pad, ctf.shape[1]))
        stages = stage_plan(pg).stages
        cts = [ctf.index_select(0, p.slots) for p in stages]
        d_el = _stage_sum((binary_reduce_csr(p.rev, None, c, "copy_rhs")
                           for p, c in zip(stages, cts)), like)
        d_er = _stage_sum((binary_reduce_csr(p.g, None, c, "copy_rhs")
                           for p, c in zip(stages, cts)), like)
        return None, d_el.to(ctx.dtypes[0]), d_er.to(ctx.dtypes[1])


def ring_edge_values(pg: PartitionedGraph, el: torch.Tensor,
                     er: torch.Tensor, *, mesh=None, axis: str = "data",
                     strategy: str = "auto") -> torch.Tensor:
    """Bucketed per-edge sums ``el[src_e] + er[dst_e]`` — GAT's
    ``u_add_v_copy_e`` on shards. ``el`` / ``er``: (n_pad, *feat) padded
    node values. Returns (S, S, eb, *feat), 0 on pad slots; with a
    process group ``mesh``, the rank's (rows, *feat) blocks in and its
    (1, S, eb, *feat) row out. The kernel route takes rank-2 operands of
    one feature dtype; others run plain."""
    group = process_group(mesh)
    dtype = torch.promote_types(el.dtype, er.dtype)
    kernel = (_resolve(strategy, el.to(dtype)) == "kernel" and el.ndim == 2
              and er.ndim == 2 and dtype in FEATURE_DTYPES)
    if kernel:
        el, er = el.to(dtype), er.to(dtype)
    if group is not None:
        _check_shard(pg, el)
        _check_shard(pg, er)
        return _MeshRevFn.apply(_MeshRev(rank_plan(pg, group), group,
                                         kernel), el, er)
    if kernel:
        return _RevKernel.apply(pg, el, er)
    return _RevPlain.apply(pg, el, er)


def _bucket_softmax_plain(logits: torch.Tensor, gdst: torch.Tensor,
                          mask: torch.Tensor, n_rows: int) -> torch.Tensor:
    """JAX's ``bucket_softmax`` over bucketed logits whose slots land on
    rows ``gdst`` (flat) of ``n_rows``: masked max by destination (a
    shift the softmax cancels, so taken without a gradient), exp, masked
    sum, divide by max(sum, 1e-20); pad slots 0."""
    feat = tuple(logits.shape[3:])
    flat = logits.reshape((gdst.shape[0],) + feat)
    mkr = mask.reshape((-1,) + (1,) * len(feat))
    idx = gdst.reshape((-1,) + (1,) * len(feat)).expand_as(flat)
    with torch.no_grad():
        neg = torch.full((), float("-inf"), dtype=flat.dtype,
                         device=flat.device)
        m = torch.full((n_rows,) + feat, float("-inf"), dtype=flat.dtype,
                       device=flat.device).scatter_reduce(
            0, idx, torch.where(mkr, flat, neg), "amax", include_self=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.where(mkr, torch.exp(flat - m.index_select(0, gdst)),
                     flat.new_zeros(()))
    z = flat.new_zeros((n_rows,) + feat).index_add(0, gdst, ex)
    alpha = ex / torch.clamp(z.index_select(0, gdst), min=1e-20)
    return alpha.reshape(logits.shape)


def bucket_softmax(pg: PartitionedGraph, logits: torch.Tensor, *,
                   mesh=None, strategy: str = "auto") -> torch.Tensor:
    """Destination softmax over bucketed edge logits (S, S, eb, *feat);
    every bucket of destination shard ``i`` is owner-resident, so no
    exchange. Pad slots come back 0. With a process group ``mesh`` the
    logits are the rank's row (1, S, eb, *feat). The kernel route is B5
    (fp32) on the graph of every bucket (of the rank's row); a bf16
    operand takes the plain form."""
    from .edge_softmax import edge_softmax_fused

    group = process_group(mesh)
    if group is None:
        S, rows = pg.n_shards, pg.rows
        graph = stage_plan(pg).everything
        gdst = (torch.arange(S, device=logits.device)[:, None, None] * rows
                + pg.long("dst_local")).reshape(-1)
        mask, n_rows = pg.mask, pg.n_pad
    else:
        me = rank_of(group)
        graph = rank_plan(pg, group).row
        _check_shard(pg, w=logits)
        gdst = pg.long("dst_local")[me].reshape(-1)
        mask, n_rows = pg.mask[me], pg.rows
    if (_resolve(strategy, logits) == "plain"
            or logits.dtype != torch.float32 or graph is None):
        return _bucket_softmax_plain(logits, gdst, mask, n_rows)
    flat = logits.reshape(gdst.shape[0], -1)
    alpha = edge_softmax_fused(graph.g, flat.index_select(0, graph.slots),
                               strategy="kernel")
    return flat.new_zeros(flat.shape).index_copy(
        0, graph.slots, alpha).reshape(logits.shape)


# --------------------------------------------------------------------- #
# delayed halo (repro/core/partition.py:822-895)
# --------------------------------------------------------------------- #
def _local_plain(pg: PartitionedGraph, x, w):
    """JAX's ``local_gspmm``: the diagonal buckets' real slots in one
    gather and one scatter-add, differentiated by autograd."""
    S, rows = pg.n_shards, pg.rows
    feat = tuple(x.shape[1:])
    acc_t = accum_dtype(x.dtype)
    acc = torch.zeros((pg.n_pad,) + feat, dtype=acc_t, device=x.device)
    for d in range(S):
        k = pg.eb_ij[d][d]
        if not k:
            continue
        gsrc = d * rows + pg.long("src_local")[d, d, :k]
        gdst = d * rows + pg.long("dst_local")[d, d, :k]
        wv = w[d, d, :k]
        vals = x.index_select(0, gsrc)
        vals = vals * wv.reshape(tuple(wv.shape)
                                 + (1,) * (vals.ndim - wv.ndim))
        acc = acc.index_add(0, gdst, vals.to(acc_t))
    return acc.to(x.dtype)


def local_gspmm(pg: PartitionedGraph, x: torch.Tensor, w: torch.Tensor, *,
                mesh=None, strategy: str = "auto") -> torch.Tensor:
    """Owner-local part only: the diagonal (d, d) buckets, no exchange.
    The kernel route is B1 on the diagonal-0 stage graph. With a process
    group ``mesh``, the rank's block, row and bucket (me, me)."""
    group = process_group(mesh)
    if group is not None:
        return _mesh_sum(pg, group, "local", x, w, strategy)
    if _resolve(strategy, x) == "plain":
        return _local_plain(pg, x, w)
    return _kernel_sum((stage_plan(pg).local,), x, w)


def offdiag_weights(pg: PartitionedGraph, w: torch.Tensor, *,
                    mesh=None) -> torch.Tensor:
    """Zero the diagonal buckets — the remote-only weight view (with a
    process group ``mesh``: of the rank's row, bucket (me, me))."""
    S = pg.n_shards
    off = 1.0 - torch.eye(S, dtype=w.dtype, device=w.device)
    group = process_group(mesh)
    if group is not None:
        off = off[rank_of(group)][None]
    return w * off.reshape(tuple(off.shape) + (1,) * (w.ndim - 2))


def ring_gspmm_delayed(pg: PartitionedGraph, x: torch.Tensor,
                       w: torch.Tensor, stale: torch.Tensor, refresh: bool,
                       *, mesh=None, axis: str = "data", comm: str = "none",
                       residual: Optional[torch.Tensor] = None,
                       strategy: str = "auto"):
    """Weighted CR with a delayed halo: ``out = local + remote``, the
    remote partial (every cross-shard bucket) recomputed only when
    ``refresh`` (a Python bool) and otherwise reused from ``stale``.
    Gradients flow through the local part always, through the remote
    part on refresh steps only. Returns ``(out, remote)``, ``remote``
    detached (the next step's ``stale``); a refresh step is exact.

    ``comm="int8"`` compresses the refresh exchange as
    :func:`ring_gspmm` does (needs ``residual``; the local part reads raw
    features); a stale step moves no bytes and passes the residual
    through. Returns ``(out, remote, new_residual)``. With a process
    group ``mesh`` every tensor is the rank's (``stale`` its rows).
    """
    group = process_group(mesh)
    if comm not in COMM_MODES:
        raise ValueError(f"comm must be one of {COMM_MODES}: {comm!r}")
    plan = None if group is None else rank_plan(pg, group)
    loc = local_gspmm(pg, x, w, mesh=group, strategy=strategy)
    if comm == "int8":
        if residual is None:
            raise ValueError('comm="int8" needs the error-feedback '
                             "residual")
        if refresh:
            y, residual, wire = _compress(plan, group, x, residual)
            _count_exchange(pg, x, "int8", plan)
            remote = _ring_sum(pg, "remote", y, w, strategy, group, wire)
        else:
            remote = stale.detach()
        return loc + remote, remote.detach(), residual
    if refresh:
        _count_exchange(pg, x, "none", plan)
        remote = _ring_sum(pg, "remote", x, w, strategy, group)
    else:
        remote = stale.detach()
    return loc + remote, remote.detach()
