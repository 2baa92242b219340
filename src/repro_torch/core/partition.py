"""Partitioned-graph execution on the emulated ring (port of
``repro/core/partition.py``, its ``mesh=None`` path).

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

* ``"plain"`` — the JAX package's emulated ring, bucket by bucket
  (``_stage_reduce`` over the S² buckets, the transposed ring as the
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
  (n_pad, H, F) features) is rank 3, which no kernel takes: it runs per
  stage graph on gspmm's sorted segment route, as full-graph GAT's
  ``u_mul_e_add_v`` does. On a CPU tensor the wrappers run their plain
  versions; on the card a kernel that fails to build or launch fails.

A non-``None`` ``mesh`` (a ``torch.distributed`` process group: one shard
per card, the ring's blocks sent between them) raises
``NotImplementedError``: it is ROADMAP A12's last item.
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
from ..optim.compression import compress_payload, wire_bytes
from ..optim.precision import accum_dtype
from .graph import Graph, from_coo, reverse

__all__ = ["PartitionStats", "PartitionedGraph", "build_partition",
           "ring_gspmm", "ring_edge_values", "bucket_softmax",
           "local_gspmm", "offdiag_weights", "ring_gspmm_delayed",
           "ring_reference", "stage_plan", "PARTITION_MODES", "COMM_MODES",
           "RING_STRATEGIES"]

PARTITION_MODES = ("contiguous", "hash", "uniform")
COMM_MODES = ("none", "int8")
RING_STRATEGIES = ("auto", "kernel", "plain")


def check_mesh(mesh) -> None:
    """The port runs the emulated ring only (``mesh=None``)."""
    if mesh is not None:
        raise NotImplementedError(
            "the torch.distributed ring (one shard per card) is ROADMAP "
            "A12's last item; pass mesh=None for the emulated ring")


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


def _count_exchange(pg: PartitionedGraph, x: torch.Tensor,
                    comm: str) -> None:
    """Account one full ring exchange in the obs metrics registry
    (repro/core/partition.py:69): S · stages block-sends of ``rows ×
    feat`` elements, ``raw_bytes`` at ``x``'s dtype, ``wire_bytes`` under
    ``comm``, and the bucket slots the ragged schedule touches beyond the
    real edges (``pad_slots``)."""
    if not _metrics.enabled() or pg.n_shards < 2:
        return
    st = pg.stats
    elems = pg.rows * int(np.prod(x.shape[1:], dtype=np.int64))
    raw, wire = wire_bytes(elems, x.element_size(), comm)
    stages = st.ragged_stages if st.ragged_stages >= 0 else pg.n_shards - 1
    hops = pg.n_shards * stages
    _metrics.counter("comm.ring.raw_bytes").inc(hops * raw)
    _metrics.counter("comm.ring.wire_bytes").inc(hops * wire)
    slots = st.ragged_slots if st.ragged_slots > 0 else (
        pg.n_shards * pg.n_shards * pg.eb)
    _metrics.counter("comm.ring.pad_slots").inc(max(slots - pg.n_edges, 0))


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
    route per stage graph — rank 3, which no kernel takes — in fp32,
    cast once. Autograd differentiates it (the segment route's
    scatter-free backward, bit-identical from call to call)."""
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


def _ring_sum(pg: PartitionedGraph, part: str, x, w,
              strategy: str) -> torch.Tensor:
    """One weighted sum over ``part`` ('ring': every stage; 'remote': the
    off-diagonal buckets) on the resolved route."""
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
    ``x`` and ``w``.

    ``comm="int8"`` puts the cross-shard payload on the compressed wire:
    the source blocks are quantized once (blockwise int8, an fp32 scale
    per 256 values) with the error-feedback ``residual`` ((n_pad, *feat)
    fp32, required) folded in; owner-local (diagonal) edges read the raw
    features, the remote ones the dequantized values, straight-through
    for autograd. Returns ``(out, new_residual)``.
    """
    check_mesh(mesh)
    if comm not in COMM_MODES:
        raise ValueError(f"comm must be one of {COMM_MODES}: {comm!r}")
    if comm == "none":
        _count_exchange(pg, x, "none")
        return _ring_sum(pg, "ring", x, w, strategy)
    if residual is None:
        raise ValueError('comm="int8" needs the error-feedback residual '
                         "(init with torch.zeros((n_pad, *feat)))")
    y, new_residual = compress_payload(x, residual)
    _count_exchange(pg, x, "int8")
    out = (local_gspmm(pg, x, w, strategy=strategy)
           + _ring_sum(pg, "remote", y, w, strategy))
    return out, new_residual


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
    node values. Returns (S, S, eb, *feat), 0 on pad slots. The kernel
    route takes rank-2 operands of one feature dtype; others run
    plain."""
    check_mesh(mesh)
    dtype = torch.promote_types(el.dtype, er.dtype)
    if (_resolve(strategy, el.to(dtype)) == "kernel" and el.ndim == 2
            and er.ndim == 2 and dtype in FEATURE_DTYPES):
        return _RevKernel.apply(pg, el.to(dtype), er.to(dtype))
    return _RevPlain.apply(pg, el, er)


def _bucket_softmax_plain(pg: PartitionedGraph, logits: torch.Tensor
                          ) -> torch.Tensor:
    """JAX's ``bucket_softmax``: masked max by padded destination (a
    shift the softmax cancels, so taken without a gradient), exp, masked
    sum, divide by max(sum, 1e-20); pad slots 0."""
    S, rows, eb = pg.n_shards, pg.rows, pg.eb
    feat = tuple(logits.shape[3:])
    gdst = (torch.arange(S, device=logits.device)[:, None, None] * rows
            + pg.long("dst_local")).reshape(-1)
    flat = logits.reshape((S * S * eb,) + feat)
    mkr = pg.mask.reshape((-1,) + (1,) * len(feat))
    idx = gdst.reshape((-1,) + (1,) * len(feat)).expand_as(flat)
    with torch.no_grad():
        neg = torch.full((), float("-inf"), dtype=flat.dtype,
                         device=flat.device)
        m = torch.full((pg.n_pad,) + feat, float("-inf"), dtype=flat.dtype,
                       device=flat.device).scatter_reduce(
            0, idx, torch.where(mkr, flat, neg), "amax", include_self=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.where(mkr, torch.exp(flat - m.index_select(0, gdst)),
                     flat.new_zeros(()))
    z = flat.new_zeros((pg.n_pad,) + feat).index_add(0, gdst, ex)
    alpha = ex / torch.clamp(z.index_select(0, gdst), min=1e-20)
    return alpha.reshape((S, S, eb) + feat)


def bucket_softmax(pg: PartitionedGraph, logits: torch.Tensor, *,
                   strategy: str = "auto") -> torch.Tensor:
    """Destination softmax over bucketed edge logits (S, S, eb, *feat);
    every bucket of destination shard ``i`` is owner-resident, so no
    exchange. Pad slots come back 0. The kernel route is B5 (fp32) on the
    graph of every bucket; a bf16 operand takes the plain form."""
    from .edge_softmax import edge_softmax_fused

    if (_resolve(strategy, logits) == "plain"
            or logits.dtype != torch.float32
            or stage_plan(pg).everything is None):
        return _bucket_softmax_plain(pg, logits)
    everything = stage_plan(pg).everything
    flat = logits.reshape(pg.n_shards * pg.n_shards * pg.eb, -1)
    alpha = edge_softmax_fused(everything.g,
                               flat.index_select(0, everything.slots),
                               strategy="kernel")
    return flat.new_zeros(flat.shape).index_copy(
        0, everything.slots, alpha).reshape(logits.shape)


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
                strategy: str = "auto") -> torch.Tensor:
    """Owner-local part only: the diagonal (d, d) buckets, no exchange.
    The kernel route is B1 on the diagonal-0 stage graph."""
    if _resolve(strategy, x) == "plain":
        return _local_plain(pg, x, w)
    return _kernel_sum((stage_plan(pg).local,), x, w)


def offdiag_weights(pg: PartitionedGraph, w: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal buckets — the remote-only weight view."""
    S = pg.n_shards
    off = 1.0 - torch.eye(S, dtype=w.dtype, device=w.device)
    return w * off.reshape((S, S) + (1,) * (w.ndim - 2))


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
    through. Returns ``(out, remote, new_residual)``.
    """
    check_mesh(mesh)
    if comm not in COMM_MODES:
        raise ValueError(f"comm must be one of {COMM_MODES}: {comm!r}")
    loc = local_gspmm(pg, x, w, strategy=strategy)
    if comm == "int8":
        if residual is None:
            raise ValueError('comm="int8" needs the error-feedback '
                             "residual")
        if refresh:
            y, residual = compress_payload(x, residual)
            _count_exchange(pg, x, "int8")
            remote = _ring_sum(pg, "remote", y, w, strategy)
        else:
            remote = stale.detach()
        return loc + remote, remote.detach(), residual
    if refresh:
        _count_exchange(pg, x, "none")
        remote = _ring_sum(pg, "remote", x, w, strategy)
    else:
        remote = stale.detach()
    return loc + remote, remote.detach()
