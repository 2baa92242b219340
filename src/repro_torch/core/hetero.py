"""Relation-fused heterogeneous execution (port of ``repro/core/hetero.py``).

R-GCN (many relations), GC-MC (one relation per rating level), MoNet (one
per mixture kernel) and LGNN (node graph, line graph and the map between
them) all compute

    out[v] = ⊕_r Σ_{(u→v) ∈ E_r}  msg_r(u, e)

:class:`RelGraph` stacks every relation's edges into ONE fused
:class:`~repro_torch.core.graph.Graph` (canonical (dst, src) order) with a
relation id per edge, the per-relation mean weight 1/c_{v,r}, a
relation-sorted view (the per-relation loop's) and a (src, rel)-sorted
reverse table, each array equal to the JAX package's.

Strategies of :func:`hetero_gspmm`:

* ``"fused"`` — relation-indexed messages (:func:`_messages`, with the
  JAX package's switch between per-edge ``W`` indexing and the
  relation-batched pre-transform at ``_EDGE_MODE_ELEMS``, so it rounds as
  JAX does), then one sorted segment reduce (``pull_segment``). Every
  reducer. The reference.
* ``"loop"`` — one aggregation per relation over the relation-sorted
  view, the pre-fusion baseline. As in JAX (``planner.plan_hetero``), a
  plain gspmm name pins it: ``"segment"``, ``"onehot"``, ``"pallas"`` and
  ``"ring"`` the loop's segment form, ``"push"`` the loop with each
  relation scatter-reduced (``strategies.push_scatter``, the fig. 2
  baseline).
* ``"ell"`` — the fused messages reduced by the fused graph's blocked
  pull (``binary_reduce._gspmm_ell`` over its ELL pack). When relation
  sizes are skewed (:func:`_build_skew_classes`: at least 3 non-empty
  relations, the largest ≥ 8× the median, two or more log2 size
  classes) the sum, max and min split the edge set per size class, each
  class with its own sub-graph and ELL pack, so one giant relation does
  not set the pad width of every small one; the class partials combine
  (sum, or ±inf-kept extrema finalized once).
* ``"kernel"`` — B1 (``spmm_csr``) with a per-edge scalar weight, sum and
  mean only. Every relational message is a row of a per-(src, rel) table
  (``u @ W_r``, MoNet's 3-D ``u``, the basis-composed ``W_r``) or a plain
  ``u[src]`` row, scaled by the e operand and / or the per-relation mean
  weight. So the table's rows are the sources of a *relation-expanded*
  graph (:meth:`RelGraph.expanded`: sources ``src·R + rel``, destinations
  and caller edge order unchanged, built once per RelGraph on the host)
  and the fused sum is B1 on it, the weights in caller order. A plain
  ``u[src]`` message does not depend on the relation, so that form runs
  B1 on the fused graph itself (the expansion with R collapsed to 1) and
  makes no R-fold copy of ``u``. The expanded graph sorts (dst, src·R +
  rel), so its fp32 sums round differently from the fused route's.
  It rides ``gspmm``'s kernel route, so it differentiates through
  ``_KernelGspmm``: B1 on the expanded graph's reverse, whose canonical
  order is the JAX (src, rel)-sorted reverse table, and B3 ``u_dot_v``
  for an e operand. Operands may be fp32 or bf16 (B1's bf16 form: the
  table in bf16, the weights fp32, fp32 sums). A pinned ``"kernel"`` on a
  max or min, or on operands of another dtype, falls back to ``"fused"``
  with a one-time warning.
* ``"auto"`` — the planner's choice (``planner.plan_hetero``, logged
  ``hetero:<op>``): JAX's cost rows for fused, ell and loop, and a
  kernel row (B1's rate over the fused edges plus its per-call cost) on
  an fp32 or bf16 sum / mean.

The packs and the skew classes are built on the host at first use and
kept (the classes on the RelGraph, each pack in its graph's PlanCache);
a backward only reads them.

The kernel route's table, and its memory: a (n_src·R, d_out) fp32 tensor.
The ``w`` form is one relation-batched product ``einsum(u, W)``. The basis
form keeps ``W`` factored, as the JAX fused route does: ``hb = u @ basis``
(n·B·d·o multiply-adds), then ``hb`` contracted with ``coeff`` (n·R·B·o),
against n·R·d·o for composing ``W_r = coeff @ basis`` first. At the
100-relation shape of ``benchmarks/fig_hetero.py`` (n 4000, R 100, d 32
→ 16, B 4) that is 8.2M + 25.6M multiply-adds against 204.8M, and the
table holds 4000·100·16 floats = 25.6 MB (``hb`` 1.0 MB); 3-D ``u`` is
its own table, reshaped without a copy.

Gradients, per route: the kernel route through ``_KernelGspmm`` (B1 on
the expansion's reverse for ∂table — the table's einsum stays outside,
so autograd carries ∂table on to ``u``, ``w``, ``basis``, ``coeff`` —
and B3 ``u_dot_v`` for ∂e); ``fused`` and ``ell`` with a sum or mean
through :class:`_HeteroFusedRev`, JAX's gather VJP
(``_hetero_fused_rev``): one sorted segment reduce over the (src, rel)
reverse table, then dense einsums, no scatter, so it is bit-identical
from call to call on the card; ``loop``, ``push``, max and min by
autograd, as in JAX. Eager calls are timed through
:func:`repro_torch.obs.events.timed` as ``hetero:<op>``, the JAX plan-log
key. :func:`hetero_block_gspmm` is the relational
block layer: per-edge ``u[src] @ w[rel]`` messages in caller order,
reduced as ``block_gspmm``'s ``e_copy_add_v`` (B4 ``copy_rhs`` on the
card), with JAX's relational block VJP (its docstring says which
backward each route takes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import planner
from . import strategies as S
from .binary_reduce import (_gspmm_ell, _needs_grad, edge_order, gspmm,
                            parse_op, take_rows)
from .blocks import _block_execute, _run_block, check_block_strategy
from .graph import Graph, from_coo
from .planner import get_plan_cache
from ..device import DeviceLike, resolve_device
from ..kernels.common import FEATURE_DTYPES
from ..kernels.spmm.ops import spmm
from ..obs.events import timed as _timed
from ..substrate.nn import einsum

__all__ = ["RelGraph", "from_typed", "from_rels", "caller_coo",
           "hetero_gspmm", "hetero_block_gspmm", "block_expanded_reverse",
           "HETERO_STRATEGIES", "node_strategy", "edge_strategy"]

HETERO_STRATEGIES = ("auto",) + planner.HETERO_STRATEGIES

_HOST_FIELDS = ("rel", "mean_norm", "perm_rel", "rev_perm", "rev_src",
                "rev_dst", "rev_rel")


# --------------------------------------------------------------------- #
# the fused relational structure
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)  # identity hash
class RelGraph:
    """All relations' edges stacked into one relation-tagged graph.

    ``g`` is the fused graph in canonical (dst, src) order. The other
    arrays view the same edge set, on ``g``'s device:

    * ``rel`` (E,) int32 relation id per edge, canonical order;
    * ``mean_norm`` (E,) float32 1/deg_r(dst) per edge, canonical order;
    * ``perm_rel`` (E,) int32 relation-sorted position → canonical slot
      (stable, so each relation's slice stays dst-sorted; slice bounds
      ``rel_ptr``);
    * ``rev_perm`` / ``rev_src`` / ``rev_dst`` / ``rev_rel`` — the edges
      sorted by (src, rel).

    Caller edge order (the order of ``e`` operands) is the order the
    constructor received; ``g.eid`` maps canonical slots back to it.
    ``host`` holds the same arrays as numpy.
    """
    g: Graph
    rel: torch.Tensor
    mean_norm: torch.Tensor
    perm_rel: torch.Tensor
    rev_perm: torch.Tensor
    rev_src: torch.Tensor
    rev_dst: torch.Tensor
    rev_rel: torch.Tensor
    n_rel: int
    rel_sizes: Tuple[int, ...]
    host: Dict[str, np.ndarray]
    _derived: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_src(self) -> int:
        return self.g.n_src

    @property
    def n_dst(self) -> int:
        return self.g.n_dst

    @property
    def n_edges(self) -> int:
        return self.g.n_edges

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def rel_ptr(self) -> Tuple[int, ...]:
        """Per-relation offsets into the relation-sorted view."""
        return tuple(int(x) for x in np.concatenate(
            [[0], np.cumsum(self.rel_sizes, dtype=np.int64)]))

    @property
    def signature(self) -> Tuple[int, int, int, int]:
        """(n_src, n_dst, n_edges, n_rel)."""
        return (self.n_src, self.n_dst, self.n_edges, self.n_rel)

    def long(self, name: str) -> torch.Tensor:
        """int64 copy of index array ``name`` (``"rel"``, ``"perm_rel"``),
        made once: the plain routes' index type."""
        return self._memo(f"long_{name}", lambda: getattr(self, name).long())

    @property
    def mean_norm_caller(self) -> torch.Tensor:
        """(E,) float32 per-relation mean weight in CALLER edge order —
        the weight B1 reads (made once)."""
        return self._memo("mean_norm_caller", lambda: torch.from_numpy(
            self.host["mean_norm"][self.g.host.eid_inv]).to(self.device))

    def expanded(self) -> Graph:
        """The relation-expanded graph the kernel route runs B1 on:
        source ``src·R + rel`` of each edge (n_src·R rows), destinations
        and caller edge order those of ``g``. Built on the host at first
        use and kept."""
        def build():
            src, dst = caller_coo(self.g)
            rel = self.host["rel"][self.g.host.eid_inv].astype(np.int64)
            return from_coo(src * self.n_rel + rel, dst,
                            n_src=self.n_src * self.n_rel,
                            n_dst=self.n_dst, device=self.device)
        return self._memo("expanded", build)

    def rev_segments(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """int64 ``(key, lengths)`` of the reverse table's (src, rel)
        segments: ``key = rev_src·R + rev_rel`` per reverse slot (sorted)
        and the length of each of the n_src·R segments, made once on the
        host — what the gather backward's one sorted reduce reads."""
        def build():
            key = (self.host["rev_src"].astype(np.int64) * self.n_rel
                   + self.host["rev_rel"])
            lengths = np.bincount(key, minlength=self.n_src * self.n_rel)
            return (torch.from_numpy(key).to(self.device),
                    torch.from_numpy(lengths).to(self.device))
        return self._memo("rev_segments", build)

    def _memo(self, key: str, build):
        got = self._derived.get(key)
        if got is None:
            got = self._derived[key] = build()
        return got

    def to(self, device: DeviceLike) -> "RelGraph":
        """The same RelGraph with its tensors on ``device``."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return _from_host(self.g.to(dev), self.host, self.n_rel,
                          self.rel_sizes)

    def __repr__(self):
        return (f"RelGraph(n_src={self.n_src}, n_dst={self.n_dst}, "
                f"n_edges={self.n_edges}, n_rel={self.n_rel}, "
                f"device={self.device})")


def _from_host(g: Graph, host: Dict[str, np.ndarray], n_rel: int,
               rel_sizes: Tuple[int, ...]) -> RelGraph:
    tensors = {k: torch.from_numpy(host[k]).to(g.device)
               for k in _HOST_FIELDS}
    return RelGraph(g=g, n_rel=n_rel, rel_sizes=rel_sizes, host=host,
                    **tensors)


def from_typed(src, dst, rel, *, n_src: int, n_dst: int,
               n_rel: Optional[int] = None,
               device: DeviceLike = "cuda") -> RelGraph:
    """Build a :class:`RelGraph` from one typed COO edge list on the host.

    ``rel[i]`` is the relation id of caller edge ``i``; caller order is
    kept for ``e`` operands."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rel = np.asarray(rel, np.int64)
    if not (src.shape == dst.shape == rel.shape) or src.ndim != 1:
        raise ValueError("src/dst/rel must be equal-length 1-D")
    n_rel = int(n_rel if n_rel is not None
                else (rel.max() + 1 if rel.size else 0))
    if rel.size and (rel.min() < 0 or rel.max() >= n_rel):
        raise ValueError("relation ids out of range")

    g = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device=device)
    h = g.host
    rel_canon = rel[h.eid]
    src_canon = h.src.astype(np.int64)
    dst_canon = h.dst.astype(np.int64)

    # per-(relation, dst) in-degree -> the per-relation mean weight
    if rel.size:
        key = rel_canon * n_dst + dst_canon
        cnt = np.bincount(key, minlength=n_rel * max(n_dst, 1))
        mean_norm = (1.0 / np.maximum(cnt[key], 1)).astype(np.float32)
    else:
        mean_norm = np.zeros(0, np.float32)
    rev_perm = np.lexsort((rel_canon, src_canon)).astype(np.int32)
    host = {"rel": rel_canon.astype(np.int32), "mean_norm": mean_norm,
            "perm_rel": np.argsort(rel_canon, kind="stable").astype(
                np.int32),
            "rev_perm": rev_perm,
            "rev_src": src_canon[rev_perm].astype(np.int32),
            "rev_dst": dst_canon[rev_perm].astype(np.int32),
            "rev_rel": rel_canon[rev_perm].astype(np.int32)}
    rel_sizes = tuple(int(x) for x in np.bincount(rel, minlength=n_rel))
    return _from_host(g, host, n_rel, rel_sizes)


def from_rels(rels: Sequence[Tuple[np.ndarray, np.ndarray]], *, n_src: int,
              n_dst: int, device: DeviceLike = "cuda") -> RelGraph:
    """Build a :class:`RelGraph` from per-relation ``(src, dst)`` pairs.
    Caller edge order is the concatenation order: relation 0's edges,
    then relation 1's, …"""
    srcs = [np.asarray(s, np.int64) for s, _ in rels]
    dsts = [np.asarray(d, np.int64) for _, d in rels]
    empty = [np.zeros(0, np.int64)]
    rel = np.concatenate([np.full(len(s), r, np.int64)
                          for r, s in enumerate(srcs)] or empty)
    return from_typed(np.concatenate(srcs or empty),
                      np.concatenate(dsts or empty), rel, n_src=n_src,
                      n_dst=n_dst, n_rel=len(rels), device=device)


def caller_coo(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Host int64 (src, dst) of a graph in CALLER edge order."""
    h = g.host
    return (h.src[h.eid_inv].astype(np.int64),
            h.dst[h.eid_inv].astype(np.int64))


# --------------------------------------------------------------------- #
# messages and the plain routes
# --------------------------------------------------------------------- #
# Per-edge W indexing materializes an (E, d_in, d_out) stream; beyond this
# many elements the relation-batched pre-transform (H = u @ W for every
# relation, then one (rel, src) gather) is used instead — the JAX
# package's switch, kept so the fused route rounds as JAX's does.
_EDGE_MODE_ELEMS = 2_000_000


def _scale(rg: RelGraph, e: Optional[torch.Tensor],
           reduce: str) -> Optional[torch.Tensor]:
    """Combined per-edge scalar weight in canonical order (or None)."""
    s = None
    if e is not None:
        s = (e[:, 0] if e.ndim == 2 else e).index_select(
            0, rg.g.long("eid"))
    if reduce == "mean":
        s = rg.mean_norm if s is None else s * rg.mean_norm
    return s


def _messages(rg: RelGraph, u, w, basis, coeff, s) -> torch.Tensor:
    """Per-edge relation-indexed messages, canonical order: ``u[src] @
    w[rel]`` (per-edge W indexing for a small stream, else the
    pre-transform and one (rel, src) gather); with ``basis`` / ``coeff``
    one dense basis transform of every node and ``coeff[rel]`` contracted
    per edge; 3-D ``u`` gathered at (src, rel); else ``u[src]``."""
    g = rg.g
    src = g.long("src")
    if u.ndim == 3:
        flat = u.reshape(u.shape[0] * rg.n_rel, u.shape[2])
        msg = take_rows(flat, src * rg.n_rel + rg.long("rel"))
    elif basis is not None:
        hb = einsum("nd,bdo->nbo", u, basis)
        msg = einsum("ebo,eb->eo", take_rows(hb, src),
                     take_rows(coeff, rg.long("rel")))
    elif w is None:
        msg = take_rows(u, src)
    else:
        d_in, d_out = u.shape[1], w.shape[2]
        if g.n_edges * d_in * d_out <= _EDGE_MODE_ELEMS:
            msg = einsum("ed,edo->eo", take_rows(u, src),
                         take_rows(w, rg.long("rel")))
        else:
            H = einsum("nd,rdo->rno", u, w)
            flat = H.reshape(rg.n_rel * u.shape[0], d_out)
            msg = take_rows(flat, rg.long("rel") * u.shape[0] + src)
    if s is not None:
        msg = msg * s[:, None]
    return msg


def _exec_loop(rg: RelGraph, u, w, s, reduce: str,
               inner: str = "segment") -> torch.Tensor:
    """The pre-fusion baseline: one aggregation per relation over the
    relation-sorted slices, combined across relations; ``inner="push"``
    scatter-reduces each relation instead (identity fill kept, so the
    combine stays right on negative extrema)."""
    g = rg.g
    base = "sum" if reduce in ("sum", "mean") else reduce
    ptr = rg.rel_ptr
    perm = rg.long("perm_rel")
    out = None
    for r in range(rg.n_rel):
        lo, hi = ptr[r], ptr[r + 1]
        if hi == lo:
            continue            # empty relation: no call at all
        slots = perm[lo:hi]
        src_r = g.long("src").index_select(0, slots)
        dst_r = g.long("dst").index_select(0, slots)
        if u.ndim == 3:
            msg = take_rows(u[:, r, :], src_r)
        else:
            msg = take_rows(u, src_r)
            if w is not None:
                msg = msg @ w[r]
        if s is not None:
            msg = msg * s.index_select(0, slots)[:, None]
        if base == "sum" and inner != "push":
            part = S.pull_segment(msg, dst_r, g.n_dst, "sum")
        else:
            # without degrees an extremum keeps its ±inf identity on the
            # rows the relation misses, so no zero fill reaches the combine
            part = S.push_scatter(msg, dst_r, g.n_dst, base)
        if out is None:
            out = part
        elif base == "sum":
            out = out + part
        else:
            out = (torch.maximum if base == "max" else torch.minimum)(
                out, part)
    d_out = u.shape[-1] if w is None else w.shape[-1]
    if out is None:
        return torch.zeros((g.n_dst, d_out), dtype=u.dtype, device=u.device)
    if base != "sum":
        out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
        out = S.finalize_empty_rows(out, g.in_degrees, base)
    return out


def _exec_plain(rg: RelGraph, u, w, basis, coeff, e, reduce: str,
                strategy: str) -> torch.Tensor:
    s = _scale(rg, e, reduce)
    if strategy in ("loop", "push"):
        if basis is not None:       # the pre-fusion form materializes W
            w = einsum("rb,bdo->rdo", coeff, basis)
        return _exec_loop(rg, u, w, s, reduce,
                          inner="push" if strategy == "push" else "segment")
    base = "sum" if reduce in ("sum", "mean") else reduce
    msg = _messages(rg, u, w, basis, coeff, s)
    if strategy == "ell":
        return _reduce_ell(rg, msg, base)
    g = rg.g
    return S.pull_segment(msg, g.long("dst"), g.n_dst, base,
                          deg=g.in_degrees)


# --------------------------------------------------------------------- #
# the ell route and its size-skew classes (repro/core/hetero.py:286-425)
# --------------------------------------------------------------------- #
_SKEW_RATIO = 8.0       # max relation size / median — below this, skip
_SKEW_MIN_RELS = 3      # fewer relations: bucketing can't help
_NOT_SKEWED = "not skewed"


def _build_skew_classes(rg: RelGraph):
    """Relations bucketed by ⌊log2(edge count)⌋, built on the host:
    ``((class_graph, canonical_slots), ...)`` — the slots index the fused
    graph's canonical edge order and are the class graph's caller edge
    order, each class graph's ELL pack built — or None when the sizes do
    not warrant a split (skew below the ratio, fewer than 3 non-empty
    relations, or one size class)."""
    sizes = np.asarray(rg.rel_sizes, np.int64)
    nz = sizes[sizes > 0]
    if nz.size < _SKEW_MIN_RELS:
        return None
    med = max(float(np.median(nz)), 1.0)
    if float(nz.max()) / med < _SKEW_RATIO:
        return None
    band = np.where(sizes > 0,
                    np.floor(np.log2(np.maximum(sizes, 1))), -1.0)
    band = band.astype(np.int64)
    distinct = sorted({int(b) for b in band if b >= 0})
    if len(distinct) < 2:
        return None
    h = rg.g.host
    perm = rg.host["perm_rel"]
    ptr = rg.rel_ptr
    classes = []
    for b in distinct:
        slots = np.concatenate([perm[ptr[r]:ptr[r + 1]]
                                for r in range(rg.n_rel) if band[r] == b])
        cg = from_coo(h.src[slots], h.dst[slots], n_src=rg.n_src,
                      n_dst=rg.n_dst, device=rg.device)
        get_plan_cache(cg).ell()        # the class's own pad width
        classes.append((cg, torch.from_numpy(slots.astype(np.int64)).to(
            rg.device)))
    return tuple(classes)


def _skew_classes(rg: RelGraph):
    """The skew classes of ``rg`` (None: use the fused graph's one pack),
    built once and kept on ``rg`` — a None too: not skewed is final."""
    got = rg._derived.get("skew_classes")
    if got is None:
        got = rg._derived["skew_classes"] = (_build_skew_classes(rg)
                                             or _NOT_SKEWED)
    return None if got is _NOT_SKEWED else got


def _reduce_ell(rg: RelGraph, msg: torch.Tensor, base: str) -> torch.Tensor:
    """The canonical-order messages ``msg`` reduced by blocked pulls:
    per skew class when there are classes, else over the fused graph's
    ELL pack (``_gspmm_ell``'s ``e_copy_<base>_v``)."""
    g = rg.g
    spec = parse_op(f"e_copy_{'add' if base == 'sum' else base}_v")
    classes = _skew_classes(rg)
    if classes is not None:
        # a sum's class partials add exactly; an extremum's stay RAW (±inf
        # on a class's empty rows, so no zero fill clobbers another
        # class's negative extremum) and are finalized once, combined
        comb = {"sum": torch.add, "max": torch.maximum,
                "min": torch.minimum}[base]
        out = None
        for cg, slots in classes:
            part = _gspmm_ell(cg, spec, get_plan_cache(cg).ell(),
                              msg.index_select(0, slots), None,
                              raw=base != "sum")
            out = part if out is None else comb(out, part)
        if base == "sum":
            return out
        out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
        return S.finalize_empty_rows(out, g.in_degrees, base)
    # the e operand of the fused graph is in caller order
    return _gspmm_ell(g, spec, get_plan_cache(g).ell(),
                      msg.index_select(0, g.long("eid_inv")), None)


# --------------------------------------------------------------------- #
# the plain fused route's gather backward (repro/core/hetero.py:503-582)
# --------------------------------------------------------------------- #
def _hetero_grads(rg: RelGraph, u, w, basis, coeff, s, ct, needs):
    """Gather-based adjoints of the fused sum: ONE sorted segment reduce
    over the (src, rel)-sorted reverse table, C[s, r] = Σ_{e∈E_r: src=s}
    s_e·ct[dst_e], then dense einsums — ∂u = Σ_r C[·,r] W_rᵀ, ∂W_r = uᵀ
    C[·,r], or with the basis kept factored the same contractions against
    Cb = C·coeff. No scatter. ``needs`` = (∂u, ∂w, ∂basis, ∂coeff)."""
    ct_rev = ct.index_select(0, rg.long("rev_dst"))
    if s is not None:
        ct_rev = ct_rev * s.index_select(0, rg.long("rev_perm"))[:, None]
    n, R = rg.n_src, rg.n_rel
    need_u, need_w, need_b, need_c = needs
    if u.ndim == 2 and w is None and basis is None:
        du = S.pull_segment(ct_rev, rg.long("rev_src"), n, "sum",
                            deg=rg.g.out_degrees)
        return du.to(u.dtype), None, None, None
    key, lengths = rg.rev_segments()
    C = S.pull_segment(ct_rev, key, n * R, "sum", deg=lengths)
    if u.ndim == 3:
        return C.reshape(u.shape).to(u.dtype), None, None, None
    C = C.reshape(n, R, ct.shape[-1])
    du = dw = dbasis = dcoeff = None
    if basis is not None:
        Cb = einsum("nro,rb->nbo", C, coeff)
        if need_u:
            du = einsum("nbo,bdo->nd", Cb, basis).to(u.dtype)
        if need_b:
            dbasis = einsum("nbo,nd->bdo", Cb, u).to(basis.dtype)
        if need_c:
            hb = einsum("nd,bdo->nbo", u, basis)
            dcoeff = einsum("nro,nbo->rb", C, hb).to(coeff.dtype)
        return du, None, dbasis, dcoeff
    if need_u:
        du = einsum("nro,rdo->nd", C, w).to(u.dtype)
    if need_w:
        dw = einsum("nro,nd->rdo", C, u).to(w.dtype)
    return du, dw, None, None


def _hetero_de(rg: RelGraph, u, w, basis, coeff, norm, ct) -> torch.Tensor:
    """∂(e operand): per edge ⟨unscaled message, ct[dst]⟩ (the mean's
    weight folded in, ``e`` not), in caller order."""
    g = rg.g
    base = _messages(rg, u, w, basis, coeff, norm)
    ds = (base * ct.index_select(0, g.long("dst"))).sum(-1)
    return ds.index_select(0, g.long("eid_inv"))


class _HeteroFusedRev(torch.autograd.Function):
    """The fused or ell route's sum / mean (``strategy``) with JAX's
    gather VJP (``_hetero_fused_rev``): :func:`_hetero_grads` for the
    operands, :func:`_hetero_de` for ``e``, whichever message branch the
    forward took."""

    @staticmethod
    def forward(ctx, rg, reduce, strategy, u, w, basis, coeff, e):
        ctx.rg, ctx.reduce = rg, reduce
        ctx.save_for_backward(u, w, basis, coeff, e)
        return _exec_plain(rg, u, w, basis, coeff, e, reduce, strategy)

    @staticmethod
    def backward(ctx, ct):
        u, w, basis, coeff, e = ctx.saved_tensors
        rg, reduce = ctx.rg, ctx.reduce
        needs = ctx.needs_input_grad[3:]
        ct = ct.contiguous()
        grads = _hetero_grads(rg, u, w, basis, coeff,
                              _scale(rg, e, reduce), ct, needs[:4])
        de = None
        if needs[4]:
            norm = rg.mean_norm if reduce == "mean" else None
            de = _hetero_de(rg, u, w, basis, coeff, norm, ct).to(e.dtype)
            de = de.reshape(e.shape)
        return (None, None, None) + grads + (de,)


# --------------------------------------------------------------------- #
# the kernel route (module docstring)
# --------------------------------------------------------------------- #
def _table(rg: RelGraph, u, w, basis, coeff) -> torch.Tensor:
    """(n_src·R, d_out) message table: row ``s·R + r`` is source ``s``'s
    message under relation ``r``."""
    n, R = u.shape[0], rg.n_rel
    if u.ndim == 3:
        return u.reshape(n * R, u.shape[2])
    if basis is not None:           # W kept factored
        hb = einsum("nd,bdo->nbo", u, basis)
        t = einsum("nbo,rb->nro", hb, coeff)
    else:
        t = einsum("nd,rdo->nro", u, w)
    return t.reshape(n * R, t.shape[2])


def _exec_kernel(rg: RelGraph, u, w, basis, coeff, e,
                 reduce: str) -> torch.Tensor:
    """B1 with the caller-order weights over the relation-expanded graph
    (the fused graph itself for a plain ``u[src]`` message)."""
    d_out = int(w.shape[-1] if w is not None
                else basis.shape[-1] if basis is not None else u.shape[-1])
    if rg.n_edges == 0:             # no edge, no launch: JAX's zero rows
        return torch.zeros((rg.n_dst, d_out), dtype=u.dtype, device=u.device)
    s = None
    if e is not None:
        s = e[:, 0] if e.ndim == 2 else e
    if reduce == "mean":
        s = rg.mean_norm_caller if s is None else s * rg.mean_norm_caller
    if u.ndim == 2 and w is None and basis is None:
        g, table = rg.g, u
    else:
        g, table = rg.expanded(), _table(rg, u, w, basis, coeff)
    if s is None:
        return gspmm(g, "u_copy_add_v", u=table, strategy="kernel")
    # the fused route's dtype: the table's promoted with the weights' (a
    # bf16 table with fp32 mean weights gives fp32, as in JAX), where B1
    # writes the table's
    return gspmm(g, "u_mul_e_add_v", u=table, e=s[:, None],
                 strategy="kernel").to(torch.promote_types(table.dtype,
                                                           s.dtype))


def _kernel_ok(*ts: Optional[torch.Tensor]) -> bool:
    """Do the kernel route's operands have a dtype its kernels load (fp32
    or bf16; the weights it builds are passed on in fp32)?"""
    return all(t is None or t.dtype in FEATURE_DTYPES for t in ts)


# --------------------------------------------------------------------- #
# main entry
# --------------------------------------------------------------------- #
def hetero_gspmm(rg: RelGraph, u: torch.Tensor, *,
                 w: Optional[torch.Tensor] = None,
                 basis: Optional[torch.Tensor] = None,
                 coeff: Optional[torch.Tensor] = None,
                 e: Optional[torch.Tensor] = None,
                 reduce: str = "sum",
                 strategy: str = "auto") -> torch.Tensor:
    """Fused heterogeneous aggregation: ``out[v] = ⊕_r Σ_{E_r} msg``.

    Operands (as in the JAX package): ``u`` (n_src, d) or (n_src, n_rel,
    d); ``w`` (n_rel, d_in, d_out) per-relation projection; ``basis`` /
    ``coeff`` (B, d_in, d_out) / (n_rel, B), the R-GCN basis
    decomposition; ``e`` (n_edges,) or (n_edges, 1) per-edge scalar
    weight in caller order. ``reduce``: 'sum' | 'mean' (per-RELATION
    mean, 1/c_{v,r}) | 'max' | 'min'. ``strategy``: module docstring.
    """
    if reduce not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown hetero reducer {reduce!r}")
    if basis is not None or coeff is not None:
        if basis is None or coeff is None:
            raise ValueError("basis and coeff must be given together")
        if w is not None:
            raise ValueError("pass either w or basis/coeff, not both")
    if u.ndim == 3:
        if u.shape[1] != rg.n_rel:
            raise ValueError(f"3-D u must be (n_src, n_rel={rg.n_rel}, d), "
                             f"got {tuple(u.shape)}")
        if w is not None or basis is not None:
            raise ValueError("3-D u is already per-relation; w/basis "
                             "must be None")
    projected = w is not None or basis is not None
    op_name = "u{}{}_{}_v".format("_w" if projected else "",
                                  "_e" if e is not None else "", reduce)
    d_out = int(w.shape[-1] if w is not None
                else basis.shape[-1] if basis is not None else u.shape[-1])
    runner = None
    if planner.get_mode() == "autotune" and strategy == "auto":
        def runner(st):
            with torch.no_grad():
                return _exec(rg, u, w, basis, coeff, e, reduce, st)

    chosen = planner.plan_hetero(
        rg.signature, op_name, d_out, requested=strategy,
        stats=get_plan_cache(rg.g).stats, runner=runner,
        device=planner.device_of(u),
        kernel_ok=(reduce in ("sum", "mean")
                   and _kernel_ok(u, w, basis, coeff, e)))
    return _timed(f"hetero:{op_name}", lambda: _exec(
        rg, u, w, basis, coeff, e, reduce, chosen))


def _exec(rg: RelGraph, u, w, basis, coeff, e, reduce: str,
          chosen: str) -> torch.Tensor:
    """Run one relational aggregation with a planned route."""
    if chosen == "kernel":
        return _exec_kernel(rg, u, w, basis, coeff, e, reduce)
    if (chosen in ("fused", "ell") and reduce in ("sum", "mean")
            and _needs_grad(u, w, basis, coeff, e)):
        return _HeteroFusedRev.apply(rg, reduce, chosen, u, w, basis, coeff,
                                     e)
    return _exec_plain(rg, u, w, basis, coeff, e, reduce, chosen)


# --------------------------------------------------------------------- #
# relational blocks (sampled R-GCN)
# --------------------------------------------------------------------- #
_BLOCK_SPEC = parse_op("e_copy_add_v")


def hetero_block_gspmm(bg, rel: torch.Tensor, u: torch.Tensor,
                       w: torch.Tensor, *,
                       norm: Optional[torch.Tensor] = None,
                       strategy: str = "auto",
                       bwd_strategy: str = "auto") -> torch.Tensor:
    """Fused relational aggregation over one sampled block.

    ``rel`` (n_edges_pad,) is the relation id per edge and ``norm`` the
    per-(dst, relation) mean weight, both in caller edge order (the
    relational sampler emits them; pad edges carry norm 0 and point at
    the dummy row). Messages ``u[src] @ w[rel]`` (:func:`_block_messages`)
    are reduced as ``block_gspmm(bg, "e_copy_add_v", e=msg)`` reduces
    them — B4 ``copy_rhs`` on the card — under ``strategy``. Returns
    (n_dst_real, d_out).

    The backward is planned by ``planner.plan_block_vjp`` (gather
    available when the block has its Gᵀ, as in JAX):

    * ``"gather"`` — :class:`_HeteroBlockGather`, JAX's
      ``_hetero_block_rev``. After a kernel forward: B1 over the block's
      relation-expanded Gᵀ (:func:`block_expanded_reverse`) gives
      C[s, r] = Σ_{e: src=s, rel=r} norm_e·ct[dst_e], then ∂u = Σ_r
      C[·,r]·w_rᵀ and ∂w_r = uᵀ·C[·,r] are two einsums — JAX's
      ``_hetero_grads`` on a block, with no per-edge (d_in, d_out) outer
      product and no atomics. After a plain forward: ∂u a sorted pull
      over the block's reverse table, ∂w a per-relation sorted sum of
      the per-edge outer products (:func:`_block_rev_grads`).
    * ``"scatter"`` — autograd of the messages, the reduce through
      ``block_gspmm``'s own VJP.
    """
    check_block_strategy(strategy)
    d_out, device = int(w.shape[-1]), planner.device_of(u)
    chosen = planner.plan_block_gspmm(
        bg.signature, _BLOCK_SPEC, d_out, requested=strategy, dtype=u.dtype,
        device=device, kernel_ok=_kernel_ok(u, w, norm))
    bwd = planner.plan_block_vjp(
        bg.signature, _BLOCK_SPEC, d_out, requested=bwd_strategy,
        gather_available=bg.has_reverse, dtype=u.dtype, device=device,
        kernel_forward=chosen == "kernel")
    if bwd == "gather" and _needs_grad(u, w):
        return _timed(f"block:{_BLOCK_SPEC.name}", lambda:
                      _HeteroBlockGather.apply(bg, chosen, rel, norm, u, w))
    msg = _block_messages(bg, rel, u, w, norm)
    return _run_block(bg, _BLOCK_SPEC, chosen, bwd, msg, None)


def _block_messages(bg, rel, u, w, norm) -> torch.Tensor:
    """Per-edge relation-projected messages in CALLER edge order, by
    per-edge W indexing (blocks are small by construction), as in JAX."""
    msg = einsum("ed,edo->eo", take_rows(u, bg.g.src_caller.long()),
                 take_rows(w, rel.long()))
    if norm is not None:
        msg = msg * norm[:, None]
    return msg


def block_expanded_reverse(bg, rel: torch.Tensor, n_rel: int,
                           draw=None) -> Graph:
    """The block's relation-expanded Gᵀ: one edge per block edge, from its
    destination slot to row ``src·R + rel`` (n_src_pad·R rows, the
    n_dst_real + 1 destination slots as columns), caller edge order
    kept. B1 over it with the weight ``norm`` gives the gather backward's
    C[s, r]; pad edges leave the dummy destination row, whose cotangent
    is zero. Kept on ``bg.g`` for this ``rel`` and ``n_rel``. ``draw`` =
    the host ``(src, dst, rel)`` caller-order arrays of the sampler's
    draw, which it builds from; without them the arrays come from
    ``bg.g.host`` and ``rel`` (a device read, once)."""
    got = bg.g._derived.get(("rel_reverse", n_rel))
    if got is not None and got[0] is rel:
        return got[1]
    if draw is None:
        src, dst = caller_coo(bg.g)
        rel_h = rel.cpu().numpy()
    else:
        src, dst, rel_h = draw
    gx = from_coo(np.asarray(dst, np.int64),
                  np.asarray(src, np.int64) * n_rel + np.asarray(rel_h,
                                                                 np.int64),
                  n_src=bg.g.n_dst, n_dst=bg.g.n_src * n_rel,
                  device=bg.g.device)
    bg.g._derived[("rel_reverse", n_rel)] = (rel, gx)
    return gx


def _block_table_grads(bg, rel, norm, u, w, ct_pad, needs):
    """(∂u, ∂w) after a kernel forward: C by B1 over the block's
    relation-expanded Gᵀ, then two einsums."""
    n, R, d_out = bg.g.n_src, w.shape[0], w.shape[-1]
    gx = block_expanded_reverse(bg, rel, R)
    C = spmm(gx, ct_pad, "sum", weight=norm).reshape(n, R, d_out)
    du = einsum("nro,rdo->nd", C, w) if needs[0] else None
    dw = einsum("nro,nd->rdo", C, u) if needs[1] else None
    return du, dw


def _block_rev_grads(bg, rel, norm, u, w, ct_pad, needs):
    """(∂u, ∂w) after a plain forward, as JAX's ``_hetero_block_rev_bwd``:
    ∂u a sorted pull over the src-sorted reverse table; ∂w the per-edge
    outer products u[src]⊗(norm·ct[dst]) summed per relation, sorted by
    relation first (JAX's ``segment_sum`` over ``rel`` is unsorted)."""
    g = bg.g
    du = dw = None
    if needs[0]:
        src, dst, eid = edge_order(g, "srcsort")
        ct_rev = ct_pad.index_select(0, dst)
        if norm is not None:
            ct_rev = ct_rev * norm.index_select(0, eid)[:, None]
        w_rev = w.index_select(0, rel.long().index_select(0, eid))
        du = S.pull_segment(einsum("eo,edo->ed", ct_rev, w_rev), src,
                            g.n_src, "sum", deg=g.out_degrees)
    if needs[1]:
        ct_e = ct_pad.index_select(0, g.dst_caller.long())
        if norm is not None:
            ct_e = ct_e * norm[:, None]
        outer = einsum("ed,eo->edo",
                       u.index_select(0, g.src_caller.long()), ct_e)
        rel_l = rel.long()
        order = torch.argsort(rel_l, stable=True)
        dw = S.pull_segment(outer.index_select(0, order),
                            rel_l.index_select(0, order), w.shape[0], "sum")
    return du, dw


class _HeteroBlockGather(torch.autograd.Function):
    """:func:`hetero_block_gspmm` with the gather backward (its
    docstring), timed as ``block_bwd:e_copy_add_v``. ``rel`` and
    ``norm`` are the sampler's: no gradient flows to them, as in JAX."""

    @staticmethod
    def forward(ctx, bg, chosen, rel, norm, u, w):
        ctx.bg, ctx.chosen = bg, chosen
        ctx.save_for_backward(rel, norm, u, w)
        msg = _block_messages(bg, rel, u.detach(), w.detach(), norm)
        return _block_execute(bg, _BLOCK_SPEC, msg, None, chosen)

    @staticmethod
    def backward(ctx, ct):
        rel, norm, u, w = ctx.saved_tensors
        bg, needs = ctx.bg, ctx.needs_input_grad[4:]
        grads_fn = (_block_table_grads if ctx.chosen == "kernel"
                    else _block_rev_grads)

        def grads():
            # the dummy destination row's cotangent is zero: pad edges,
            # and only they, read it
            ct_pad = torch.cat([ct, ct.new_zeros((1,) + tuple(ct.shape[1:]))])
            return grads_fn(bg, rel, norm, u.detach(), w.detach(),
                            ct_pad.contiguous(), needs)

        du, dw = _timed(f"block_bwd:{_BLOCK_SPEC.name}", grads)
        return None, None, None, None, du, dw


# --------------------------------------------------------------------- #
# the strategies an app's non-relational ops run under a hetero strategy
# --------------------------------------------------------------------- #
def node_strategy(strategy: str) -> str:
    """The ``gspmm`` strategy a relational app's plain-graph aggregation
    runs under hetero ``strategy``: ``auto`` / ``kernel`` as they are,
    every plain route on ``segment``, so a plain forward launches no
    kernel."""
    return strategy if strategy in ("auto", "kernel") else "segment"


def edge_strategy(strategy: str) -> str:
    """The ``gsddmm`` strategy of an app's edge op under hetero
    ``strategy``: ``auto`` / ``kernel`` as they are, else the plain
    ``canonical`` version."""
    return strategy if strategy in ("auto", "kernel") else "canonical"
