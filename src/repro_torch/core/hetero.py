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
  view, the pre-fusion baseline (``"segment"``, a plain gspmm name, pins
  it, as in JAX).
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
  for an e operand. Max and min raise: they stay on ``"fused"``.
* ``"auto"`` — the kernel for a float32 CUDA operand with a sum or mean,
  ``"fused"`` otherwise (no ``plan_hetero`` cost model yet).

``"ell"``, ``"push"`` and the skew-class packs raise
``NotImplementedError`` (ROADMAP A9, with ``plan_hetero``).

The kernel route's table, and its memory: a (n_src·R, d_out) fp32 tensor.
The ``w`` form is one relation-batched product ``einsum(u, W)``. The basis
form keeps ``W`` factored, as the JAX fused route does: ``hb = u @ basis``
(n·B·d·o multiply-adds), then ``hb`` contracted with ``coeff`` (n·R·B·o),
against n·R·d·o for composing ``W_r = coeff @ basis`` first. At the
100-relation shape of ``benchmarks/fig_hetero.py`` (n 4000, R 100, d 32
→ 16, B 4) that is 8.2M + 25.6M multiply-adds against 204.8M, and the
table holds 4000·100·16 floats = 25.6 MB (``hb`` 1.0 MB); 3-D ``u`` is
its own table, reshaped without a copy.

Plain routes differentiate by autograd. Eager calls are timed through
:func:`repro_torch.obs.events.timed` as ``hetero:<op>``, the JAX plan-log
key. :func:`hetero_block_gspmm` is the relational block layer: per-edge
``u[src] @ w[rel]`` messages in caller order, reduced by ``block_gspmm``'s
``e_copy_add_v`` (B4 ``copy_rhs`` on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import strategies as S
from .binary_reduce import gspmm
from .blocks import block_gspmm
from .graph import Graph, from_coo
from ..device import DeviceLike, resolve_device
from ..obs.events import timed as _timed

__all__ = ["RelGraph", "from_typed", "from_rels", "caller_coo",
           "hetero_gspmm", "hetero_block_gspmm", "HETERO_STRATEGIES",
           "node_strategy", "edge_strategy"]

HETERO_STRATEGIES = ("auto", "fused", "loop", "kernel")
_QUEUED = ("ROADMAP A9 (plan_hetero with hetero's ell / push / skew-class "
           "routes)")

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
        msg = flat.index_select(0, src * rg.n_rel + rg.long("rel"))
    elif basis is not None:
        hb = torch.einsum("nd,bdo->nbo", u, basis)
        msg = torch.einsum("ebo,eb->eo", hb.index_select(0, src),
                           coeff.index_select(0, rg.long("rel")))
    elif w is None:
        msg = u.index_select(0, src)
    else:
        d_in, d_out = u.shape[1], w.shape[2]
        if g.n_edges * d_in * d_out <= _EDGE_MODE_ELEMS:
            msg = torch.einsum("ed,edo->eo", u.index_select(0, src),
                               w.index_select(0, rg.long("rel")))
        else:
            H = torch.einsum("nd,rdo->rno", u, w)
            flat = H.reshape(rg.n_rel * u.shape[0], d_out)
            msg = flat.index_select(0, rg.long("rel") * u.shape[0] + src)
    if s is not None:
        msg = msg * s[:, None]
    return msg


def _raw_extremum(msg: torch.Tensor, tgt: torch.Tensor, n_tgt: int,
                  base: str) -> torch.Tensor:
    """Segment max / min keeping the ±inf identity on empty rows, so a
    combine across relations never meets a zero fill."""
    out = torch.full((n_tgt,) + tuple(msg.shape[1:]),
                     S.REDUCE_IDENTITY[base], dtype=msg.dtype,
                     device=msg.device)
    idx = tgt.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
    return out.scatter_reduce(0, idx, msg, "amax" if base == "max"
                              else "amin", include_self=True)


def _exec_loop(rg: RelGraph, u, w, s, reduce: str) -> torch.Tensor:
    """The pre-fusion baseline: one aggregation per relation over the
    relation-sorted slices, combined across relations."""
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
            msg = u[:, r, :].index_select(0, src_r)
        else:
            msg = u.index_select(0, src_r)
            if w is not None:
                msg = msg @ w[r]
        if s is not None:
            msg = msg * s.index_select(0, slots)[:, None]
        if base == "sum":
            part = S.pull_segment(msg, dst_r, g.n_dst, "sum")
        else:
            part = _raw_extremum(msg, dst_r, g.n_dst, base)
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
    if strategy == "loop":
        if basis is not None:       # the pre-fusion form materializes W
            w = torch.einsum("rb,bdo->rdo", coeff, basis)
        return _exec_loop(rg, u, w, s, reduce)
    base = "sum" if reduce in ("sum", "mean") else reduce
    g = rg.g
    return S.pull_segment(_messages(rg, u, w, basis, coeff, s),
                          g.long("dst"), g.n_dst, base, deg=g.in_degrees)


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
        hb = torch.einsum("nd,bdo->nbo", u, basis)
        t = torch.einsum("nbo,rb->nro", hb, coeff)
    else:
        t = torch.einsum("nd,rdo->nro", u, w)
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
    return gspmm(g, "u_mul_e_add_v", u=table, e=s[:, None],
                 strategy="kernel")


def _kernel_ok(*ts: Optional[torch.Tensor]) -> bool:
    return all(t is None or (t.device.type == "cuda"
                             and t.dtype == torch.float32) for t in ts)


def _resolve(strategy: str, reduce: str, operands) -> str:
    if strategy == "auto":
        return ("kernel" if reduce in ("sum", "mean") and _kernel_ok(
            *operands) else "fused")
    if strategy == "segment":       # a plain gspmm name pins the loop
        return "loop"
    if strategy in ("ell", "push"):
        raise NotImplementedError(
            f"hetero strategy {strategy!r} is not ported yet: {_QUEUED}")
    if strategy not in HETERO_STRATEGIES:
        raise ValueError(f"unknown hetero strategy {strategy!r}; expected "
                         f"one of {HETERO_STRATEGIES + ('segment',)}")
    if strategy == "kernel" and reduce not in ("sum", "mean"):
        raise NotImplementedError(
            f"the hetero kernel route (B1) reduces by sum or mean only; "
            f"{reduce!r} stays on strategy='fused'")
    return strategy


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
    chosen = _resolve(strategy, reduce, (u, w, basis, coeff, e))
    projected = w is not None or basis is not None
    op_name = "u{}{}_{}_v".format("_w" if projected else "",
                                  "_e" if e is not None else "", reduce)
    if chosen == "kernel":
        return _timed(f"hetero:{op_name}", lambda: _exec_kernel(
            rg, u, w, basis, coeff, e, reduce))
    return _timed(f"hetero:{op_name}", lambda: _exec_plain(
        rg, u, w, basis, coeff, e, reduce, chosen))


# --------------------------------------------------------------------- #
# relational blocks (sampled R-GCN)
# --------------------------------------------------------------------- #
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
    are reduced by ``block_gspmm(bg, "e_copy_add_v", e=msg)`` — B4
    ``copy_rhs`` on the card — under ``strategy`` / ``bwd_strategy``.
    Returns (n_dst_real, d_out).
    """
    msg = _block_messages(bg, rel, u, w, norm)
    return block_gspmm(bg, "e_copy_add_v", e=msg, strategy=strategy,
                       bwd_strategy=bwd_strategy)


def _block_messages(bg, rel, u, w, norm) -> torch.Tensor:
    """Per-edge relation-projected messages in CALLER edge order, by
    per-edge W indexing (blocks are small by construction), as in JAX."""
    msg = torch.einsum("ed,edo->eo",
                       u.index_select(0, bg.g.src_caller.long()),
                       w.index_select(0, rel.long()))
    if norm is not None:
        msg = msg * norm[:, None]
    return msg


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
