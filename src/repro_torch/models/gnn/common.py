"""Shared GNN plumbing (port of ``repro/models/gnn/common.py``): the
graph bundle with its per-edge normalizations, which serving and
training share (a kernel route's backward builds Gᵀ itself, once per
graph: ``core/graph.reverse``), its graph's pack cache and, when asked
for, the blocked packs and the ELL training graph, and MoNet's
K-relation :class:`~repro_torch.core.hetero.RelGraph`; the
loaders that carry parameters between the JAX package and the port
(:func:`from_jax_params`, :func:`to_jax_params`); the one code path
every app's sampled-minibatch forward runs on (:func:`run_blocks`); and
the partitioned bundle (:class:`PartitionedBundle`): the graph's memoized
partition with the normalizations in its bucket layout, on one device (the
emulated ring) or as one rank's view of a process group (the mesh ring).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.graph import Graph
from ...core.hetero import RelGraph, caller_coo, from_rels
from ...core.partition import (PartitionedGraph, ring_gspmm,
                               ring_gspmm_delayed)
from ...core.planner import PlanCache, get_plan_cache
from ...core.tiling import ELLPack, TilePack
from ...core.training_ops import TrainingGraph, make_training_graph
from ...core.transport import process_group, rank_of
from ...device import DeviceLike, resolve_device
from ...obs.spans import span
from ...substrate.nn import dropout

__all__ = ["GraphBundle", "edge_norms", "make_bundle", "from_jax_params",
           "to_jax_params", "pad_features", "block_features", "run_blocks",
           "PartitionedBundle", "make_partitioned_bundle",
           "shard_partitioned", "partitioned_aggregate"]


@dataclasses.dataclass(frozen=True, eq=False)
class GraphBundle:
    """Graph + precomputed per-edge normalization weights, both on the
    graph's device, in CALLER edge order.

    ``gcn_norm``: 1/sqrt(deg_out(u)·deg_in(v)); ``mean_norm``:
    1/deg_in(v) — mean aggregation as a weighted Copy-Reduce. ``krels``:
    the K-relation RelGraphs :func:`make_bundle` built, by K. ``cache``:
    the graph's :class:`~repro_torch.core.planner.PlanCache`; ``tg`` the
    ELL training graph (packs of G and Gᵀ) when :func:`make_bundle` built
    one, which GCN and SAGE pull through under ``strategy="ell"``.
    """
    g: Graph
    gcn_norm: torch.Tensor   # (n_edges,)
    mean_norm: torch.Tensor  # (n_edges,)
    krels: Dict[int, RelGraph] = dataclasses.field(default_factory=dict)
    cache: Optional[PlanCache] = None
    tg: Optional[TrainingGraph] = None

    # views onto the cache (never build)
    @property
    def ell(self) -> Optional[ELLPack]:
        return None if self.cache is None else self.cache.peek("ell")

    @property
    def tiles(self) -> Optional[TilePack]:
        return None if self.cache is None else self.cache.peek("tiles")

    def use_training_graph(self, strategy: str, d: int) -> bool:
        """Route the weighted aggregation through the ELL pull, forward
        and backward (``core/training_ops.weighted_copy_reduce``)? When
        ``ell`` is pinned and the bundle has its training graph; under
        ``auto`` when the cost model, on the graph's device row, ranks
        the ELL pull at width ``d`` above every route auto would take
        otherwise (``PlanCache.prefers_ell``, JAX's test) — the bundle
        then builds its training graph, on the host, once."""
        if strategy == "ell":
            return self.tg is not None
        cache = self.cache or get_plan_cache(self.g)
        if strategy != "auto" or not cache.prefers_ell(
                d, "cuda" if self.g.device.type == "cuda" else "cpu"):
            return False
        if self.tg is None:
            object.__setattr__(self, "tg",
                               make_training_graph(self.g, cache.ell_cap))
        return True

    def krel(self, n_rel: int) -> Optional[RelGraph]:
        """The K-relation RelGraph of ``g`` (the edge set once per
        relation, MoNet's per-kernel aggregation) that :func:`make_bundle`
        built for ``krel=n_rel``, or None — the JAX ``PlanCache.krel``
        inside a jitted step, which only a prebuilt one reaches."""
        return self.krels.get(int(n_rel))


def edge_norms(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge (gcn, mean) normalization weights in caller edge order,
    degrees clamped ≥ 1, computed on the host in float64 and stored as
    float32 — the same numbers as the JAX package's ``edge_norms``."""
    deg_in = np.maximum(g.host.in_degrees.astype(np.float64), 1)
    deg_out = np.maximum(g.host.out_degrees.astype(np.float64), 1)
    src, dst = g.host.src, g.host.dst
    w = 1.0 / np.sqrt(deg_out[src] * deg_in[dst])
    mean_w = 1.0 / deg_in[dst]
    w_caller = np.zeros_like(w)
    w_caller[g.host.eid] = w
    m_caller = np.zeros_like(mean_w)
    m_caller[g.host.eid] = mean_w
    return w_caller.astype(np.float32), m_caller.astype(np.float32)


def make_bundle(g: Graph, *, ell: bool = False, tiles: bool = False,
                ell_width: int = 64, training: bool = False,
                krel: Optional[int] = None) -> GraphBundle:
    """Assemble a bundle on ``g``'s device. The packs come from (and stay
    in) the graph's PlanCache, built at most once per graph even across
    bundles and direct ``gspmm`` calls: ``ell`` builds the ELL pack at
    width cap ``ell_width``, ``tiles`` the default TilePack, ``training``
    the ELL training graph (Gᵀ and both packs). The JAX bundle builds the
    ELL pack and the training graph by default; the port's builds them
    only when asked, or when ``"auto"`` picks the ELL pull. ``krel=K``
    also builds the K-relation RelGraph (:meth:`GraphBundle.krel`), on the
    host, once. Span ``gnn.make_bundle``."""
    with span("gnn.make_bundle", args={"n_edges": g.n_edges}):
        w_caller, m_caller = edge_norms(g)
        cache = get_plan_cache(g)
        cache.set_ell_cap(ell_width)
        if ell or training:
            cache.ell()
        if tiles:
            cache.tiles()
        tg = make_training_graph(g, ell_width) if training else None
        krels = {}
        if krel is not None:
            src, dst = caller_coo(g)
            krels[int(krel)] = from_rels([(src, dst)] * int(krel),
                                         n_src=g.n_src, n_dst=g.n_dst,
                                         device=g.device)
        return GraphBundle(
            g=g, gcn_norm=torch.from_numpy(w_caller).to(g.device),
            mean_norm=torch.from_numpy(m_caller).to(g.device), krels=krels,
            cache=cache, tg=tg)


# --------------------------------------------------------------------- #
# partitioned (ring) execution bundle (repro/models/gnn/common.py:115-180)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class PartitionedBundle:
    """Partition plan + pre-bucketed normalization weights.

    ``pg`` is the graph's memoized partition (``PlanCache.partition``, so
    one partition — and its stage graphs — serves direct ``gspmm`` calls
    and every trainer); ``gcn_w`` / ``mean_w`` are the bundle's
    normalizations in the (S, S, eb) bucket layout, 0 on pad slots.
    ``mesh`` None: the emulated ring. ``mesh`` a process group: the
    calling rank's view — ``pg`` whole (every rank plans the same
    partition on the host), ``gcn_w`` / ``mean_w`` the rank's
    destination row (1, S, eb)."""
    pg: PartitionedGraph
    gcn_w: torch.Tensor       # (S, S, eb) 1/sqrt(d_u d_v)
    mean_w: torch.Tensor      # (S, S, eb) 1/deg_in(dst)
    mesh: Optional[object] = None
    axis: str = "data"

    def dropout(self, gen: Optional[torch.Generator], h: torch.Tensor,
                rate: float, train: bool) -> torch.Tensor:
        """``substrate.nn.dropout`` of padded node rows ``h``: on the mesh
        the rank draws the whole padded layout's mask from ``gen`` and
        keeps its own rows, so a run drops what the emulated run drops."""
        if self.mesh is None or not train or rate <= 0.0:
            return dropout(gen, h, rate, train)
        keep = 1.0 - rate
        me, rows = rank_of(self.mesh), self.pg.rows
        mask = torch.rand((self.pg.n_pad,) + tuple(h.shape[1:]),
                          generator=gen, device=h.device)[
            me * rows:(me + 1) * rows] < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                       device=h.device))


def make_partitioned_bundle(g: Graph, n_shards: int, *, mesh=None,
                            axis: str = "data",
                            mode: str = "contiguous") -> PartitionedBundle:
    """The partitioned bundle of ``g`` on its device: the partition from
    (and memoized in) the graph's PlanCache, the per-edge norms of
    :func:`edge_norms` bucketed once; with a process group ``mesh`` (of
    ``n_shards`` ranks), the calling rank's view of it."""
    group = process_group(mesh)
    pg = get_plan_cache(g).partition(n_shards, mode)
    w_caller, m_caller = edge_norms(g)
    gcn_w, mean_w = (pg.scatter_edges(torch.from_numpy(w).to(g.device))
                     for w in (w_caller, m_caller))
    if group is not None:
        me = rank_of(group)
        gcn_w, mean_w = gcn_w[me:me + 1], mean_w[me:me + 1]
    return PartitionedBundle(pg=pg, gcn_w=gcn_w, mean_w=mean_w, mesh=group,
                             axis=axis)


def shard_partitioned(pb: PartitionedBundle, *arrays):
    """The bundle and the calling rank's slices of ``arrays`` (JAX's
    ``device_put`` onto the mesh): a padded node array (n_pad, …) gives
    the rank's (rows, …) rows, a bucket array (S, S, eb, …) its
    destination row (1, S, eb, …), anything else (small maps, None) is
    kept whole. The bundle is already the rank's view
    (:func:`make_partitioned_bundle`). A no-op without a process group."""
    if pb.mesh is None:
        return (pb,) + arrays if arrays else pb
    pg = pb.pg
    me = rank_of(pb.mesh)

    def shard(a):
        if isinstance(a, torch.Tensor) and a.ndim >= 1:
            if a.shape[0] == pg.n_pad:
                return a[me * pg.rows:(me + 1) * pg.rows]
            if a.shape[0] == pg.n_shards:
                return a[me:me + 1]
        return a

    return (pb,) + tuple(shard(a) for a in arrays) if arrays else pb


def partitioned_aggregate(pb: PartitionedBundle, h: torch.Tensor, w,
                          i: int, halo, refresh: bool, comm_state,
                          strategy: str):
    """Layer ``i``'s ring aggregation of ``h`` with bucketed weight ``w``
    (GCN's and SAGE's): exact, delayed (``halo``), int8
    (``comm_state``) or both. Returns ``(out, stale, residual)``, the
    last two None where unused."""
    kw = dict(mesh=pb.mesh, axis=pb.axis, strategy=strategy)
    if comm_state is not None:
        kw.update(comm="int8", residual=comm_state[i])
    if halo is None:
        out = ring_gspmm(pb.pg, h, w, **kw)
        return (out, None, None) if comm_state is None else (
            out[0], None, out[1])
    out = ring_gspmm_delayed(pb.pg, h, w, halo[i], refresh, **kw)
    return out if comm_state is not None else out + (None,)


def from_jax_params(app: str, tree, device: DeviceLike = "cuda") -> nn.Module:
    """The port's model for ``app`` ('gcn' | 'sage' | 'gat' | 'rgcn' |
    'gcmc' | 'monet' | 'lgnn') holding the JAX params pytree ``tree``
    (leaves as numpy arrays), computing the same function as the JAX
    model with those params. LGNN's BatchNorm running statistics become
    buffers."""
    from . import gat, gcmc, gcn, lgnn, monet, rgcn, sage

    mods = {"gcn": gcn.GCN, "sage": sage.SAGE, "gat": gat.GAT,
            "rgcn": rgcn.RGCN, "gcmc": gcmc.GCMC, "monet": monet.MoNet,
            "lgnn": lgnn.LGNN}
    if app not in mods:
        raise ValueError(f"unknown app {app!r}; expected one of "
                         f"{tuple(mods)}")
    return mods[app].from_numpy(tree, device)


def to_jax_params(model: nn.Module, grads: bool = False) -> Dict:
    """The inverse of :func:`from_jax_params`: the JAX params pytree of
    ``model`` — its parameters and buffers (LGNN's running statistics) as
    numpy arrays, nested by their dotted names (a numeric name is a list
    index: ``layers.0.w`` → ``{"layers": [{"w": ...}]}``) — or, with
    ``grads``, the parameters' ``.grad``, so a test can hold the port's
    gradients against ``jax.grad`` leaf by leaf."""
    leaves = [(n, p.grad if grads else p)
              for n, p in model.named_parameters()]
    if not grads:
        leaves += list(model.named_buffers())
    tree: Dict = {}
    for name, t in leaves:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return _listify(tree)


def _listify(node):
    """Dicts keyed "0", "1", … become lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


# --------------------------------------------------------------------- #
# sampled-minibatch (block) forward — one code path for every app
# --------------------------------------------------------------------- #
def pad_features(feats, device: DeviceLike = "cuda") -> torch.Tensor:
    """(n + 1, d) float32 features on ``device``: one zero row appended,
    so global id -1 (pad) gathers zeros."""
    feats = np.asarray(feats, np.float32)
    return torch.from_numpy(np.vstack([
        feats, np.zeros((1, feats.shape[1]), np.float32)])).to(
            resolve_device(device))


def block_features(feats_padded: torch.Tensor, ids) -> torch.Tensor:
    """Gather input features for padded global ids (-1 → the zero row)."""
    ids = torch.as_tensor(ids, device=feats_padded.device).long()
    safe = torch.where(ids >= 0, ids, feats_padded.shape[0] - 1)
    return feats_padded.index_select(0, safe)


def run_blocks(block_layer: Callable, layers: Sequence, blocks: Sequence,
               h: torch.Tensor, *, strategy: str = "auto",
               bwd_strategy: str = "auto",
               activation: Callable = torch.relu, train: bool = False,
               gen: Optional[torch.Generator] = None,
               drop: float = 0.0) -> torch.Tensor:
    """Drive a per-app layer function over a minibatch's blocks.

    ``block_layer(lyr, blk, h, strategy=..., bwd_strategy=...)`` maps the
    layer-l frontier features ``h`` (n_src_pad, d) to destination features
    (n_dst_real, d'). With the sampler's dst-first source numbering the
    next block's frontier IS this block's destination set, so the loop
    chains layers; the last block's destinations are the seeds, so the
    result is (batch_size, d_out). ``bwd_strategy`` (the block VJP,
    ``core/blocks.py``) goes to every ``block_gspmm``. With ``train``, a
    generator ``gen`` on the features' device and ``drop`` > 0, each
    layer's input is dropped out first, as in the full-graph forwards.
    """
    if len(layers) != len(blocks):
        raise ValueError(f"{len(layers)} layers but {len(blocks)} blocks: "
                         f"sampler fanouts must match model depth")
    for i, (lyr, blk) in enumerate(zip(layers, blocks)):
        if train and gen is not None and drop > 0.0:
            h = dropout(gen, h, drop, train)
        h = block_layer(lyr, blk, h, strategy=strategy,
                        bwd_strategy=bwd_strategy)
        if i < len(layers) - 1:
            h = activation(h)
    return h
