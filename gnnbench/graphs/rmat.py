"""One plain R-MAT graph (``data/graph.rmat_edges``) with the node data
and Glorot weights of ``data/graph``. The port gets the caller-order COO
on the host (its ``from_coo`` entry takes host arrays), builds G, Gᵀ
(``reverse``, which the first backward would otherwise build) and the
model's bundle; the reference gets the same COO on the device."""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from gnnbench.data.graph import glorot_leaves, node_data, rmat_edges

__all__ = ["n_edges", "make_inputs", "build", "reference_inputs"]


def n_edges(cfg: Dict) -> int:
    """Edges of the configuration's graph, self-loops included."""
    return cfg["edges"] + cfg["nodes"] * bool(cfg["self_loops"])


def make_inputs(ctx) -> Dict:
    """The graph's host COO, the node data and the weights of ``ctx``'s
    cell from its seed."""
    from gnnbench.inputs import reference_module

    cfg, dev = ctx.config, ctx.device
    src, dst = rmat_edges(cfg["nodes"], cfg["edges"], ctx.seed, dev,
                          a=cfg["rmat_a"], b=cfg["rmat_b"], c=cfg["rmat_c"],
                          self_loops=cfg["self_loops"])
    out = {"src": src.cpu().numpy(), "dst": dst.cpu().numpy()}
    del src, dst
    out.update(node_data(cfg["nodes"], cfg["features"], cfg["classes"],
                         cfg["train_nodes"], ctx.seed, dev))
    out["leaves"] = glorot_leaves(reference_module(ctx).leaf_shapes(cfg),
                                  ctx.seed, dev)
    return out


def build(ctx, inp: Dict):
    """G, Gᵀ and the bundle the port's step takes, each timed."""
    from repro_torch.core.graph import from_coo, reverse
    from repro_torch.models.gnn.common import make_bundle

    n = ctx.config["nodes"]
    parts = {}
    t = time.perf_counter()
    g = from_coo(inp["src"], inp["dst"], n_src=n, n_dst=n, device=ctx.device)
    ctx.sync()
    parts["G"] = time.perf_counter() - t
    t = time.perf_counter()
    reverse(g)
    ctx.sync()
    parts["G_T"] = time.perf_counter() - t
    t = time.perf_counter()
    bundle = make_bundle(g)
    ctx.sync()
    parts["make_bundle"] = time.perf_counter() - t
    ctx.info["graph_build_s"] = parts
    ctx.log(f"largest in-degree {int(g.host.in_degrees.max())}")
    return bundle


def reference_inputs(inp: Dict, device, mask: Optional[torch.Tensor] = None
                     ) -> Dict:
    from gnnbench.reference.common import ref_graph
    n = int(inp["labels"].shape[0])
    g = ref_graph(torch.from_numpy(inp["src"]).to(device),
                  torch.from_numpy(inp["dst"]).to(device), n)
    x = inp["x"]
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x).to(device)
    return {"graph": g, "x": x, "labels": inp["labels"],
            "train_mask": inp["train_mask"] if mask is None else mask}
