"""A cell's inputs and what both sides get from them: the COO (on the
host, the port's ``from_coo`` entry takes host arrays), the node data and
the weights on the device, the port's model built from the weights, and
the reference's module and graph; and the gaps that decide ``correct``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .data.graph import glorot_leaves, node_data, rmat_edges

__all__ = ["make_inputs", "reference_module", "port_module", "port_model",
           "reference_inputs", "model_costs", "n_edges", "relative_gap",
           "table_gap"]


def reference_module(cfg: Dict):
    return importlib.import_module(f"gnnbench.reference.{cfg['app']}")


def port_module(cfg: Dict):
    return importlib.import_module(f"repro_torch.models.gnn.{cfg['app']}")


def model_costs(ctx):
    """The app's model-FLOP functions, ``costs/model_<app>.py``."""
    from .harness import load_file_module
    app = ctx.config["app"]
    return load_file_module(ctx.cell.bench / "costs" / f"model_{app}.py",
                            f"gnnbench_model_{app}")


def n_edges(cfg: Dict) -> int:
    """Edges of the configuration's graph, self-loops included."""
    return cfg["edges"] + cfg["nodes"] * bool(cfg["self_loops"])


def make_inputs(ctx) -> Dict:
    """The graph's host COO, the node data and the weights of ``ctx``'s
    cell from its seed."""
    cfg, dev = ctx.config, ctx.device
    src, dst = rmat_edges(cfg["nodes"], cfg["edges"], ctx.seed, dev,
                          a=cfg["rmat_a"], b=cfg["rmat_b"], c=cfg["rmat_c"],
                          self_loops=cfg["self_loops"])
    out = {"src": src.cpu().numpy(), "dst": dst.cpu().numpy()}
    del src, dst
    out.update(node_data(cfg["nodes"], cfg["features"], cfg["classes"],
                         cfg["train_nodes"], ctx.seed, dev))
    out["leaves"] = glorot_leaves(reference_module(cfg).leaf_shapes(cfg),
                                  ctx.seed, dev)
    return out


def port_model(cfg: Dict, leaves: Dict[str, torch.Tensor], device):
    """The port's module of the app, loaded from the benchmark's weights
    (JAX's ``{"layers": [{leaf: array}]}`` layout, the port's loader)."""
    layers: Dict[int, Dict] = {}
    for name, t in leaves.items():
        _, i, leaf = name.split(".")
        layers.setdefault(int(i), {})[leaf] = t.detach().cpu().numpy()
    tree = {"layers": [layers[i] for i in sorted(layers)]}
    cls = getattr(port_module(cfg), cfg["app"].upper())
    return cls.from_numpy(tree, device=device)


def reference_inputs(inp: Dict, device, mask: Optional[torch.Tensor] = None
                     ) -> Dict:
    from .reference.common import ref_graph
    n = int(inp["labels"].shape[0])
    g = ref_graph(torch.from_numpy(inp["src"]).to(device),
                  torch.from_numpy(inp["dst"]).to(device), n)
    x = inp["x"]
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x).to(device)
    return {"graph": g, "x": x, "labels": inp["labels"],
            "train_mask": inp["train_mask"] if mask is None else mask}


def relative_gap(got: Iterable[float], ref: Iterable[float]) -> float:
    """The widest |got − ref| / |ref| over paired readings."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))


def table_gap(got: np.ndarray, ref: torch.Tensor) -> float:
    """max |got − ref| / max |ref| of an output table, on ``ref``'s
    device."""
    g = torch.from_numpy(np.ascontiguousarray(got)).to(ref.device)
    if g.shape != ref.shape or not torch.isfinite(g).all():
        return float("inf")
    return float((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
