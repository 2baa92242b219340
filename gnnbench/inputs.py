"""A cell's inputs and what both sides get from them, through the files
its configuration names: the graph kind (``graphs/<graph>.py``) makes the
host arrays, the node data and the weights, builds the object the port's
step takes, and gives the reference its graph; the app's reference
(``reference/<app>.py``) and model costs (``costs/model_<app>.py``); the
port's model built from the weights; and the gaps that decide
``correct``. Each file is found under the cell's benchmark folder, so a
new app or graph kind is added as files.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch

__all__ = ["bench_module", "graph_kind", "make_inputs", "build_graph",
           "reference_module", "port_module", "port_model",
           "reference_inputs", "model_costs", "n_edges", "relative_gap",
           "table_gap"]


def bench_module(ctx, folder: str, name: str):
    """``<folder>/<name>.py`` of the cell's benchmark folder, loaded as
    ``gnnbench.<folder>.<name>`` (so that its relative imports resolve)."""
    from .harness import load_file_module
    return load_file_module(ctx.cell.bench / folder / f"{name}.py",
                            f"gnnbench.{folder}.{name}")


def graph_kind(ctx):
    return bench_module(ctx, "graphs", ctx.config["graph"])


def reference_module(ctx):
    return bench_module(ctx, "reference", ctx.config["app"])


def port_module(cfg: Dict):
    return importlib.import_module(f"repro_torch.models.gnn.{cfg['app']}")


def model_costs(ctx):
    """The app's model-FLOP functions, ``costs/model_<app>.py``."""
    return bench_module(ctx, "costs", f"model_{ctx.config['app']}")


def n_edges(ctx) -> int:
    """Edges of the cell's graph, as its kind counts them."""
    return graph_kind(ctx).n_edges(ctx.config)


def make_inputs(ctx) -> Dict:
    """The graph's host arrays, the node data and the weights of ``ctx``'s
    cell from its seed."""
    return graph_kind(ctx).make_inputs(ctx)


def build_graph(ctx, inp: Dict):
    """The object the port's step takes, built from ``inp``; the set-up
    parts timed into ``ctx.info["graph_build_s"]``."""
    return graph_kind(ctx).build(ctx, inp)


def reference_inputs(ctx, inp: Dict, mask: Optional[torch.Tensor] = None
                     ) -> Dict:
    """The reference's graph, features, labels and train mask (``mask``
    in place of the cell's)."""
    return graph_kind(ctx).reference_inputs(inp, ctx.device, mask)


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
