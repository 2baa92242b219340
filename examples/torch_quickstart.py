"""Quickstart on the PyTorch port: the Copy-Reduce primitive under each
aggregation strategy (and the planner's pick), then GCN trained on a
synthetic citation graph.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import copy_reduce, from_coo, planner
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.models.gnn import gcn
from repro_torch.models.gnn.common import make_bundle
from repro_torch.models.gnn.train import train_full_graph

STRATEGIES = ("push", "segment", "ell", "onehot", "kernel", "auto")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu' (plain versions)")
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args(argv)

    # --- the primitive itself -------------------------------------------
    g = from_coo([0, 1, 2, 0], [2, 2, 1, 1], n_src=3, n_dst=3,
                 device=args.device)
    x = torch.eye(3, device=args.device)
    print("Copy-Reduce (paper Eq. 3) under each strategy:")
    outs = {}
    for s in STRATEGIES:
        outs[s] = copy_reduce(g, x, strategy=s).cpu().numpy()
        print(f"  {s:8s} ->\n{outs[s]}")
    print(f"planner chose: {planner.last_plan('u_copy_add_v')} "
          f"(strategy='auto' is the default everywhere)")

    # --- a real application ---------------------------------------------
    graph, feats, labels, train_mask, val_mask, nc = make_node_dataset(
        "tiny", device=args.device)
    model = gcn.init(torch.Generator().manual_seed(0), feats.shape[1], 32,
                     nc, device=args.device)
    model, hist = train_full_graph(
        gcn.forward, model, make_bundle(graph), feats, labels, train_mask,
        strategy="ell", epochs=args.epochs, val_mask=val_mask)
    print(f"\nGCN on {graph}: loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}, val acc {hist['val_acc'][-1]:.3f}")
    print(f"median epoch time {1e3 * np.median(hist['epoch_time']):.1f} ms "
          f"(strategy='ell', the paper's blocked pull)")
    return outs, hist


if __name__ == "__main__":
    main()
