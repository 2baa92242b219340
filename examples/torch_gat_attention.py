"""GAT on the PyTorch port with the paper's composed attention chain
(edge logits, edge softmax, weighted aggregation as separate ops) beside
the fused edge softmax, which runs the chain in one pass (B2 on the
card): the same numbers, side by side, and their times.

    PYTHONPATH=src python examples/torch_gat_attention.py            # card
    PYTHONPATH=src python examples/torch_gat_attention.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.data.synthetic import make_node_dataset
from repro_torch.models.gnn import gat
from repro_torch.models.gnn.common import make_bundle


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu' (plain versions)")
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    g, feats, labels, tm, vm, nc = make_node_dataset(args.dataset,
                                                     device=args.device)
    bundle = make_bundle(g)
    model = gat.init(torch.Generator().manual_seed(0), feats.shape[1], 32,
                     nc, n_heads=4, device=args.device)
    x = torch.as_tensor(feats, device=args.device)

    def composed():
        return gat.forward(model, bundle, x, fused_softmax=False)

    def fused():
        return gat.forward(model, bundle, x, fused_softmax=True)

    with torch.no_grad():
        a, b = composed(), fused()
        err = float((a - b).abs().max())
        print(f"composed-vs-fused max err: {err:.2e}")
        times = {}
        for name, fn in (("composed (the chain, op by op)", composed),
                         ("fused (one pass)", fused)):
            fn()                                    # warm
            _sync(args.device)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            _sync(args.device)
            times[name] = (time.perf_counter() - t0) / args.reps * 1e3
            print(f"{name}: {times[name]:.2f} ms/fwd")
    return {"max_err": err, "ms": times}


if __name__ == "__main__":
    main()
