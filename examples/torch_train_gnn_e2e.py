"""End-to-end driver on the PyTorch port: train GraphSAGE with
checkpointing and auto-resume (kill it anywhere; rerun resumes from the
last checkpoint, in the JAX package's layout). Checkpoints go to
``--ckpt-dir``, by default ``repro_torch_sage_ckpt`` under the temporary
directory (``$TMPDIR``).

    PYTHONPATH=src python examples/torch_train_gnn_e2e.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_gnn_e2e.py --device cpu \\
        --dataset tiny --steps 20 --ckpt-every 10 --ckpt-dir build/sage_ckpt
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.models.gnn import sage
from repro_torch.models.gnn.common import make_bundle
from repro_torch.models.gnn.train import make_train_step
from repro_torch.optim import AdamState
from repro_torch.substrate.nn import accuracy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dataset", default="pubmed-like")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_sage_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--strategy", default="auto",
                    help="aggregation strategy; 'auto' lets the planner "
                         "pick per op (pin 'push'/'ell' to reproduce the "
                         "paper's baseline/optimized runs)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    g, feats, labels, tm, vm, nc = make_node_dataset(args.dataset,
                                                     device=args.device)
    bundle = make_bundle(g)
    model = sage.init(torch.Generator().manual_seed(0), feats.shape[1], 64,
                      nc, device=args.device)
    opt_init, step_fn = make_train_step(sage.forward, args.strategy,
                                        lr=5e-3)
    opt = opt_init(model)
    params = dict(model.named_parameters())

    def state_of(opt, step):
        return {"params": {k: p.detach() for k, p in params.items()},
                "opt": {"mu": list(opt.mu), "nu": list(opt.nu)},
                "step": torch.tensor(step, dtype=torch.int32)}

    mgr = CheckpointManager(args.ckpt_dir)
    restored = mgr.restore_latest(state_of(opt, 0))
    start = 0
    if restored is not None:
        state, start = restored
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
        opt = AdamState(list(state["opt"]["mu"]), list(state["opt"]["nu"]))
        print(f"[e2e] resumed from step {start}")

    dev = g.device
    x = torch.as_tensor(feats, device=dev)
    y = torch.as_tensor(labels, device=dev)
    m = torch.as_tensor(tm, device=dev)
    v = torch.as_tensor(vm, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    loss = None
    for step in range(start, args.steps):
        opt, loss = step_fn(model, opt, step, bundle, x, y, m, gen)
        if step % 25 == 0:
            with torch.no_grad():
                logits = sage.forward(model, bundle, x,
                                      strategy=args.strategy)
            va = float(accuracy(logits, y, v))
            print(f"[e2e] step={step} loss={float(loss):.4f} "
                  f"val_acc={va:.3f}")
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(state_of(opt, step + 1), step + 1)
    dt = time.perf_counter() - t0
    with torch.no_grad():
        logits = sage.forward(model, bundle, x, strategy=args.strategy)
    acc = float(accuracy(logits, y, v))
    print(f"[e2e] done ({args.steps - start} steps in {dt:.1f}s). "
          f"final val acc {acc:.3f}")
    return {"start": start, "loss": None if loss is None else float(loss),
            "val_acc": acc}


if __name__ == "__main__":
    main()
