"""Full-graph training (the paper's Fig. 2 measure): one unit is one step
of the port's trainer — ``repro_torch.models.gnn.train.make_train_step``,
the step ``train_full_graph`` runs each epoch: forward, masked
cross-entropy, ``autograd.grad`` (the kernels' backward on Gᵀ), global
norm clip, AdamW — ending in the loss read, as an epoch of
``train_full_graph`` ends, on the trainer's default strategy (``auto``).

Set-up builds the graph the step takes through the configuration's graph
kind (``graphs/<graph>.py``; ``rmat``'s is G, Gᵀ and the bundle), loads
the model from the benchmark's weights, and runs the first
``setup_steps`` steps of the one step object (model and AdamW state)
that the window then continues; they warm every shape of the window.
The check compares those first steps with the reference's: each step's
loss, the first gradient as AdamW got it (its first moment over 1 − β₁)
and the parameters' change after the last set-up step, per leaf.
"""
from __future__ import annotations

import functools
import math
import statistics
import time
from typing import Dict

import torch

from gnnbench.data.graph import generator
from gnnbench.inputs import (build_graph, make_inputs, model_costs, n_edges,
                             port_model, port_module, reference_inputs,
                             reference_module, relative_gap)

# leaves whose reference gradient is under this share of the median
# leaf's move under AdamW by round-off alone: not compared by their change
STILL_LEAF = 1e-3


class State:
    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.attempted = self.failed = 0

    def unit(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        self.opt_state, loss = self.step(
            self.model, self.opt_state, self.i, self.bundle, self.x,
            self.labels, self.mask, self.gen)
        t1 = time.perf_counter()
        loss = float(loss)
        self.i += 1
        self.attempted += 1
        self.failed += not math.isfinite(loss)
        return {"host_ms": (t1 - t0) * 1e3}


def setup(ctx) -> State:
    from repro_torch.models.gnn import train as port_train

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    inp = make_inputs(ctx)
    bundle = build_graph(ctx, inp)

    opt = cfg["optimizer"]
    model = port_model(cfg, inp["leaves"], dev)
    fwd = functools.partial(port_module(cfg).forward, **cfg["port_forward"])
    opt_init, step = port_train.make_train_step(
        fwd, lr=opt["lr"], weight_decay=opt["weight_decay"],
        clip=opt["clip"])
    state = State(inp=inp, bundle=bundle, model=model, step=step,
                  opt_state=opt_init(model), i=0, x=inp["x"],
                  labels=inp["labels"], mask=inp["train_mask"],
                  gen=generator(ctx.seed, "dropout", dev))
    names = [nm for nm, _ in model.named_parameters()]
    losses, first_mu = [], None
    for _ in range(p["setup_steps"]):
        t = time.perf_counter()
        state.opt_state, loss = step(model, state.opt_state, state.i,
                                     bundle, state.x, state.labels,
                                     state.mask, state.gen)
        losses.append(float(loss))
        ctx.info["unit_s"] = time.perf_counter() - t
        if state.i == 0:
            first_mu = [m.detach().clone() for m in state.opt_state.mu]
        state.i += 1
    b1 = opt["b1"]
    state.readings = {
        "losses": losses,
        "grads": {nm: m / (1 - b1) for nm, m in zip(names, first_mu)},
        "grad_norms": {nm: float(m.norm()) / (1 - b1)
                       for nm, m in zip(names, first_mu)},
        "change_norms": {nm: float((q.detach() - inp["leaves"][nm]).norm())
                         for nm, q in model.named_parameters()}}
    first = math.sqrt(sum(v * v for v in
                          state.readings["grad_norms"].values()))
    ctx.log(f"set-up steps: losses {losses}, last step "
            f"{ctx.info['unit_s'] * 1e3:.2f} ms; first gradient's norm "
            f"{first:.6g} (clip {opt['clip']})")
    return state


def end_to_end(ctx, state, window) -> Dict[str, float]:
    return {"epoch_ms": 1e3 * sum(window["unit_s"]) / window["count"]}


def model_flops(ctx) -> float:
    cfg = ctx.config
    return model_costs(ctx).train_step(cfg, cfg["nodes"], n_edges(ctx))


def free_program(state) -> Dict:
    """Drop every object of the program, keep the inputs."""
    inp = state.inp
    for name in ("model", "bundle", "opt_state", "step"):
        setattr(state, name, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return inp


def reference_readings(ctx, inp: Dict, *, tf32: bool = False,
                       mask=None, still: bool = False) -> Dict:
    """The reference's first ``setup_steps`` steps from the same weights,
    inputs and dropout draws; ``tf32`` the control; faults: ``mask`` a
    train mask in place of the cell's, ``still`` the parameters left
    unchanged by every step."""
    from gnnbench.reference.common import tf32_mode, train_steps

    cfg = ctx.config
    opt = (dict(cfg["optimizer"], lr=0.0, weight_decay=0.0) if still
           else cfg["optimizer"])
    ref = reference_module(ctx)
    inputs = reference_inputs(ctx, inp, mask)
    with tf32_mode(tf32):
        return train_steps(
            lambda prm, ins, gen: ref.forward(prm, ins, cfg, gen),
            inp["leaves"], inputs, opt, ctx.params["setup_steps"],
            generator(ctx.seed, "dropout", ctx.device))


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a training cell compares: the widest loss gap of the
    set-up steps (``loss_gap``) and the first step's (``first_loss_gap``:
    the forward alone, which a logit rounded across leaky-relu's kink
    does not move, where one such logit can move every leaf's gradient
    nearly as far as TF32 does); the worst leaf's first-gradient norm gap
    (``grad_gap``) and the worst leaf's norm of the first gradient's
    difference (``grad_diff``); the worst leaf's change-norm gap
    (``update_gap``; leaves the reference does not move left out). Each
    leaf's reading is over the larger of its reference norm and the
    median leaf's."""
    gn = ref["grad_norms"]
    med = statistics.median(gn.values())
    moving = [n for n, v in gn.items() if v >= STILL_LEAF * med]
    cn = ref["change_norms"]
    cmed = statistics.median(cn[n] for n in moving)
    return {"loss_gap": relative_gap(got["losses"], ref["losses"]),
            "first_loss_gap": relative_gap(got["losses"][:1],
                                           ref["losses"][:1]),
            "grad_gap": max(abs(got["grad_norms"][n] - v) / max(v, med)
                            for n, v in gn.items()),
            "grad_diff": max(float((got["grads"][n].to(g.device) - g).norm())
                             / max(gn[n], med)
                             for n, g in ref["grads"].items()),
            "update_gap": max(abs(got["change_norms"][n] - cn[n])
                              / max(cn[n], cmed) for n in moving)}


def log_leaves(ctx, got: Dict, ref: Dict) -> None:
    ctx.log(f"reference losses {ref['losses']}")
    for kind in ("grad_norms", "change_norms"):
        ctx.log(f"{kind} by leaf (program, reference): " + ", ".join(
            f"{n} {got[kind][n]:.9g} {v:.9g}" for n, v in ref[kind].items()))


def check(ctx, state) -> Dict[str, float]:
    got = state.readings
    inp = free_program(state)
    ref = reference_readings(ctx, inp)
    log_leaves(ctx, got, ref)
    return gaps(got, ref)


def half_mask(mask: torch.Tensor, seed: int) -> torch.Tensor:
    """``mask`` with a random half of its nodes left out (a fault)."""
    idx = mask.nonzero()[:, 0]
    gen = generator(seed, "fault", "cpu")
    drop = idx[torch.randperm(idx.numel(), generator=gen)[: idx.numel() // 2]
               .to(idx.device)]
    out = mask.clone()
    out[drop] = False
    return out


def control(ctx, state) -> Dict[str, Dict[str, float]]:
    """The program's numbers, the control's (the reference in TF32) and
    the planted faults' (half of the train nodes left out of the loss;
    the state left unchanged) against the fp32 reference, for one
    seed."""
    got = state.readings
    inp = free_program(state)
    ref = reference_readings(ctx, inp)
    log_leaves(ctx, got, ref)
    return {"program": gaps(got, ref),
            "control_tf32": gaps(reference_readings(ctx, inp, tf32=True),
                                 ref),
            "fault_half_batch": gaps(reference_readings(
                ctx, inp, mask=half_mask(inp["train_mask"], ctx.seed)), ref),
            "fault_state_unchanged": gaps(reference_readings(
                ctx, inp, still=True), ref)}
