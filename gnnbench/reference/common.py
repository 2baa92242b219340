"""What the apps' references share: the graph's degrees, neighbour sums
in blocks of edges (so that gathered rows of a 14M-edge graph fit), the
per-destination softmax, dropout drawn as the program draws it from the
generator the benchmark hands both sides, the masked cross-entropy, the
global-norm clip and AdamW, and the training driver that follows the
program's first steps.

``tf32=True`` is the control of the fp32 configuration: every matrix
product runs in TF32 (on the card PyTorch's TF32 switch, on the CPU the
products' inputs rounded to TF32's 10-bit mantissa, as the card rounds
them).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

__all__ = ["RefGraph", "ref_graph", "matmul", "tf32_mode", "neighbour_sum",
           "edge_softmax", "dropout", "masked_cross_entropy",
           "clip_by_global_norm", "adamw_step", "train_steps",
           "EDGE_BLOCK_ELEMENTS"]

# gathered elements per block of a neighbour sum (1 GiB of fp32)
EDGE_BLOCK_ELEMENTS = 1 << 28


class RefGraph:
    """The caller-order COO with what the references derive from it."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        self.src = src.long()
        self.dst = dst.long()
        self.n = int(n)
        self.in_deg = torch.bincount(self.dst, minlength=self.n).to(
            torch.float32)

    @property
    def n_edges(self) -> int:
        return int(self.src.numel())


def ref_graph(src, dst, n: int) -> RefGraph:
    return RefGraph(src, dst, n)


_TF32 = {"on": False}


@contextlib.contextmanager
def tf32_mode(on: bool):
    """Every :func:`matmul` inside runs in TF32 when ``on``."""
    old_flag = torch.backends.cuda.matmul.allow_tf32
    old = _TF32["on"]
    _TF32["on"] = bool(on)
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        _TF32["on"] = old
        torch.backends.cuda.matmul.allow_tf32 = old_flag


class _RoundTF32(torch.autograd.Function):
    """Round fp32 to TF32 (10-bit mantissa, nearest, ties away), gradient
    rounded the same way, as a TF32 product rounds both inputs."""

    @staticmethod
    def _round(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    @staticmethod
    def forward(ctx, t):
        return _RoundTF32._round(t)

    @staticmethod
    def backward(ctx, g):
        return _RoundTF32._round(g)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32["on"] and a.device.type != "cuda":
        a, b = _RoundTF32.apply(a), _RoundTF32.apply(b)
    return a @ b


def _blocks(n_edges: int, width: int):
    step = max(1, EDGE_BLOCK_ELEMENTS // max(1, width))
    for lo in range(0, n_edges, step):
        yield slice(lo, min(lo + step, n_edges))


def neighbour_sum(g: RefGraph, h: torch.Tensor,
                  edge_w: torch.Tensor = None) -> torch.Tensor:
    """out[v] = Σ over edges (u → v) of h[u] (times ``edge_w[e]``,
    broadcast over h's trailing dims), summed in blocks of edges."""
    out = torch.zeros((g.n,) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    width = h[0].numel() if h.shape[0] else 1
    for blk in _blocks(g.n_edges, width):
        msg = h.index_select(0, g.src[blk])
        if edge_w is not None:
            w = edge_w[blk]
            msg = msg * w.reshape(w.shape + (1,) * (msg.ndim - w.ndim))
        out = out.index_add(0, g.dst[blk], msg)
    return out


def edge_softmax(g: RefGraph, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of (E, H) edge logits over each destination's in-edges."""
    idx = g.dst[:, None].expand_as(logits)
    with torch.no_grad():     # the shift cancels: no gradient through it
        top = torch.full((g.n,) + tuple(logits.shape[1:]), -float("inf"),
                         dtype=logits.dtype, device=logits.device)
        top = top.scatter_reduce(0, idx, logits, "amax", include_self=True)
    ex = torch.exp(logits - top.index_select(0, g.dst))
    den = torch.zeros_like(top).index_add(0, g.dst, ex)
    return ex / den.index_select(0, g.dst)


def dropout(gen, h: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with the mask drawn as ``torch.rand(h.shape)``
    from ``gen`` (the draw the benchmark's generator hands both sides)."""
    if gen is None or rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    norm = torch.sqrt(sum((gr.double() ** 2).sum() for gr in grads))
    scale = min(1.0, max_norm / max(float(norm), 1e-12))
    return [gr * scale for gr in grads]


def adamw_step(params, grads, mu, nu, t: int, opt: Dict):
    """One AdamW update in place (decoupled decay added to the update,
    eps outside the square root, bias correction by step ``t`` ≥ 1) in
    fp32 as optax computes it: the moments' factors are Python scalars
    that each fp32 op rounds, the bias corrections 1 − βᵗ fp32 powers of
    fp32 tensors. 1 − β₂ᵗ cancels: an ulp of β₂ᵗ is 3e-5 of it at t = 2,
    so another rounding of it reads as a gap in every parameter's change.
    """
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    f32 = torch.float32
    tt = torch.tensor(t, dtype=f32)
    b1c = 1.0 - torch.tensor(b1, dtype=f32) ** tt
    b2c = 1.0 - torch.tensor(b2, dtype=f32) ** tt
    for p, gr, m, v in zip(params, grads, mu, nu):
        m.mul_(b1).add_((1 - b1) * gr)
        v.mul_(b2).add_((1 - b2) * torch.square(gr))
        mh = m / b1c
        vh = v / b2c
        p.add_(-lr * (mh / (torch.sqrt(vh) + eps) + wd * p))


def train_steps(forward: Callable, leaves: Dict[str, torch.Tensor],
                inputs: Dict, opt: Dict, steps: int, gen) -> Dict:
    """``steps`` full-graph steps from ``leaves`` (copied): the loss of
    each, the first step's gradient as AdamW gets it (after the clip) and
    its per-leaf norm, and the per-leaf norm of the parameters' change
    after ``steps``.
    ``forward(params, inputs, gen)`` gives the logits with dropout."""
    names = list(leaves)
    params = [leaves[n].detach().clone().requires_grad_(True)
              for n in names]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    for t in range(1, steps + 1):
        logits = forward(dict(zip(names, params)), inputs, gen)
        loss = masked_cross_entropy(logits, inputs["labels"],
                                    inputs["train_mask"])
        grads = torch.autograd.grad(loss, params)
        clipped = clip_by_global_norm(list(grads), opt["clip"])
        if first is None:
            first = {n: gr.detach().clone() for n, gr in zip(names, clipped)}
        losses.append(float(loss.detach()))
        del logits, loss, grads
        with torch.no_grad():
            adamw_step(params, clipped, mu, nu, t, opt)
    change = {n: float((p.detach() - leaves[n]).norm())
              for n, p in zip(names, params)}
    return {"losses": losses, "grads": first,
            "grad_norms": {n: float(g.norm()) for n, g in first.items()},
            "change_norms": change}
