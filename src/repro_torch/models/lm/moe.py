"""Mixture-of-Experts FFN (port of ``repro/models/lm/moe.py``; mixtral,
granite-moe).

Dispatch is the Copy-Reduce of the JAX module: a token's slot is its rank
within its expert (a cumsum over the one-hot assignment, in token-major
order), token INDICES are scattered into an (E+1, Cb+1) table whose last
row and column take the dropped choices and are sliced off, and the
payloads are gathered; combine is a gate-weighted gather. GShard capacity
``Cb = max(1, int(K·Tb·cf/E))``; overflow choices are dropped, and the
Switch auxiliary loss keeps drops rare.

On one card JAX's token-block grid is one block (``dd = dm = 1``: the
mesh-aligned blocking and its ``shard_hint`` are the identity), so
``Tb = T = B·S``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import normal

__all__ = ["MoE", "Routing", "moe_init", "moe_route", "moe_apply"]


class MoE(nn.Module):
    """``router`` (D, E) float32; ``w_gate`` / ``w_up`` (E, D, F),
    ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        s_in, s_out = D ** -0.5, Fd ** -0.5
        self.router = normal(gen, (D, E), s_in, torch.float32, device)
        self.w_gate = normal(gen, (E, D, Fd), s_in, dtype, device)
        self.w_up = normal(gen, (E, D, Fd), s_in, dtype, device)
        self.w_down = normal(gen, (E, Fd, D), s_out, dtype, device)


def moe_init(cfg: ModelConfig, dtype, device, gen) -> MoE:
    return MoE(cfg, dtype, device, gen)


class Routing(NamedTuple):
    """One block's routing: gate weights and experts (T, K), and per
    choice (T·K, token-major) its slot, whether it was kept, the Switch
    aux loss and the capacity."""
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    slot_e: torch.Tensor
    slot_c: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: MoE, cfg: ModelConfig, xt: torch.Tensor) -> Routing:
    """Route tokens ``xt`` (T, D): top-k of the router's softmax, the
    slot of every choice and the aux loss."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    Cb = max(1, int(K * T * cfg.capacity_factor / E))
    probs = torch.softmax(xt.float() @ p.router, dim=-1)      # (T, E)
    gate_vals, gate_idx = _top_k(probs, K)                    # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    # rank of each choice within its expert, in token-major order
    flat_e = gate_idx.reshape(T * K)
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # (TK, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    flat_pos = (pos * onehot).sum(-1)
    keep = flat_pos < Cb
    slot_e = torch.where(keep, flat_e, E)                     # drop -> pad
    slot_c = torch.where(keep, flat_pos, Cb)
    return Routing(gate_vals, gate_idx, slot_e, slot_c, keep, aux, Cb)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y, aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    r = moe_route(p, cfg, xt)
    Cb = r.capacity

    # dispatch: scatter token indices (not payloads) into the slot table;
    # every kept choice has a slot of its own, the drops share (E, Cb)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    slot_tok = torch.full((E + 1, Cb + 1), T, dtype=torch.long,
                          device=x.device)
    slot_tok[r.slot_e, r.slot_c] = tok
    slot_tok = slot_tok[:E, :Cb]                              # (E, Cb)
    x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    buf = x_pad[slot_tok.reshape(E * Cb)].reshape(E, Cb, D)

    # expert FFN (SwiGLU)
    h = F.silu(matmul(buf, p.w_gate)) * matmul(buf, p.w_up)
    y_buf = matmul(h, p.w_down)                               # (E, Cb, D)

    # combine: gather each choice's slot, weight, sum the K choices
    idx = (torch.clamp(r.slot_e, 0, E - 1) * Cb
           + torch.clamp(r.slot_c, max=Cb - 1))
    gathered = y_buf.reshape(E * Cb, D)[idx]
    gathered = torch.where(r.keep[:, None], gathered, 0)
    w = r.gate_vals.reshape(T * K, 1).to(gathered.dtype)
    y = (gathered * w).reshape(T, K, D).sum(1)
    return y.reshape(B, S, D).to(x.dtype), r.aux
