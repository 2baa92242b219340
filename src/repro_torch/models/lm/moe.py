"""Mixture-of-Experts FFN (port of ``repro/models/lm/moe.py``; mixtral,
granite-moe).

Dispatch is the Copy-Reduce of the JAX module: a token's slot is its rank
within its expert (a cumsum over the one-hot assignment, in token-major
order), token INDICES are scattered into an (E+1, Cb+1) table whose last
row and column take the dropped choices and are sliced off, and the
payloads are gathered; combine is a gate-weighted gather. GShard capacity
``Cb = max(1, int(K·Tb·cf/E))`` per token block; overflow choices are
dropped, and the Switch auxiliary loss keeps drops rare.

Token blocks (JAX's ``_block_layout``): under an ambient mesh the tokens
form a (data, model)-aligned grid of ``dd × dm`` blocks — the batch split
``dd`` ways (the data × pod size, when it divides B), the sequence ``dm``
ways (the model size, for a small expert FFN, when it divides S) — and
capacity, ranks and drops are decided per block, in the block's own
token order (rows ``B/dd`` × positions ``S/dm``, row-major). So an MoE's
loss on a mesh differs from its one-device loss by design. With no mesh
there is one block, ``Tb = B·S``. On a process mesh a rank holds one data
block of rows (or, when B does not divide, the whole batch: one block
either way) and splits it ``dm`` ways; the aux loss
``E·Σ(me·ce)`` is a product of GLOBAL means, so the rank all-reduces
``ce`` (no gradient) over the mesh and uses ``E·Σ(me_r·ce)``, whose mean
over the ranks is JAX's aux. The ``shard_hint`` sites are JAX's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.transport import all_reduce_sum
from ...pjit_utils import (axis_sizes, current_mesh, is_process_mesh,
                           mesh_group, shard_hint)
from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import normal

__all__ = ["MoE", "Routing", "moe_init", "moe_route", "moe_apply",
           "small_ffn"]


def small_ffn(cfg: ModelConfig) -> bool:
    """Tiny expert FFNs (granite: d_ff = 512), ≤ 512 MiB of bf16 expert
    weights: their weights are replicated, not ff-TP-sharded
    (``launch/shardings.py``), and the token blocks also split the
    sequence over 'model'."""
    return cfg.n_experts * cfg.d_ff * cfg.d_model * 2 * 3 <= 512 * 1024 ** 2


def _block_layout(B: int, S: int, small_ffn: bool):
    """(dd, dm): the token-block grid of an (B, S) input under the
    ambient mesh (see the module docstring)."""
    mesh = current_mesh()
    if mesh is None:
        return 1, 1
    sizes = axis_sizes(mesh)
    ds = sizes.get("data", 1) * sizes.get("pod", 1)
    ms = sizes.get("model", 1)
    dm = ms if (small_ffn and S % ms == 0) else 1
    if is_process_mesh(mesh):
        return 1, dm
    return (ds if B % ds == 0 else 1), dm


def _mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t``'s mean over the ranks of the ambient process mesh (``t``
    itself with none)."""
    mesh = current_mesh()
    if not is_process_mesh(mesh):
        return t
    return all_reduce_sum([t], mesh_group(mesh))[0] / mesh.size()


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
    """The blocks' routing: gate weights and experts (ds, Tb, K), and per
    choice (ds, Tb·K, token-major within a block) its slot, whether it
    was kept; the Switch aux loss and the per-block capacity. Routing of
    one (T, D) block drops the leading ds."""
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


def moe_route(p: MoE, cfg: ModelConfig, xb: torch.Tensor) -> Routing:
    """Route token blocks ``xb`` (ds, Tb, D), or (T, D) as one block:
    top-k of the router's softmax, the slot of every choice within its
    block and the aux loss."""
    one = xb.dim() == 2
    if one:
        xb = xb[None]
    ds, Tb, _ = xb.shape
    E, K = cfg.n_experts, cfg.top_k
    Cb = max(1, int(K * Tb * cfg.capacity_factor / E))
    probs = torch.softmax(xb.float() @ p.router, dim=-1)      # (ds, Tb, E)
    gate_vals, gate_idx = _top_k(probs, K)                    # (ds, Tb, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style), of global means
    me = probs.mean((0, 1))
    ce = _mean_over_ranks(F.one_hot(gate_idx[..., 0], E).float().mean((0, 1)))
    aux = E * torch.sum(me * ce)
    # rank of each choice within its expert, token-major within a block
    flat_e = gate_idx.reshape(ds, Tb * K)
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # (ds, TbK, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    flat_pos = (pos * onehot).sum(-1)
    keep = flat_pos < Cb
    slot_e = torch.where(keep, flat_e, E)                     # drop -> pad
    slot_c = torch.where(keep, flat_pos, Cb)
    r = Routing(gate_vals, gate_idx, slot_e, slot_c, keep, aux, Cb)
    if one:
        r = r._replace(**{f: getattr(r, f)[0] for f in (
            "gate_vals", "gate_idx", "slot_e", "slot_c", "keep")})
    return r


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y, aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    small = small_ffn(cfg)
    dd, dm = _block_layout(B, S, small)
    ds = dd * dm
    block_ax = (("data", "model") if dm > 1 else
                ("data" if dd > 1 else None))
    Tb = B * S // ds
    # mesh-aligned blocking: (B,S,D) -> (dd, B/dd, dm, S/dm, D) ->
    # (dd, dm, B/dd, S/dm, D) -> (ds, Tb, D)
    xb = x.reshape(dd, B // dd, dm, S // dm, D)
    xb = shard_hint(xb, "data", None, "model" if dm > 1 else None,
                    None, None)
    xb = xb.transpose(1, 2).reshape(ds, Tb, D)
    xb = shard_hint(xb, block_ax, None, None)
    r = moe_route(p, cfg, xb)
    Cb = r.capacity

    # dispatch: scatter token indices (not payloads) into each block's
    # slot table; every kept choice has a slot of its own, the drops
    # share (E, Cb)
    blk = torch.arange(ds, device=x.device)[:, None]
    tok = torch.arange(Tb, device=x.device).repeat_interleave(K)
    slot_tok = torch.full((ds, E + 1, Cb + 1), Tb, dtype=torch.long,
                          device=x.device)
    slot_tok[blk, r.slot_e, r.slot_c] = tok.expand(ds, -1)
    slot_tok = slot_tok[:, :E, :Cb] + blk[:, :, None] * (Tb + 1)
    x_pad = torch.cat([xb, xb.new_zeros((ds, 1, D))], dim=1)
    buf = x_pad.reshape(ds * (Tb + 1), D)[slot_tok.reshape(-1)]
    buf = buf.reshape(ds, E, Cb, D).transpose(0, 1).reshape(E, ds * Cb, D)

    # expert FFN (SwiGLU): ff-TP for big experts, replicated small ones
    ff_ax = None if small else "model"
    buf = shard_hint(buf, None, block_ax, None)
    h_g = matmul(buf, p.w_gate)
    h = F.silu(shard_hint(h_g, None, block_ax, ff_ax)) * matmul(buf, p.w_up)
    y_buf = shard_hint(matmul(h, p.w_down), None, block_ax, None)

    # combine: gather each choice's slot in its block, weight, sum the K
    y_blk = (y_buf.reshape(E, ds, Cb, D).transpose(0, 1)
             .reshape(ds * E * Cb, D))
    idx = (torch.clamp(r.slot_e, 0, E - 1) * Cb
           + torch.clamp(r.slot_c, max=Cb - 1) + blk * (E * Cb))
    gathered = y_blk[idx.reshape(-1)]
    gathered = torch.where(r.keep.reshape(-1, 1), gathered, 0)
    w = r.gate_vals.reshape(ds * Tb * K, 1).to(gathered.dtype)
    y = (gathered * w).reshape(ds, Tb, K, D).sum(2)
    # inverse of the mesh-aligned blocking
    y = (y.reshape(dd, dm, B // dd, S // dm, D).transpose(1, 2)
         .reshape(B, S, D))
    return y.to(x.dtype), r.aux
