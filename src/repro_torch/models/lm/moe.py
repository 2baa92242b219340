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
there is one block, ``Tb = B·S``. The aux loss ``E·Σ(me·ce)`` is a
product of GLOBAL means.

Over a process mesh :func:`moe_split` runs the rank's share under the
model axis's split (``tp.Split.moe``): a rank holds one data block of
rows (or, when B does not divide, the whole batch), and its block is
JAX's: its residual rows under 'slots' (``dm`` = the model size), the
rows' whole sequence otherwise (``dm`` = 1), whose experts' slots 'ep'
splits by expert and 'ff' by d_ff. The rank all-reduces ``ce`` (no
gradient) over the mesh and uses ``E·Σ(me_r·ce)``: the mean over the
ranks is JAX's aux. The ``shard_hint`` sites are JAX's.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.transport import (all_reduce_sum, gather_blocks,
                               reduce_from_group, take_block)
from ...pjit_utils import (axis_sizes, current_mesh, is_process_mesh,
                           mesh_group, shard_hint)
from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import normal

__all__ = ["MoE", "Routing", "moe_init", "moe_route", "moe_apply",
           "moe_split", "small_ffn"]


def small_ffn(cfg: ModelConfig) -> bool:
    """Tiny expert FFNs (granite: d_ff = 512), ≤ 512 MiB of bf16 expert
    weights: their weights are replicated, not ff-TP-sharded
    (``launch/shardings.py``), and the token blocks also split the
    sequence over 'model'. The one test the specs, the token blocks and
    the split (``tp.Split.moe``) read, each at call time."""
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


def _mean_over_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``'s mean over the ranks of the process mesh ``mesh`` (``t``
    itself on none)."""
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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (bool) by a comparison: no data-dependent
    range check, so a fake tensor's op count is a real one's."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: MoE, cfg: ModelConfig, xb: torch.Tensor,
              mesh=None) -> Routing:
    """Route token blocks ``xb`` (ds, Tb, D), or (T, D) as one block:
    top-k of the router's softmax, the slot of every choice within its
    block and the aux loss (``ce`` averaged over the ranks of ``mesh``,
    default the ambient mesh, when it is a process mesh)."""
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
    ce = _mean_over_ranks(_one_hot(gate_idx[..., 0], E).float().mean((0, 1)),
                          current_mesh() if mesh is None else mesh)
    aux = E * torch.sum(me * ce)
    # rank of each choice within its expert, token-major within a block
    flat_e = gate_idx.reshape(ds, Tb * K)
    onehot = _one_hot(flat_e, E).to(torch.int32)              # (ds, TbK, E)
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
    y = _experts(p, cfg, xb, r, block_ax, None if small else "model")
    # inverse of the mesh-aligned blocking
    y = (y.reshape(dd, dm, B // dd, S // dm, D).transpose(1, 2)
         .reshape(B, S, D))
    return y.to(x.dtype), r.aux


def _experts(p, cfg: ModelConfig, xb: torch.Tensor, r: Routing,
             block_ax=None, ff_ax=None, e0: int = 0) -> torch.Tensor:
    """Dispatch, expert FFN and combine of the blocks ``xb`` (ds, Tb, D)
    routed by ``r``, for the experts ``e0 … e0 + En - 1`` that ``p``'s
    weights hold (``En = p.w_gate.shape[0]``; the choices of the others
    add nothing): (ds, Tb, D)."""
    ds, Tb, D = xb.shape
    E, K, Cb = cfg.n_experts, cfg.top_k, r.capacity
    En = p.w_gate.shape[0]
    # dispatch: scatter token indices (not payloads) into each block's
    # slot table; every kept choice has a slot of its own, the drops
    # share (E, Cb)
    blk = torch.arange(ds, device=xb.device)[:, None]
    tok = torch.arange(Tb, device=xb.device).repeat_interleave(K)
    slot_tok = torch.full((ds, E + 1, Cb + 1), Tb, dtype=torch.long,
                          device=xb.device)
    slot_tok[blk, r.slot_e, r.slot_c] = tok.expand(ds, -1)
    slot_tok = slot_tok[:, e0:e0 + En, :Cb] + blk[:, :, None] * (Tb + 1)
    x_pad = torch.cat([xb, xb.new_zeros((ds, 1, D))], dim=1)
    buf = x_pad.reshape(ds * (Tb + 1), D)[slot_tok.reshape(-1)]
    buf = buf.reshape(ds, En, Cb, D).transpose(0, 1).reshape(En, ds * Cb, D)

    # expert FFN (SwiGLU): ff-TP for big experts, replicated small ones
    buf = shard_hint(buf, None, block_ax, None)
    h_g = matmul(buf, p.w_gate)
    h = F.silu(shard_hint(h_g, None, block_ax, ff_ax)) * matmul(buf, p.w_up)
    y_buf = shard_hint(matmul(h, p.w_down), None, block_ax, None)

    # combine: gather each choice's slot in its block, weight, sum the K
    y_blk = (y_buf.reshape(En, ds, Cb, D).transpose(0, 1)
             .reshape(ds * En * Cb, D))
    own = r.keep & (r.slot_e >= e0) & (r.slot_e < e0 + En)
    idx = (torch.clamp(r.slot_e - e0, 0, En - 1) * Cb
           + torch.clamp(r.slot_c, max=Cb - 1) + blk * (En * Cb))
    gathered = y_blk[idx.reshape(-1)]
    gathered = torch.where(own.reshape(-1, 1), gathered, 0)
    w = r.gate_vals.reshape(ds * Tb * K, 1).to(gathered.dtype)
    return (gathered * w).reshape(ds, Tb, K, D).sum(2)


def moe_split(p: MoE, cfg: ModelConfig, x: torch.Tensor, split
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's share of the MoE FFN under ``split`` (a ``tp.Split``;
    its ``moe`` mode, the ``tp`` module docstring): ``x`` and the output
    in the residual layout; returns (y, aux), the aux loss the same on
    every 'model' rank, JAX's mean over the rank's data block."""
    mode = split.moe
    B, _, D = x.shape
    e0 = 0
    if mode == "slots":
        # the rank's rows are its (data, model) block: the weights whole,
        # for the rank's own tokens
        xs = x
        w = types.SimpleNamespace(**{n: split.part(t)
                                     for n, t in p.named_parameters()})
    elif mode == "replicated":
        # the whole FFN on every 'model' rank, on the rows' sequence
        xs = gather_blocks(x, split.group, 1) if split.sp else x
        w = p
    else:
        # 'ep' / 'ff': the rows' whole sequence routed alike on every
        # 'model' rank, each running its experts or its d_ff chunk of all
        xs = split.enter(x)
        full = cfg.n_experts if mode == "ep" else cfg.d_ff
        e0 = split.chunk(full)[0] if mode == "ep" else 0
        w = types.SimpleNamespace(router=split.part(p.router), **{
            n: split.tp(getattr(p, n), split.chunk_dim(f"moe.{n}"), full)
            for n in ("w_gate", "w_up", "w_down")})
    S = xs.shape[1]
    xb = xs.reshape(1, B * S, D)
    r = moe_route(w, cfg, xb, split.mesh)
    y = _experts(w, cfg, xb, r, e0=e0).reshape(B, S, D).to(x.dtype)
    if mode == "slots":
        # each 'model' rank routed its own block: the mean of their aux
        return y, reduce_from_group(r.aux / split.m, split.group)
    if mode == "replicated":
        return (take_block(y, split.group, 1) if split.sp else y), r.aux
    # the aux loss, the same on every 'model' rank, reaches the router
    # (entered for the rank's share) once
    aux = r.aux.detach() + (r.aux - r.aux.detach()) / split.m
    return split.exit(y), aux
