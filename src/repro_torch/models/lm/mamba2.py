"""Mamba2 block — SSD, chunked matmul form (port of
``repro/models/lm/mamba2.py``; Dao & Gu 2024, arXiv:2405.21060).

The selective SSM
    h_t = exp(Δ_t a) h_{t-1} + Δ_t B_t x_tᵀ        (per head, state N)
    y_t = C_tᵀ h_t + D x_t
runs chunk-parallel: within chunks of Q tokens as dense products, across
chunks a short loop carries the (H, P, N) state. Decode is the O(1)
recurrence.

Layout: x (B, S, d_inner) viewed as (B, S, H, P) with P = ssm_head_dim;
B / C are shared across heads (one group). A decode state
{"conv": (B, K-1, di+2N), "ssm": (B, H, P, N)} is updated IN PLACE.

Over a process mesh :func:`mamba2_split` runs the rank's share under the
model axis's split (``tp.Split.mixer`` / ``conv``): its heads (``z`` /
``dt`` columns of ``in_proj``, the SSM, ``out_proj``'s rows), in a train
or prefill call the conv of its heads' ``x`` channels and of all of
``B`` / ``C``, in a decode the conv of its chunk of the ``[x | B | C]``
channels; on its shards of the state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.transport import (copy_to_group, gather_along, gather_blocks,
                               take_block)
from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import normal

__all__ = ["Mamba2", "mamba2_init", "ssd_chunked", "mamba2_apply",
           "mamba2_split"]


class Mamba2(nn.Module):
    """``in_proj`` (D, 2·di + 2N + H), ``conv_w`` (K, di + 2N),
    ``conv_b``, ``A_log`` / ``dt_bias`` / ``skip_D`` (H,) float32,
    ``out_proj`` (di, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = torch.float32
        self.in_proj = normal(gen, (D, 2 * di + 2 * N + H), D ** -0.5,
                              dtype, device)
        self.conv_w = normal(gen, (cfg.ssm_conv, di + 2 * N), 0.1, dtype,
                             device)
        self.conv_b = nn.Parameter(torch.zeros(di + 2 * N, dtype=dtype,
                                               device=device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=f32, device=device)))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=f32, device=device))
        self.skip_D = nn.Parameter(torch.ones(H, dtype=f32, device=device))
        self.out_proj = normal(gen, (di, D), di ** -0.5, dtype, device)


def mamba2_init(cfg: ModelConfig, dtype, device, gen) -> Mamba2:
    return Mamba2(cfg, dtype, device, gen)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    Bmat = zxbcdt[..., 2 * di:2 * di + N]
    Cmat = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, x, Bmat, Cmat, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv by explicit shifts (width K small).

    x: (B, S, C); w: (K, C). Returns (silu(y), new state): the state is
    the last K-1 INPUTS (after the carried state), not outputs."""
    K = w.shape[0]
    if state is not None:
        x = torch.cat([state.to(x.dtype), x], dim=1)
    S_out = x.shape[1] - (K - 1) if state is not None else x.shape[1]
    taps = []
    for k in range(K):
        if state is not None:
            xs = x[:, k:k + S_out]
        else:
            shift = K - 1 - k
            xs = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        taps.append(xs * w[k])
    y = sum(taps) + b
    new_state = x[:, -(K - 1):] if K > 1 else None
    return F.silu(y), new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, Q: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bmat / Cmat: (B, S, N). Returns (y (B, S, H, P), final state
    (B, H, P, N))."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bmat.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cmat.reshape(Bsz, nc, Q, N).to(f32)

    dA = dtc * A                                    # (B, nc, Q, H) negative
    cs = torch.cumsum(dA, dim=2)                    # within-chunk cumsum
    # intra-chunk: L[q,t] = exp(cs_q - cs_t) for q >= t. Mask the EXPONENT
    # (not the value): masked slots are exp(-inf) = 0 with zero gradient,
    # where exp-then-mask gives inf·0 = NaN in the backward pass.
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = torch.where(tri[None, None, :, :, None], diff, float("-inf"))
    Lmat = torch.exp(diff)
    # scores[b,c,q,t,h] = C_q·B_t L[q,t] dt_t
    CB = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)
    M = CB[..., None] * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", M, xc)

    # chunk summaries: S_c = Σ_t exp(cs_end - cs_t) dt_t B_t x_tᵀ
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)           # (B,nc,Q,H)
    weighted_x = xc * (dtc * decay_to_end)[..., None]
    S_chunk = torch.einsum("bctn,bcthp->bchpn", Bc, weighted_x)
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (B,nc,H)

    # inter-chunk state scan; chunk c reads the state BEFORE it
    h = (h0.to(f32) if h0 is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                      # (B,nc,H,P,N)

    # inter-chunk contribution: y_t += C_t exp(cs_t) h_prev
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs)
               * torch.exp(cs)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, h


def _ssm(cfg: ModelConfig, x: torch.Tensor, Bmat: torch.Tensor,
         Cmat: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
         dt_bias: torch.Tensor, skip_D: torch.Tensor,
         state: Optional[Dict]) -> torch.Tensor:
    """The SSM of the heads ``x`` (B, S, H·P) holds (H = ``A_log``'s
    length; ``dt`` (B, S, H) before the softplus), with the skip term:
    (B, S, H·P) in ``x``'s dtype. With ``state`` its ``ssm`` entry
    (B, H, P, N) is carried in and overwritten: chunked with h0 for
    S > 1 (prefill), the O(1) recurrence for S == 1."""
    P = cfg.ssm_head_dim
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + dt_bias,
                         torch.zeros((), device=x.device))
    A = -torch.exp(A_log)                                      # (H,)
    xh = x.reshape(*x.shape[:2], -1, P)

    if state is None:
        y, _ = ssd_chunked(xh, dt, A, Bmat, Cmat, cfg.ssm_chunk)
    elif x.shape[1] > 1:
        y, h_last = ssd_chunked(xh, dt, A, Bmat, Cmat, cfg.ssm_chunk,
                                h0=state["ssm"])
    else:
        # O(1) decode recurrence (S == 1)
        h = state["ssm"].float()                               # (B,H,P,N)
        dA = torch.exp(dt[:, 0, :] * A)                        # (B,H)
        Bx = torch.einsum("bn,bhp->bhpn", Bmat[:, 0].float(),
                          xh[:, 0].float() * dt[:, 0][..., None])
        h_last = h * dA[:, :, None, None] + Bx
        y = torch.einsum("bn,bhpn->bhp", Cmat[:, 0].float(), h_last)[:, None]
    if state is not None:
        state["ssm"].copy_(h_last)
    y = y + xh.float() * skip_D[:, None]
    return y.reshape(x.shape).to(x.dtype)


def mamba2_apply(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                 state: Optional[Dict] = None) -> torch.Tensor:
    """u: (B, S, D). With ``state`` (a decode cache entry) the state is
    carried in: chunked with h0 for S > 1 (prefill), the O(1) recurrence
    for S == 1; either way it is overwritten with the new state."""
    di, N = cfg.d_inner, cfg.ssm_state
    z, x, Bmat, Cmat, dt = _split_proj(cfg, matmul(u, p.in_proj))

    conv_in = torch.cat([x, Bmat, Cmat], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p.conv_w, p.conv_b,
        state["conv"] if state is not None else None)
    y = _ssm(cfg, conv_out[..., :di], conv_out[..., di:di + N],
             conv_out[..., di + N:], dt, p.A_log, p.dt_bias, p.skip_D, state)
    if state is not None:
        state["conv"].copy_(new_conv)
    y = y.to(u.dtype) * F.silu(z)
    return matmul(y, p.out_proj)


def _conv_tail(u: torch.Tensor, w: torch.Tensor, K: int) -> torch.Tensor:
    """The conv state an empty cache holds after the prompt ``u``: the
    last ``K - 1`` conv inputs ``u @ w`` (zeros before the prompt, as
    :func:`_causal_conv` pads)."""
    tail = matmul(u[:, -(K - 1):], w)
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def mamba2_split(p: Mamba2, cfg: ModelConfig, u: torch.Tensor, split,
                 state: Optional[Dict] = None) -> torch.Tensor:
    """The rank's share of the mixer under ``split`` (a ``tp.Split``;
    the ``tp`` module docstring): ``u`` and the output in the residual
    layout; ``state``: the rank's shards of the layer's ``conv`` / ``ssm``
    state, read and written in place.

    'heads': ``z``, ``dt`` and the SSM of the rank's heads, its partial
    ``out_proj`` product reduced. ``in_proj``'s stored shard, a chunk of
    the fused ``[z | x | B | C | dt]`` dim, holds neither the heads'
    columns nor the conv's: it comes whole and is sliced. The conv
    (``split.conv``): 'heads' (train, prefill) on the heads' ``x``
    channels and all of ``B`` / ``C``, with ``conv_w`` / ``conv_b`` whole
    (the gradients of the columns other ranks run arrive as zeros, summed
    over 'model' with the rest); no collective. A prefill starts at
    position 0 on an empty cache (JAX's ``prefill``, ``q_offset=0``; every
    caller zeroes it), so the conv reads no carried state, and it writes
    the rank's ``conv`` state chunk from the prompt's last inputs of those
    channels. 'chunk' (decode): the rank's channel chunk, which does not
    line up with the heads, with its ``conv`` state shard, its output
    gathered over 'model' (the SSM reads ``B`` / ``C`` of every channel);
    'whole': every channel. 'whole' mixer: the mixer whole on every
    'model' rank but the conv's chunk."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_c, K = di + 2 * N, cfg.ssm_conv
    heads = split.mixer == "heads"
    if heads:
        u = split.enter(u)
    elif split.sp:
        u = gather_blocks(u, split.group, 1)
    # in_proj's columns the rank uses for its own share (its heads, its
    # conv channels), and, in 'whole', those every rank uses alike
    own = split.part(p.in_proj)
    same = own if heads else p.in_proj
    h0, Hs = split.chunk(H) if heads else (0, H)
    z = matmul(u, same.narrow(1, h0 * P, Hs * P))
    dt = matmul(u, same.narrow(1, 2 * di + 2 * N + h0, Hs))
    conv_state = state["conv"] if state is not None else None
    # the conv's output: the x channels from column 0 to ``bc`` (the
    # rank's heads' from ``x0``), then B and C
    x0, bc = h0 * P, di
    if split.conv == "heads":
        def xbc(t, dim):    # the heads' x and all B / C of a fused leaf
            return torch.cat([t.narrow(dim, h0 * P, Hs * P),
                              t.narrow(dim, di, 2 * N)], dim)

        out, _ = _causal_conv(matmul(u, xbc(own.narrow(1, di, conv_c), 1)),
                              xbc(split.part(p.conv_w), 1),
                              xbc(split.part(p.conv_b), 0))
        x0, bc = 0, Hs * P
        if state is not None:
            c0, cn = split.chunk(conv_c)
            new_conv = _conv_tail(u, own.narrow(1, di + c0, cn), K)
    elif split.conv == "chunk":
        c0, cn = split.chunk(conv_c)
        xin = matmul(u if heads else copy_to_group(u, split.group),
                     own.narrow(1, di + c0, cn))
        out, new_conv = _causal_conv(xin, split.tp(p.conv_w, 1, conv_c),
                                     split.tp(p.conv_b, 0, conv_c),
                                     conv_state)
        out = (gather_along if heads else gather_blocks)(out, split.group,
                                                         -1)
    else:
        w = split.part if heads else (lambda t: t)
        out, new_conv = _causal_conv(matmul(u, same.narrow(1, di, conv_c)),
                                     w(p.conv_w), w(p.conv_b), conv_state)

    def hs(t):          # a per-head leaf's entries of the rank's heads
        return split.tp(t, 0, H) if heads else t

    y = _ssm(cfg, out[..., x0:x0 + Hs * P], out[..., bc:bc + N],
             out[..., bc + N:], dt, hs(p.A_log), hs(p.dt_bias),
             hs(p.skip_D), state)
    if state is not None:
        state["conv"].copy_(new_conv)
    y = y.to(u.dtype) * F.silu(z)
    if heads:
        return split.exit(matmul(y, split.tp(p.out_proj, 0, di)))
    y = matmul(y, p.out_proj)
    return take_block(y, split.group, 1) if split.sp else y
