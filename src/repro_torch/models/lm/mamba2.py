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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import normal

__all__ = ["Mamba2", "mamba2_init", "ssd_chunked", "mamba2_apply"]


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


def mamba2_apply(p: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                 state: Optional[Dict] = None) -> torch.Tensor:
    """u: (B, S, D). With ``state`` (a decode cache entry) the state is
    carried in: chunked with h0 for S > 1 (prefill), the O(1) recurrence
    for S == 1; either way it is overwritten with the new state."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, x, Bmat, Cmat, dt = _split_proj(cfg, matmul(u, p.in_proj))

    conv_in = torch.cat([x, Bmat, Cmat], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p.conv_w, p.conv_b,
        state["conv"] if state is not None else None)
    x = conv_out[..., :di]
    Bmat = conv_out[..., di:di + N]
    Cmat = conv_out[..., di + N:]

    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p.dt_bias,
                         torch.zeros((), device=u.device))
    A = -torch.exp(p.A_log)                                    # (H,)
    xh = x.reshape(*x.shape[:2], H, P)

    if state is None:
        y, _ = ssd_chunked(xh, dt, A, Bmat, Cmat, cfg.ssm_chunk)
    elif u.shape[1] > 1:
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
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(h_last)

    y = y + xh.float() * p.skip_D[:, None]
    y = y.reshape(*u.shape[:2], di).to(u.dtype)
    y = y * F.silu(z)
    return matmul(y, p.out_proj)
