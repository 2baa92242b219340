"""Edge softmax and fused GAT attention (port of
``repro/core/edge_softmax.py``).

* :func:`edge_softmax` — GAT's 5-primitive BR chain (paper Table 2, row
  8): ``e_copy_max_v``, ``e_sub_v_copy_e``, exp, ``e_copy_add_v``,
  ``e_div_v_copy_e``, each through :func:`gspmm`.
* :func:`edge_softmax_fused` — the single-pass softmax over canonical
  order; on the card the edge-softmax kernel (B5).
* :func:`fused_attention` — the whole attention pipeline
  (``u_add_v_copy_e`` logits, leaky-relu, edge softmax and the
  ``u_mul_e_add_v`` aggregation) as ONE pass; per-edge α is never
  materialized.

Strategies of the two single-pass forms (``ATTN_STRATEGIES``):
``"fused"`` is the plain PyTorch version in canonical order,
``"kernel"`` (JAX's ``"pallas"``, which names it here too) the CUDA
kernel (B5 / B2). Under ``"auto"`` :func:`fused_attention` asks the
planner (``planner.plan_attention``, logged ``attn:fused``: JAX's cost
rows, the kernel priced on the graph's row-complete ragged slot count),
and a pinned ``"kernel"`` on operands B2 does not take falls back to
``"fused"`` with a one-time warning; :func:`edge_softmax_fused`, which
JAX does not plan, takes the kernel for fp32 CUDA tensors. The composed
:func:`edge_softmax` hands its strategy to each of its five ops, as JAX
does, so its node-output reductions go through gspmm's planner.

Gradients. The composed chain differentiates through its ops (the kernel
routes' backwards of ``core/binary_reduce.py``; the max stays on the
segment route's autograd, as in JAX, with no stop-gradient: the shift
cancels in the softmax). The plain single-pass forms differentiate by
autograd. The kernel routes are ``torch.autograd.Function``s:
``edge_softmax_fused``'s B5 route has ∂logits = α ⊙ (ct − Σ_row α·ct)
with the row sums on B4 and the broadcast subtract on B3;
``fused_attention``'s B2 route recomputes α on the canonical stream and
runs :func:`_attention_grads` (the JAX adjoint, plain torch) — or, when
the graph's pack cache already holds its row-complete ragged ELL pack
(``planner.get_plan_cache(g).ell_ragged()``, never built here),
:func:`_attention_grads_ragged`, the adjoint recomputed per degree class
on that pack, as the JAX package's TPU route does.

The block forms run the same operators on one sampled block
(:class:`~repro_torch.core.blocks.BlockGraph`): :func:`block_edge_softmax`
composes the chain on ``bg.g`` (B3 and B4 on the card, the max on the
uniform pull), its two node-output reductions differentiated as
``bwd_strategy`` says (the block VJP of ``core/blocks.py``: the max by
its arg-extremum table under ``gather``); :func:`block_fused_attention`
runs the fused pipeline on ``bg.g`` (B2), differentiates through
``_FusedAttentionKernel`` there, and slices off the dummy row. The
partitioned variant comes with A12 (ROADMAP A).
"""
from __future__ import annotations

import torch

from ..kernels.binary_reduce.ops import binary_reduce_csr
from ..kernels.edge_softmax.ops import (attention_alpha, edge_softmax_csr,
                                        edge_softmax_plain,
                                        fused_attention_csr,
                                        fused_attention_plain)
from ..kernels.sddmm.ops import sddmm_csr
from . import planner
from .binary_reduce import (_kernel_name, _needs_grad, _timed_eager, gsddmm,
                            gspmm)
from .blocks import (SDDMM_FOR_BLOCK, BlockGraph, block_gspmm,
                     check_block_strategy)
from .planner import get_plan_cache

__all__ = ["edge_softmax", "edge_softmax_fused", "fused_attention",
           "block_edge_softmax", "block_fused_attention", "ATTN_STRATEGIES"]

ATTN_STRATEGIES = ("auto", "fused", "kernel")


def _single_pass(strategy: str, x: torch.Tensor) -> str:
    """Resolve :func:`edge_softmax_fused`'s strategy for tensor ``x``."""
    strategy = _kernel_name(strategy)
    if strategy not in ATTN_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{ATTN_STRATEGIES}")
    if strategy == "auto":      # B5 takes fp32 only
        return ("kernel" if x.device.type == "cuda"
                and x.dtype == torch.float32 else "fused")
    return strategy


def edge_softmax(g, logits: torch.Tensor,
                 strategy: str = "auto") -> torch.Tensor:
    """Softmax over incoming edges of each destination node, composed from
    the five primitives the paper profiles.

    ``logits``: (n_edges, H) in the caller's edge order; returns the same
    shape and order ((n_edges, 1) for 1-D logits, as in JAX).
    ``strategy`` goes to each op; no kernel computes the max, so a pinned
    ``'kernel'`` falls back there as the planner's chain says.
    """
    maxv = gspmm(g, "e_copy_max_v", e=logits, strategy=strategy)
    # a zero-in-degree node's max is the reduce identity on any strategy
    # that skips the degree finalize — never let it reach the subtract
    maxv = torch.where(torch.isfinite(maxv), maxv,
                       torch.zeros((), dtype=maxv.dtype, device=maxv.device))
    shifted = gspmm(g, "e_sub_v_copy_e", e=logits, v=maxv, strategy=strategy)
    ex = torch.exp(shifted)
    z = gspmm(g, "e_copy_add_v", e=ex, strategy=strategy)
    return gspmm(g, "e_div_v_copy_e", e=ex, v=z, strategy=strategy)


def block_edge_softmax(bg: BlockGraph, logits: torch.Tensor,
                       strategy: str = "auto",
                       bwd_strategy: str = "auto") -> torch.Tensor:
    """Edge softmax over one sampled block's real in-edges.

    The chain of :func:`edge_softmax` on ``bg.g``: the two node-output
    reductions go through :func:`~repro_torch.core.blocks.block_gspmm`
    (the block planner's choice, or the pinned route: B4 for the sum
    under 'kernel', the max falling back to the uniform pull), the shift
    and divide through gSDDMM (B3). Pad edges live in the dummy
    destination row, so real rows see exactly their real edges; the
    dummy row's sum is set to 1 so pad edges divide by a finite value.
    ``bwd_strategy`` goes to both reductions (``block_gspmm``).
    """
    check_block_strategy(strategy)
    x = logits[:, None] if logits.ndim == 1 else logits
    sddmm = SDDMM_FOR_BLOCK[strategy]
    pad = x.new_zeros((1,) + tuple(x.shape[1:]))
    maxv = block_gspmm(bg, "e_copy_max_v", e=x, strategy=strategy,
                       bwd_strategy=bwd_strategy)
    shifted = gsddmm(bg.g, "e_sub_v_copy_e", e=x,
                     v=torch.cat([maxv, pad], dim=0), strategy=sddmm)
    ex = torch.exp(shifted)
    z = block_gspmm(bg, "e_copy_add_v", e=ex, strategy=strategy,
                    bwd_strategy=bwd_strategy)
    # dummy row gets z = 1 so pad edges divide by a finite value; every
    # real edge's destination has >= 1 real edge, so z > 0 on real rows
    zp = torch.cat([z, torch.ones_like(pad)], dim=0)
    out = gsddmm(bg.g, "e_div_v_copy_e", e=ex, v=zp, strategy=sddmm)
    return out[:, 0] if logits.ndim == 1 else out


def edge_softmax_fused(g, logits: torch.Tensor,
                       strategy: str = "auto") -> torch.Tensor:
    """Single-pass edge softmax: ``logits`` (n_edges, H) or (n_edges,) in
    caller edge order → α of the same shape and order. 'fused' is the
    canonical-order PyTorch form (``edge_softmax_plain``), 'kernel' the
    B5 kernel, 'auto' the kernel for fp32 CUDA tensors."""
    x = logits[:, None] if logits.ndim == 1 else logits
    if _single_pass(strategy, x) == "kernel":
        out = (_EdgeSoftmaxKernel.apply(g, x) if _needs_grad(x)
               else edge_softmax_csr(g, x.contiguous()))
    else:
        out = edge_softmax_plain(g, x)
    return out[:, 0] if logits.ndim == 1 else out


def fused_attention(g, el: torch.Tensor, er: torch.Tensor, z: torch.Tensor,
                    *, negative_slope: float = 0.2,
                    strategy: str = "auto") -> torch.Tensor:
    """``el``: (n_src, H) or (n_src,) source logit terms; ``er``: (n_dst,
    H) destination terms; ``z``: (n_src, H, F) source features ((n_src, F)
    when ``el`` is 1-D). Returns (n_dst, H, F) aggregated features;
    zero-degree rows are 0."""
    squeeze = el.ndim == 1
    if squeeze:
        el, er, z = el[:, None], er[:, None], z[:, None, :]
    strategy = _kernel_name(strategy)
    stats = get_plan_cache(g).stats
    chosen = planner.plan_attention(
        (g.n_src, g.n_dst, g.n_edges), el.shape[-1], z.shape[-1],
        requested=strategy,
        kernel_ok=all(t.dtype == torch.float32 for t in (el, er, z)),
        padded_slots=stats.ragged_padded_slots if g.n_edges else None,
        dtype=z.dtype, device=planner.device_of(z))
    if chosen == "ring":
        raise NotImplementedError("strategy='ring' is the partitioned "
                                  "attention: ROADMAP A12")
    slope = float(negative_slope)

    def run():
        if chosen == "fused":
            return fused_attention_plain(g, el, er, z, slope)
        if _needs_grad(el, er, z):
            return _FusedAttentionKernel.apply(g, slope, el, er, z)
        return fused_attention_csr(g, el.contiguous(), er.contiguous(),
                                   z.contiguous(), slope)

    out = _timed_eager("attn:fused", run)
    return out[:, 0, :] if squeeze else out


def block_fused_attention(bg: BlockGraph, el: torch.Tensor,
                          er: torch.Tensor, z: torch.Tensor, *,
                          negative_slope: float = 0.2,
                          strategy: str = "auto") -> torch.Tensor:
    """Fused attention over one sampled block's real in-edges.

    ``er`` spans the padded destination range (n_dst_real + 1 rows, the
    caller's dummy row last). Pad edges all point at the dummy row, so
    real rows' softmax sees exactly their real edges; the dummy row is
    sliced off. Returns (n_dst_real, H, F) ((n_dst_real, F) for 1-D
    ``el``).
    """
    out = fused_attention(bg.g, el, er, z, negative_slope=negative_slope,
                          strategy=strategy)
    return out[: bg.n_dst_real]


# --------------------------------------------------------------------- #
# the single-pass kernel routes' backward
# --------------------------------------------------------------------- #
class _EdgeSoftmaxKernel(torch.autograd.Function):
    """B5 forward; ∂logits = α ⊙ (ct − Σ_row α·ct) on B4 and B3."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        alpha = edge_softmax_csr(g, x.detach().contiguous())
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, ct):
        alpha, = ctx.saved_tensors
        ct = ct.contiguous()
        row = binary_reduce_csr(ctx.g, None, (alpha * ct).contiguous(),
                                "copy_rhs")
        return None, alpha * sddmm_csr(ctx.g, "sub", "e", ct, "v", row)


def _attention_grads(g, el, er, z, slope: float, ct, needs):
    """Adjoints of the fused pipeline (port of
    ``repro/core/edge_softmax.py:130``): α recomputed on the canonical
    stream, source-side sums by ``index_add_``; only the grads ``needs``
    asks for (el, er, z)."""
    alpha, m_raw = attention_alpha(g, el, er, slope)
    src, dst = g.long("src"), g.long("dst")
    ct_e = ct.index_select(0, dst)                       # (E, H, F)
    d_el = d_er = dz = None
    if needs[2]:
        dz = torch.zeros_like(z).index_add_(0, src, alpha[..., None] * ct_e)
    if needs[0] or needs[1]:
        g_alpha = (ct_e * z.index_select(0, src)).sum(dim=-1)   # (E, H)
        s_dot = torch.zeros_like(er).index_add_(0, dst, alpha * g_alpha)
        # softmax adjoint, then the leaky-relu mask (>= as in substrate)
        g_m = alpha * (g_alpha - s_dot.index_select(0, dst))
        g_m = g_m * torch.where(m_raw >= 0, 1.0, slope).to(g_m.dtype)
        if needs[0]:
            d_el = torch.zeros_like(el).index_add_(0, src, g_m)
        if needs[1]:
            d_er = torch.zeros_like(er).index_add_(0, dst, g_m)
    return d_el, d_er, dz


def _attention_grads_ragged(pack, el, er, z, slope: float, ct, needs):
    """Adjoints of the fused pipeline recomputed on the row-complete
    ragged ELL pack (port of ``repro/core/edge_softmax.py:160``): per
    degree class a masked max / sum over the width axis replaces the
    segment-reduce chain. Pad slots carry α = 0 exactly (masked exp), so
    the source-side sums index ``chunk_cols`` directly — pads add zeros —
    and ∂z and ∂el ride one ``index_add`` with an (H, F+1) payload. Rows
    are disjoint across classes, so ∂er is a row update. Only the grads
    ``needs`` asks for (el, er, z) come back."""
    F = z.shape[-1]
    acc = z.new_zeros(tuple(z.shape[:-1]) + (F + 1,),
                      dtype=torch.promote_types(z.dtype, ct.dtype))
    d_er = torch.zeros_like(er)
    for cls in pack.classes:
        cols, row = cls.long("chunk_cols"), cls.long("chunk_row")
        C, W = cols.shape
        el_t = el.index_select(0, cols.reshape(-1)).reshape(C, W, -1)
        m_raw = el_t + er.index_select(0, row)[:, None]       # (C, W, H)
        m = torch.where(m_raw >= 0, m_raw, slope * m_raw)
        mk = cls.chunk_mask[..., None]
        mx = torch.where(mk, m, m.new_full((), -float("inf"))).amax(
            1, keepdim=True)
        mx = torch.where(torch.isfinite(mx), mx, mx.new_zeros(()))
        ex = torch.where(mk, torch.exp(m - mx), m.new_zeros(()))
        alpha = ex / ex.sum(1, keepdim=True).clamp(min=1e-38)
        ct_t = ct.index_select(0, row)                         # (C, H, F)
        z_t = z.index_select(0, cols.reshape(-1)).reshape(
            (C, W) + tuple(z.shape[1:]))                       # (C, W, H, F)
        g_alpha = torch.einsum("chf,cwhf->cwh", ct_t, z_t)
        s_dot = (alpha * g_alpha).sum(1, keepdim=True)
        g_m = alpha * (g_alpha - s_dot)
        g_m = g_m * torch.where(m_raw >= 0, 1.0, slope).to(g_m.dtype)
        d_er = d_er.index_add(0, row, g_m.sum(1).to(er.dtype))
        payload = torch.cat([alpha[..., None] * ct_t[:, None],
                             g_m[..., None]], dim=-1)
        acc = acc.index_add(0, cols.reshape(-1), payload.reshape(
            (C * W,) + tuple(payload.shape[2:])).to(acc.dtype))
    return (acc[..., F].to(el.dtype) if needs[0] else None,
            d_er if needs[1] else None,
            acc[..., :F].to(z.dtype) if needs[2] else None)


class _FusedAttentionKernel(torch.autograd.Function):
    """B2 forward; backward :func:`_attention_grads_ragged` when the
    graph's ragged pack is built, else :func:`_attention_grads` (plain
    torch: the JAX package has no backward kernel, ROADMAP queue B's
    leads). The backward only reads the pack cache."""

    @staticmethod
    def forward(ctx, g, slope, el, er, z):
        ctx.g, ctx.slope = g, slope
        ctx.save_for_backward(el, er, z)
        return fused_attention_csr(g, el.detach().contiguous(),
                                   er.detach().contiguous(),
                                   z.detach().contiguous(), slope)

    @staticmethod
    def backward(ctx, ct):
        el, er, z = (t.detach() for t in ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        pack = get_plan_cache(ctx.g).peek("ell_ragged")
        if pack is not None:
            return (None, None) + _attention_grads_ragged(
                pack, el, er, z, ctx.slope, ct, needs)
        return (None, None) + _attention_grads(ctx.g, el, er, z, ctx.slope,
                                               ct, needs)
