"""GAT, full-graph forward (port of ``repro/models/gnn/gat.py``) — the
paper's heaviest BR user (Table 2, row 8).

Each layer projects ``z = h @ w`` into (H, F) heads and forms the source
and destination logit terms ``el`` / ``er``. ``attn`` selects how much of
the attention pipeline fuses, with the JAX package's modes:

    'multipass'     — ``u_add_v_copy_e`` logits on gSDDMM (kernel B3),
                      leaky-relu, the composed 5-primitive edge softmax
                      (B3 and B4 on the card, the max on a plain route),
                      then ``u_mul_e_add_v`` with per-head α (rank 3, so
                      no kernel takes it) — the paper's layering;
    'softmax-fused' — the same, with the single-pass edge softmax (B5);
    'fused'/'pallas'/'auto'
                    — the whole pipeline as ONE pass,
                      :func:`repro_torch.core.fused_attention` (B2):
                      'fused' its plain version, 'pallas' the kernel,
                      'auto' the planner's choice.

``attn=None`` means 'multipass' (or 'softmax-fused' under the older
``fused_softmax=True``), as in JAX; it is what ``infer``, the serving
tier and training run. ``train=True`` drops out each layer's input (rate
0.4 by default, as in JAX); every kernel route differentiates through
its own backward (``core/binary_reduce.py``, ``core/edge_softmax.py``).
Every op takes ``strategy`` as JAX's GAT hands it on: ``'auto'`` the
planner's choice per op, ``'segment'`` the plain versions everywhere,
``'kernel'`` the kernels for every op a kernel covers (the max and the
rank-3 sum fall back down the planner's chain, with a warning).

On a sampled block (:func:`block_layer`, :func:`forward_blocks`) the
same modes run on the block graph ``bg.g``: multipass as B3 logits, the
block edge softmax (B3 + B4, its max on a plain route) and the rank-3
aggregation on a plain route; softmax-fused with B5 on ``bg.g`` (pad
edges get the dummy row's own softmax, which no real row reads); the
fused modes as B2. ``strategy='ell'`` pins the JAX block path's plain
pulls, ``'push'`` its scatter baseline for the node reductions. Sampled
training differentiates the block ops as ``bwd_strategy`` says
(``core/blocks.py``): the max and the rank-3 sum as the block planner
says, the rest on the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...core.binary_reduce import SDDMM_FOR, gsddmm, gspmm
from ...core.blocks import (SDDMM_FOR_BLOCK, block_gspmm,
                            check_block_strategy)
from ...core.edge_softmax import (block_edge_softmax, block_fused_attention,
                                  edge_softmax, edge_softmax_fused,
                                  fused_attention)
from ...device import DeviceLike
from ...substrate.nn import (dropout, from_numpy, glorot, leaky_relu,
                              matmul)
from .common import GraphBundle, run_blocks

__all__ = ["GAT", "GATLayer", "init", "forward", "infer", "block_layer",
           "forward_blocks", "infer_blocks"]

_ATTN_MODES = ("multipass", "softmax-fused", "fused", "pallas", "auto")
_STRATEGIES = ("auto", "segment", "kernel")
# strategy of the single-pass forms (fused attention, fused softmax) for
# each model strategy; 'auto' fused attention keeps its attn name below
_SINGLE_PASS = {"segment": "fused", "kernel": "kernel", "auto": "auto"}
_FUSED_STRATEGY = {"auto": "auto", "fused": "fused", "pallas": "kernel"}
# on a block: the single-pass forms under each block strategy
_BLOCK_SINGLE_PASS = dict(_SINGLE_PASS, ell="fused", push="fused")


def _resolve_attn(attn: Optional[str], fused_softmax: bool) -> str:
    """Back-compat: ``fused_softmax`` predates ``attn`` and keeps its
    meaning when ``attn`` is not given."""
    if attn is None:
        return "softmax-fused" if fused_softmax else "multipass"
    if attn not in _ATTN_MODES:
        raise ValueError(f"unknown attn mode {attn!r}; expected one of "
                         f"{_ATTN_MODES}")
    return attn


class GATLayer(nn.Module):
    """``w`` (d_in, H·F), ``attn_l`` / ``attn_r`` (H, F) — JAX's layout."""

    def __init__(self, w: torch.Tensor, attn_l: torch.Tensor,
                 attn_r: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.attn_l = nn.Parameter(attn_l)
        self.attn_r = nn.Parameter(attn_r)

    def forward(self, bundle: GraphBundle, h: torch.Tensor, *,
                strategy: str, attn: str) -> torch.Tensor:
        g = bundle.g
        heads, out = self.attn_l.shape
        z = matmul(h, self.w).reshape(-1, heads, out)      # (n, H, F)
        el = (z * self.attn_l).sum(dim=-1)                 # (n, H)
        er = (z * self.attn_r).sum(dim=-1)
        if attn in _FUSED_STRATEGY:
            how = (_FUSED_STRATEGY[attn] if strategy == "auto"
                   else _SINGLE_PASS[strategy])
            out_feat = fused_attention(g, el, er, z, strategy=how)
            return out_feat.reshape(-1, heads * out)
        logits = gsddmm(g, "u_add_v_copy_e", u=el, v=er,
                        strategy=SDDMM_FOR[strategy])
        logits = leaky_relu(logits)
        if attn == "softmax-fused":
            alpha = edge_softmax_fused(g, logits,
                                       strategy=_SINGLE_PASS[strategy])
        else:
            alpha = edge_softmax(g, logits, strategy=strategy)  # (E, H)
        # u_mul_e_add_v with per-head scalar α is a rank-3 broadcast: no
        # kernel takes it, so the planner runs it on a plain route
        out_feat = gspmm(g, "u_mul_e_add_v", u=z, e=alpha[:, :, None],
                         strategy=strategy)
        return out_feat.reshape(-1, heads * out)


class GAT(nn.Module):
    """Stack of attention layers, elu between layers."""

    def __init__(self, layers: Sequence[GATLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "GAT":
        return cls([GATLayer(*(from_numpy(p[k], device)
                                for k in ("w", "attn_l", "attn_r")))
                    for p in tree["layers"]])

    def forward(self, bundle: GraphBundle, x: torch.Tensor, *,
                strategy: str = "auto", attn: Optional[str] = None,
                fused_softmax: bool = False, train: bool = False,
                gen: Optional[torch.Generator] = None,
                drop: float = 0.4) -> torch.Tensor:
        attn = _resolve_attn(attn, fused_softmax)
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; expected one "
                             f"of {_STRATEGIES}")
        h = x
        for i, lyr in enumerate(self.layers):
            if train and gen is not None:
                h = dropout(gen, h, drop, train)
            h = lyr(bundle, h, strategy=strategy, attn=attn)
            if i < len(self.layers) - 1:
                h = F.elu(h)
        return h


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int,
         n_heads: int = 4, n_layers: int = 2,
         device: DeviceLike = "cuda") -> GAT:
    layers = []
    d = d_in
    for i in range(n_layers):
        out = n_classes if i == n_layers - 1 else d_hidden
        heads = 1 if i == n_layers - 1 else n_heads
        layers.append(GATLayer(glorot(gen, (d, heads * out), device),
                               glorot(gen, (heads, out), device),
                               glorot(gen, (heads, out), device)))
        d = heads * out
    return GAT(layers)


def forward(model: GAT, bundle: GraphBundle, x: torch.Tensor, *,
            strategy: str = "auto", train: bool = False,
            gen: Optional[torch.Generator] = None, drop: float = 0.4,
            fused_softmax: bool = False,
            attn: Optional[str] = None) -> torch.Tensor:
    """Full-graph forward; with ``train`` and a generator ``gen`` on the
    graph's device, dropout at rate ``drop`` before each layer."""
    return model(bundle, x, strategy=strategy, attn=attn,
                 fused_softmax=fused_softmax, train=train, gen=gen,
                 drop=drop)


def infer(model: GAT, bundle: GraphBundle, x: torch.Tensor, *,
          strategy: str = "auto",
          attn: Optional[str] = None) -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    entry point (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, bundle, x, strategy=strategy, attn=attn)


def block_layer(lyr: GATLayer, blk, h: torch.Tensor, *,
                strategy: str = "auto", bwd_strategy: str = "auto",
                attn: str = "multipass") -> torch.Tensor:
    """One GAT layer on a sampled block.

    Logits are per sampled edge; the destination term uses
    ``z[:n_dst_real]`` (dst-first numbering) padded with one zero dummy
    row, and the softmax normalizes over each destination's REAL
    in-edges only (pads live in the dummy row)."""
    bg = blk.bg
    nd = bg.n_dst_real
    heads, out = lyr.attn_l.shape
    z = matmul(h, lyr.w).reshape(-1, heads, out)         # (n_src_pad, H, F)
    el = (z * lyr.attn_l).sum(dim=-1)                    # (n_src_pad, H)
    er = (z[:nd] * lyr.attn_r).sum(dim=-1)
    er = torch.cat([er, er.new_zeros((1, heads))], dim=0)
    if attn in _FUSED_STRATEGY:
        how = (_FUSED_STRATEGY[attn] if strategy == "auto"
               else _BLOCK_SINGLE_PASS[strategy])
        out_feat = block_fused_attention(bg, el, er, z, strategy=how)
        return out_feat.reshape(nd, heads * out)
    logits = gsddmm(bg.g, "u_add_v_copy_e", u=el, v=er,
                    strategy=SDDMM_FOR_BLOCK[strategy])
    logits = leaky_relu(logits)
    if attn == "softmax-fused":
        alpha = edge_softmax_fused(bg.g, logits,
                                   strategy=_BLOCK_SINGLE_PASS[strategy])
    else:
        alpha = block_edge_softmax(bg, logits, strategy=strategy,
                                   bwd_strategy=bwd_strategy)
    out_feat = block_gspmm(bg, "u_mul_e_add_v", u=z, e=alpha[:, :, None],
                           strategy=strategy,
                           bwd_strategy=bwd_strategy)        # (nd, H, F)
    return out_feat.reshape(nd, heads * out)


def forward_blocks(model: GAT, blocks, x: torch.Tensor, *,
                   strategy: str = "auto", bwd_strategy: str = "auto",
                   train: bool = False,
                   gen: Optional[torch.Generator] = None, drop: float = 0.4,
                   attn: Optional[str] = None) -> torch.Tensor:
    """Sampled mini-batch forward on the shared block path; ``attn=None``
    is multipass, as in JAX. ``strategy``: one of
    :data:`~repro_torch.core.blocks.BLOCK_STRATEGIES`; ``bwd_strategy``:
    the block VJP (``core/blocks.py``). With ``train`` and a generator
    ``gen`` on the features' device, dropout at rate ``drop`` before each
    layer."""
    attn = _resolve_attn(attn, False)
    check_block_strategy(strategy)

    def layer(lyr, blk, h, **kw):
        return block_layer(lyr, blk, h, attn=attn, **kw)

    return run_blocks(layer, model.layers, blocks, x, strategy=strategy,
                      bwd_strategy=bwd_strategy, activation=F.elu,
                      train=train, gen=gen, drop=drop)


def infer_blocks(model: GAT, blocks, x: torch.Tensor, *,
                 strategy: str = "auto",
                 attn: Optional[str] = None) -> torch.Tensor:
    """Inference-mode block forward — the serving tier's fan-out path.
    Defaults to the same multipass family as the full forward, so the
    two serve modes agree to float tolerance."""
    with torch.no_grad():
        return forward_blocks(model, blocks, x, strategy=strategy,
                              attn=attn)
