"""GAT, full-graph forward (port of ``repro/models/gnn/gat.py``).

Each layer projects ``z = h @ w`` into (H, F) heads, forms the source and
destination logit terms ``el``/``er``, and runs the whole attention
pipeline (logits, leaky-relu, edge softmax, α-weighted aggregation) as
ONE pass through :func:`repro_torch.core.fused_attention` — the fused
attention kernel (B2) on the card.

``attn`` keeps the JAX package's modes. ``'fused'``, ``'pallas'`` and
``'auto'`` run the fused pipeline: 'fused' its plain PyTorch version,
'pallas' the kernel, 'auto' the kernel for CUDA tensors. The multipass
family (``None``, ``'multipass'``, ``'softmax-fused'``) needs gSDDMM and
the composed edge softmax and is queued. ``strategy='segment'`` pins the
plain versions everywhere, attention included.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...core.edge_softmax import fused_attention
from ...device import DeviceLike
from ...substrate.nn import from_numpy, glorot
from .common import GraphBundle

__all__ = ["GAT", "GATLayer", "init", "forward", "infer"]

_ATTN_MODES = ("multipass", "softmax-fused", "fused", "pallas", "auto")
_FUSED_STRATEGY = {"auto": "auto", "fused": "fused", "pallas": "kernel"}


class GATLayer(nn.Module):
    """``w`` (d_in, H·F), ``attn_l`` / ``attn_r`` (H, F) — JAX's layout."""

    def __init__(self, w: torch.Tensor, attn_l: torch.Tensor,
                 attn_r: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.attn_l = nn.Parameter(attn_l)
        self.attn_r = nn.Parameter(attn_r)

    def forward(self, bundle: GraphBundle, h: torch.Tensor,
                attention_strategy: str) -> torch.Tensor:
        heads, out = self.attn_l.shape
        z = (h @ self.w).reshape(-1, heads, out)           # (n, H, F)
        el = (z * self.attn_l).sum(dim=-1)                 # (n, H)
        er = (z * self.attn_r).sum(dim=-1)
        out_feat = fused_attention(bundle.g, el, er, z,
                                   strategy=attention_strategy)
        return out_feat.reshape(-1, heads * out)


def _attention_strategy(strategy: str, attn: Optional[str]) -> str:
    if attn is None or attn in ("multipass", "softmax-fused"):
        raise NotImplementedError(
            f"GAT attn={attn!r} (gSDDMM logits + composed edge softmax) is "
            f"not ported yet: ROADMAP A4 with kernels B3/B4; use "
            f"attn='auto', 'fused' or 'pallas'")
    if attn not in _ATTN_MODES:
        raise ValueError(f"unknown attn mode {attn!r}; expected one of "
                         f"{_ATTN_MODES}")
    if strategy == "segment":
        return "fused"
    if strategy == "kernel":
        return "kernel"
    if strategy != "auto":
        raise ValueError(f"unknown strategy {strategy!r}; expected 'auto', "
                         f"'segment' or 'kernel'")
    return _FUSED_STRATEGY[attn]


class GAT(nn.Module):
    """Stack of fused-attention layers, elu between layers."""

    def __init__(self, layers: Sequence[GATLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "GAT":
        return cls([GATLayer(*(from_numpy(p[k], device)
                                for k in ("w", "attn_l", "attn_r")))
                    for p in tree["layers"]])

    def forward(self, bundle: GraphBundle, x: torch.Tensor, *,
                strategy: str = "auto",
                attn: Optional[str] = "auto") -> torch.Tensor:
        how = _attention_strategy(strategy, attn)
        h = x
        for i, lyr in enumerate(self.layers):
            h = lyr(bundle, h, how)
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
            strategy: str = "auto",
            attn: Optional[str] = "auto") -> torch.Tensor:
    return model(bundle, x, strategy=strategy, attn=attn)


def infer(model: GAT, bundle: GraphBundle, x: torch.Tensor, *,
          strategy: str = "auto",
          attn: Optional[str] = "auto") -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    entry point (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, bundle, x, strategy=strategy, attn=attn)
