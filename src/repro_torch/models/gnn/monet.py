"""MoNet, the Gaussian mixture model conv (port of
``repro/models/gnn/monet.py``) — config ``u_mul_e_add_v`` (Table 2).

Edge pseudo-coordinates p_e = (1/√deg(u), 1/√deg(v)) (two B3 ``copy``
launches on the card); per mixture kernel k the edge weight is
w_k(e) = exp(-½ Σ_d (p_ed - μ_kd)² / σ²_kd). The K per-kernel
aggregations run as ONE fused pass over the bundle's K-relation
:class:`~repro_torch.core.hetero.RelGraph` (``make_bundle(g, krel=K)``):
per-kernel features are the 3-D ``u`` (n, K, d), the weights the
relation-concatenated ``e`` — B1 over the relation-expanded graph. A
bundle without that RelGraph runs the per-kernel loop of ``gspmm``
calls, as the JAX package's jitted step does without a prebuilt one;
it is also the differential reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...core.binary_reduce import gspmm
from ...core.hetero import hetero_gspmm, node_strategy
from ...device import DeviceLike
from ...substrate.nn import Linear, from_numpy, glorot
from .common import GraphBundle

__all__ = ["MoNet", "MoNetLayer", "init", "edge_pseudo_coords", "forward"]


class MoNetLayer(nn.Module):
    """``fc`` (no bias), ``mu`` (K, 2), ``inv_sigma`` (K, 2)."""

    def __init__(self, fc: Linear, mu: torch.Tensor,
                 inv_sigma: torch.Tensor):
        super().__init__()
        self.fc = fc
        self.mu = nn.Parameter(mu)
        self.inv_sigma = nn.Parameter(inv_sigma)


class MoNet(nn.Module):
    def __init__(self, layers: Sequence[MoNetLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda"
                   ) -> "MoNet":
        return cls([MoNetLayer(Linear.from_numpy(p["fc"], device),
                               from_numpy(p["mu"], device),
                               from_numpy(p["inv_sigma"], device))
                    for p in tree["layers"]])


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int,
         n_kernels: int = 3, n_layers: int = 2,
         device: DeviceLike = "cuda") -> MoNet:
    layers = []
    d = d_in
    for i in range(n_layers):
        out = n_classes if i == n_layers - 1 else d_hidden
        fc = Linear(glorot(gen, (d, out * n_kernels), device))
        dev = fc.w.device
        mu = (torch.randn(n_kernels, 2, generator=gen) * 0.1).to(dev)
        inv_sigma = (1.0 + torch.randn(n_kernels, 2, generator=gen)
                     * 0.01).to(dev)
        layers.append(MoNetLayer(fc, mu, inv_sigma))
        d = out
    return MoNet(layers)


def edge_pseudo_coords(bundle: GraphBundle,
                       strategy: str = "auto") -> torch.Tensor:
    """(n_edges, 2) pseudo-coords in caller edge order: each edge's
    source and destination value, by ``u_copy_add_e`` / ``v_copy_add_e``
    (B3 ``copy`` on the card)."""
    g = bundle.g
    du = 1.0 / torch.sqrt(g.out_degrees.float().clamp(min=1))
    dv = 1.0 / torch.sqrt(g.in_degrees.float().clamp(min=1))
    st = node_strategy(strategy)
    pu = gspmm(g, "u_copy_add_e", u=du[:, None], strategy=st)
    pv = gspmm(g, "v_copy_add_e", v=dv[:, None], strategy=st)
    return torch.cat([pu, pv], dim=-1)


def forward(model: MoNet, bundle: GraphBundle, x: torch.Tensor, *,
            strategy: str = "auto", train: bool = False,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    pseudo = edge_pseudo_coords(bundle, strategy)        # (nnz, 2)
    h = x
    n_layers = len(model.layers)
    for i, lyr in enumerate(model.layers):
        K = lyr.mu.shape[0]          # kernels encoded in param shapes
        z = lyr.fc(h)                                    # (n, K*out)
        out = z.shape[-1] // K
        z = z.reshape(-1, K, out)
        diff = pseudo[:, None, :] - lyr.mu               # (nnz, K, 2)
        logw = -0.5 * torch.sum((diff * lyr.inv_sigma) ** 2, dim=-1)
        w = torch.exp(logw)                              # (nnz, K)
        rg = bundle.krel(K)
        if rg is not None:
            # one fused pass over the K-relation graph: per-kernel
            # features index (src, kernel), per-kernel weights ride as
            # the relation-concatenated e operand
            acc = hetero_gspmm(rg, z, e=w.T.reshape(-1), strategy=strategy)
        else:
            acc = 0.0
            for k in range(K):
                acc = acc + gspmm(bundle.g, "u_mul_e_add_v", u=z[:, k],
                                  e=w[:, k:k + 1],
                                  strategy=node_strategy(strategy))
        h = acc / K
        if i < n_layers - 1:
            h = torch.relu(h)
    return h
