"""Fused GAT attention, forward (port of
``repro/core/edge_softmax.py::fused_attention``).

GAT's attention pipeline — ``u_add_v_copy_e`` logits, leaky-relu, edge
softmax and the ``u_mul_e_add_v`` aggregation — as ONE pass; per-edge α
is never materialized in caller order. Strategies:

* ``"fused"`` — the plain PyTorch pipeline in canonical order
  (``kernels.edge_softmax.ops.fused_attention_plain``);
* ``"kernel"`` — the CUDA online-softmax kernel (B2);
* ``"auto"`` — the kernel for CUDA tensors, ``"fused"`` otherwise.

The backward (``_attention_grads``), the composed 5-primitive
``edge_softmax``, ``edge_softmax_fused`` and the block / partitioned
variants come with later slices (ROADMAP A4, A10, A12).
"""
from __future__ import annotations

import torch

from ..kernels.edge_softmax.ops import (fused_attention_csr,
                                        fused_attention_plain)

__all__ = ["fused_attention", "ATTN_STRATEGIES"]

ATTN_STRATEGIES = ("auto", "fused", "kernel")


def fused_attention(g, el: torch.Tensor, er: torch.Tensor, z: torch.Tensor,
                    *, negative_slope: float = 0.2,
                    strategy: str = "auto") -> torch.Tensor:
    """``el``: (n_src, H) or (n_src,) source logit terms; ``er``: (n_dst,
    H) destination terms; ``z``: (n_src, H, F) source features ((n_src, F)
    when ``el`` is 1-D). Returns (n_dst, H, F) aggregated features;
    zero-degree rows are 0."""
    if strategy == "pallas":
        raise NotImplementedError(
            "strategy 'pallas' is the TPU kernel; its port is "
            "strategy='kernel' (ROADMAP B2)")
    if strategy not in ATTN_STRATEGIES:
        raise ValueError(f"unknown attention strategy {strategy!r}; "
                         f"expected one of {ATTN_STRATEGIES}")
    squeeze = el.ndim == 1
    if squeeze:
        el, er, z = el[:, None], er[:, None], z[:, None, :]
    if strategy == "auto":
        strategy = "kernel" if z.device.type == "cuda" else "fused"
    slope = float(negative_slope)
    if strategy == "kernel":
        out = fused_attention_csr(g, el.contiguous(), er.contiguous(),
                                  z.contiguous(), slope)
    else:
        out = fused_attention_plain(g, el, er, z, slope)
    return out[:, 0, :] if squeeze else out
