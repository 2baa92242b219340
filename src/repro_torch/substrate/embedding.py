"""Embedding with a Copy-Reduce backward (port of
``repro/substrate/embedding.py``, paper §4).

The forward is a gather of table rows. Its backward is again aggregation:
the cotangent rows summed into the rows they were read from. The JAX
package writes it as a sorted segment sum (sort the ids, then one owner
per table row, ``pull_segment``) instead of autodiff's scatter-add, and so
does :func:`embedding_lookup` here, as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from ..core.strategies import pull_segment
from ..device import DeviceLike, resolve_device

__all__ = ["embedding_init", "embedding_lookup"]


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   scale: float = 0.02, device: DeviceLike = "cuda"
                   ) -> torch.Tensor:
    """(vocab, d) normal · ``scale``, drawn on the CPU from ``gen``."""
    return (torch.randn(vocab, d, generator=gen) * scale).to(
        resolve_device(device))


class _EmbeddingLookup(torch.autograd.Function):
    """``table[ids]`` with the sorted-segment backward (``_emb_bwd``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.vocab = table.shape[0]
        ctx.save_for_backward(ids)
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        ids, = ctx.saved_tensors
        flat_ids = ids.reshape(-1)
        flat_ct = ct.reshape(flat_ids.shape[0], -1)
        # sort by table row, then one owner per row: the pull model
        order = torch.argsort(flat_ids, stable=True)
        grad = pull_segment(flat_ct.index_select(0, order),
                            flat_ids.index_select(0, order), ctx.vocab,
                            "sum")
        return grad.reshape((ctx.vocab,) + tuple(ct.shape[ids.ndim:])), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]``; ``ids`` int64 of any shape."""
    return _EmbeddingLookup.apply(table, ids.long())
