"""Reduce-stage strategies (port of ``repro/core/strategies.py``).

Every strategy computes ``out[j] = ⊕_{edges e: tgt(e)=j} msg[e]`` with
empty targets 0, after the paper's progression:

* :func:`push_scatter` — paper Alg. 1 (the DGL baseline): materialized
  per-edge messages scatter-reduced into an identity-filled output
  (``index_add`` / ``scatter_reduce``, atomics on the card).
* :func:`pull_segment` — paper Alg. 2: destination-sorted segment
  reduction, every reducer. It is the reference every CUDA kernel of the
  port is held against. A sum walks the sorted stream with one owner per
  output row (``torch.segment_reduce``), so it is bit-identical from call
  to call on the card too, where an ``index_add_`` adds by atomics in
  whatever order the threads arrive.
* :func:`pull_ell_reduce` — paper Alg. 3, the blocked pull over a
  degree-bucketed ELL pack (``core/tiling.py``): a dense masked reduce
  along each class's width, then one sorted segment reduce per class.
* :func:`onehot_spmm` — the TPU's MXU formulation over a ``TilePack``:
  per bucket a one-hot gather and a one-hot scatter matrix, two dense
  batched products, then one sorted segment sum of the partials by
  M-tile. Sum and mean only.

The packs are TPU layouts, so these routes are plain PyTorch; the CUDA
kernels walk the CSR.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["REDUCE_IDENTITY", "finalize_empty_rows", "push_scatter",
           "pull_segment", "pull_ell_reduce", "onehot_spmm"]

REDUCE_IDENTITY = {
    "sum": 0.0,
    "mean": 0.0,
    "max": -float("inf"),
    "min": float("inf"),
    "prod": 1.0,
}

# torch.scatter_reduce's name for each reducer that is not a sum
_SCATTER = {"max": "amax", "min": "amin", "prod": "prod"}


def finalize_empty_rows(out: torch.Tensor, deg: torch.Tensor,
                        reduce_op: str) -> torch.Tensor:
    """DGL semantics: rows with no incoming edge are 0, for every ⊕."""
    if reduce_op == "sum":
        return out  # a segment sum already yields 0 for empty rows
    has = (deg > 0).reshape(deg.shape + (1,) * (out.ndim - 1))
    return torch.where(has, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))


def push_scatter(msg: torch.Tensor, tgt: torch.Tensor, n_tgt: int,
                 reduce_op: str, deg: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Materialized messages scatter-reduced into an identity-filled
    output (the DGL push baseline); ``tgt`` is the int64 target of each
    message in any order. Without ``deg`` an empty row keeps the
    reducer's identity (±inf for an extremum), so a caller can combine
    partial results; with ``deg`` every empty row is 0 and a mean divides
    by it. Unlike :func:`pull_segment`, a non-finite extremum of a row
    that has edges stays as it is, as in JAX."""
    shape = (n_tgt,) + tuple(msg.shape[1:])
    out = torch.full(shape, REDUCE_IDENTITY[reduce_op], dtype=msg.dtype,
                     device=msg.device)
    if reduce_op in ("sum", "mean"):
        out = out.index_add(0, tgt, msg)
    elif reduce_op in _SCATTER:
        idx = tgt.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        out = out.scatter_reduce(0, idx, msg, _SCATTER[reduce_op],
                                 include_self=True)
    else:
        raise ValueError(f"unknown reduce op {reduce_op!r}")
    if reduce_op == "mean":
        d = deg.clamp(min=1).to(msg.dtype)
        out = out / d.reshape((n_tgt,) + (1,) * (msg.ndim - 1))
    return finalize_empty_rows(out, deg, reduce_op) if deg is not None else out


def pull_segment(msg: torch.Tensor, tgt_sorted: torch.Tensor, n_tgt: int,
                 reduce_op: str, deg: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Segment reduction of per-edge messages ``msg`` (E, *feat) onto
    ``n_tgt`` rows; ``tgt_sorted`` is the int64 target of each edge, in
    non-decreasing order, and ``deg`` (when given) the number of edges of
    each target row — the segment lengths of a sum or mean.

    As in the JAX package, an extremum that is not finite (an empty row's
    identity, or an infinite message) becomes 0, and with ``deg`` given
    every empty row is 0 — a product's included.
    """
    shape = (n_tgt,) + tuple(msg.shape[1:])
    if reduce_op in ("sum", "mean"):
        lengths = (torch.bincount(tgt_sorted, minlength=n_tgt)
                   if deg is None else deg.long())
        # the lengths are a graph's degrees, right by construction:
        # ``unsafe`` skips the checks that read them back to the host
        out = torch.segment_reduce(msg, "sum", lengths=lengths, unsafe=True)
        if reduce_op == "mean":
            d = deg.clamp(min=1).to(msg.dtype)
            out = out / d.reshape((n_tgt,) + (1,) * (msg.ndim - 1))
    elif reduce_op in _SCATTER:
        # identity-filled output with include_self: an empty row keeps the
        # identity, exactly what jax.ops.segment_{max,min,prod} return
        out = torch.full(shape, REDUCE_IDENTITY[reduce_op], dtype=msg.dtype,
                         device=msg.device)
        idx = tgt_sorted.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        out = out.scatter_reduce(0, idx, msg, _SCATTER[reduce_op],
                                 include_self=True)
        if reduce_op != "prod":
            out = torch.where(torch.isfinite(out), out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
    else:
        raise ValueError(f"unknown reduce op {reduce_op!r}")
    return finalize_empty_rows(out, deg, reduce_op) if deg is not None else out


def _combine(base: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if base == "sum":
        return a + b
    if base == "max":
        return torch.maximum(a, b)
    if base == "min":
        return torch.minimum(a, b)
    return a * b


def pull_ell_reduce(pack, class_msg_fn: Callable, reduce_op: str,
                    deg: Optional[torch.Tensor] = None,
                    raw: bool = False) -> torch.Tensor:
    """Blocked pull over an :class:`~repro_torch.core.tiling.ELLPack`.

    ``class_msg_fn(cls)`` gives one class's per-slot messages, (chunks,
    width, *feat), gathered inside so the edge-ordered message stream is
    never materialized. Pad slots take the reducer's identity and each
    chunk reduces along its width; a class's chunks then reduce onto
    their rows by one sorted segment reduce (a row wider than the cap has
    several chunks in the cap's class), and the classes combine. With
    ``raw`` the finalize is skipped (extrema keep ±inf on empty rows, no
    mean divide, no empty-row zeroing), for a caller that combines
    several partial reductions and finalizes once."""
    base = "sum" if reduce_op in ("sum", "mean") else reduce_op
    if base not in ("sum", "max", "min", "prod"):
        raise ValueError(f"unknown reduce op {reduce_op!r}")
    n = pack.n_dst
    out = None
    for cls in pack.classes:
        msg = class_msg_fn(cls)                          # (C, W, *feat)
        mask = cls.chunk_mask.reshape(tuple(cls.chunk_mask.shape)
                                      + (1,) * (msg.ndim - 2))
        msg = torch.where(mask, msg,
                          msg.new_full((), REDUCE_IDENTITY[reduce_op]))
        if base == "sum":
            part = msg.sum(dim=1)
        elif base == "max":
            part = msg.amax(dim=1)
        elif base == "min":
            part = msg.amin(dim=1)
        else:
            part = msg.prod(dim=1)
        if base == "sum":
            # an identity-free sorted sum: empty rows come out 0
            cls_out = torch.segment_reduce(part, "sum",
                                           lengths=cls.row_lengths(n),
                                           unsafe=True)
        else:
            # identity-filled, as jax.ops.segment_{max,min,prod}: the
            # cross-class combine stays right on negative extrema
            cls_out = part.new_full((n,) + tuple(part.shape[1:]),
                                    REDUCE_IDENTITY[base])
            idx = cls.long("chunk_row").reshape(
                (-1,) + (1,) * (part.ndim - 1)).expand_as(part)
            cls_out = cls_out.scatter_reduce(0, idx, part, _SCATTER[base],
                                             include_self=True)
        out = cls_out if out is None else _combine(base, out, cls_out)
    if raw:
        return out
    if base in ("max", "min"):
        out = torch.where(torch.isfinite(out), out, out.new_zeros(()))
    if reduce_op == "mean":
        d = deg.clamp(min=1).to(out.dtype)
        out = out / d.reshape((n,) + (1,) * (out.ndim - 1))
    return finalize_empty_rows(out, deg, reduce_op) if deg is not None else out


# buckets whose one-hot G and S are built at once: 2 × 4096 × 256 × 128
# fp32 entries (1 GiB) at the default tile geometry, where building all
# of a 76,213-bucket graph's would take 20 GB
ONEHOT_BUCKET_CHUNK = 4096


def onehot_spmm(pack, B: torch.Tensor, reduce_op: str = "sum",
                edge_weight: Optional[torch.Tensor] = None,
                deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A ⊕ B by per-bucket one-hot products over a
    :class:`~repro_torch.core.tiling.TilePack`. For bucket t with edges
    (dl, sl):

      G_t[j, :] = onehot(sl_j)           (eb × bk)  gather matrix
      S_t[:, j] = w_j · onehot(dl_j)     (bm × eb)  scatter matrix
      partial_t = S_t @ (G_t @ B_block[tile_k_t])

    then one sorted segment sum of the partials by ``tile_m``. Sum and
    mean only (an extremum is not a product). ``edge_weight`` (T, eb) is
    the per-slot scalar weight. G and S are built for
    ``ONEHOT_BUCKET_CHUNK`` buckets at a time; each bucket's two products
    are the same as if all were built at once."""
    if reduce_op not in ("sum", "mean"):
        raise ValueError("onehot_spmm supports sum/mean only")
    T, eb = pack.dst_local.shape
    bm, bk = pack.bm, pack.bk
    d = B.shape[-1]
    pad_k = pack.n_tiles_k * bk - B.shape[0]
    Bt = torch.nn.functional.pad(B, (0, 0, 0, pad_k)).reshape(
        pack.n_tiles_k, bk, d)
    step = ONEHOT_BUCKET_CHUNK
    iota_k = torch.arange(bk, device=B.device)
    iota_m = torch.arange(bm, device=B.device)
    zero = B.new_zeros(())
    partials = []
    for lo in range(0, T, step):
        hi = min(T, lo + step)
        mask = pack.mask[lo:hi]
        G = (pack.long("src_local")[lo:hi, :, None] == iota_k)
        G = (G & mask[:, :, None]).to(B.dtype)               # (t, eb, bk)
        S = (pack.long("dst_local")[lo:hi, None, :]
             == iota_m[None, :, None]).to(B.dtype)           # (t, bm, eb)
        if edge_weight is not None:
            S = S * edge_weight[lo:hi, None, :].to(B.dtype)
        S = torch.where(mask[:, None, :], S, zero)
        Bsel = Bt.index_select(0, pack.long("tile_k")[lo:hi])  # (t, bk, d)
        partials.append(torch.bmm(S, torch.bmm(G, Bsel)))    # (t, bm, d)
    partial = partials[0] if len(partials) == 1 else torch.cat(partials)
    tiles = torch.segment_reduce(partial, "sum", lengths=pack.m_lengths(),
                                 unsafe=True)
    out = tiles.reshape(pack.n_tiles_m * bm, d)[: pack.n_dst]
    if reduce_op == "mean":
        out = out / deg.clamp(min=1).to(out.dtype)[:, None]
    return out
