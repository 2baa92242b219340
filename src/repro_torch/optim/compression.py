"""int8 compression with error feedback (port of
``repro/optim/compression.py``).

The partitioned path's cross-shard exchanges (``core/partition.py``,
``comm="int8"``) put each source block on an int8 wire: blockwise
symmetric quantization, one fp32 scale per :data:`BLOCK` values, with the
quantization residual carried to the next step (EF-SGD style) so the
compression stays unbiased in the long run. Plain PyTorch, as the JAX
package's is plain ``jnp``: there is no Pallas kernel to port.

``int8_compress`` rounds half to even (``torch.round``, as
``jnp.round``), so on the same fp32 inputs the port's ``q`` and scales
are the JAX package's element for element.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

__all__ = ["BLOCK", "ErrorFeedbackState", "init_error_feedback",
           "int8_compress", "int8_decompress", "quantize_with_feedback",
           "compress_payload", "wire_bytes", "compressed_allreduce_terms"]

BLOCK = 256


class ErrorFeedbackState(NamedTuple):
    residual: Any  # a list of fp32 tensors matching the parameters


def _leaves(params):
    """The tensors of ``params``: a module's parameters, a tensor, or a
    (nested) dict / list / tuple of tensors."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [t for v in params.values() for t in _leaves(v)]
    return [t for v in params for t in _leaves(v)]


def init_error_feedback(params) -> ErrorFeedbackState:
    """Zero fp32 residuals, one per tensor of ``params``."""
    return ErrorFeedbackState(residual=[
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in _leaves(params)])


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns ``(q, scales)``:
    ``q`` (n_blocks, BLOCK) int8, ``scales`` (n_blocks,) fp32 — amax / 127
    of each block, 1 for an all-zero block."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    amax = flat.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    """``q · scale`` back to ``shape`` in ``dtype``."""
    flat = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= int(s)
    return flat.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantize_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Quantize ``g + residual``; return ``(q, scale, new_residual)``."""
    target = g.to(torch.float32) + residual
    q, scale = int8_compress(target)
    deq = int8_decompress(q, scale, g.shape, torch.float32)
    return q, scale, target - deq


def compress_payload(x: torch.Tensor, residual: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straight-through int8 wire emulation for a differentiable payload.

    Returns ``(y, new_residual)``: ``y`` carries the dequantized int8
    values of ``x + residual`` forward and the identity adjoint backward
    (``y = x + (deq - x).detach()``; round and clip have no useful
    gradient), and ``new_residual`` is the error-feedback carry, detached
    so it can live in the train state without autograd chasing it across
    steps."""
    target = x.to(torch.float32) + residual
    q, scale = int8_compress(target)
    deq = int8_decompress(q, scale, x.shape, torch.float32)
    y = x + (deq.to(x.dtype) - x).detach()
    return y, (target - deq).detach()


def wire_bytes(n: int, itemsize: int, comm: str) -> Tuple[int, int]:
    """``(raw_bytes, wire_bytes)`` for ``n`` elements of ``itemsize``
    under comm mode ``comm``: the accounting the obs counters and the
    planner's ring term share (int8: one byte an element plus a 4-byte
    scale per block)."""
    raw = n * itemsize
    if comm == "int8":
        return raw, n * 1 + (-(-n // BLOCK)) * 4
    return raw, raw


def compressed_allreduce_terms(params) -> Tuple[int, int]:
    """``(raw_bytes, compressed_bytes)`` of a full-gradient all-reduce
    over the tensors of ``params``."""
    raw = comp = 0
    for p in _leaves(params):
        n = p.numel()
        raw += n * p.element_size()
        comp += n * 1 + (-(-n // BLOCK)) * 4
    return raw, comp
