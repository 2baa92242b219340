"""Operand checks and launch plumbing shared by the port's kernel wrappers.

A wrapper validates everything the CUDA kernel cannot (device, dtype,
shape, contiguity, autograd: a wrapper never drops a gradient, so an
operand that requires grad raises) in Python before it passes raw pointers,
launches on PyTorch's current stream, and raises when the launch reports
a CUDA error. A graph's index arrays are fixed at construction, so
:func:`graph_index_ptrs` checks them once per graph.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional, Sequence

import torch

__all__ = ["check_operand", "graph_index_ptrs", "device_guard",
           "stream_handle", "ptr", "raise_on_error"]

# every int32 index array of a Graph, by its length in (n_src, n_dst,
# n_edges) terms: "edges", or the CSR pointers' rows + 1
_INDEX_ARRAYS = {"src": "edges", "dst": "edges", "eid": "edges",
                 "eid_inv": "edges", "perm_src": "edges",
                 "src_caller": "edges", "dst_caller": "edges",
                 "indptr_dst": "n_dst", "indptr_src": "n_src"}
_graph_ptrs: "weakref.WeakKeyDictionary[object, Dict[str, int]]" = (
    weakref.WeakKeyDictionary())


def check_operand(kernel: str, name: str, t: torch.Tensor,
                  dtype: torch.dtype, shape: Sequence[Optional[int]],
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    whose shape matches ``shape`` (None = any extent), with no grad."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype} (this slice's kernels are fp32 only)")
    if t.ndim != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.requires_grad:
        raise NotImplementedError(
            f"{kernel}: {name} requires grad, and a kernel wrapper takes "
            f"no autograd input; differentiate through core.gspmm / "
            f"gsddmm / the edge softmax forms / weighted_copy_reduce, whose "
            f"kernel routes run the backward kernels, or call it under "
            f"torch.no_grad()")


def graph_index_ptrs(kernel: str, g) -> Dict[str, int]:
    """Data pointers of graph ``g``'s int32 index arrays by name (those of
    ``core.graph.Graph``, the caller-order pair included), each checked
    as :func:`check_operand` checks an operand at the graph's first
    launch, and kept for as long as the graph lives."""
    ptrs = _graph_ptrs.get(g)
    if ptrs is None:
        ptrs = {}
        for name, rows in _INDEX_ARRAYS.items():
            t = getattr(g, name)
            n = g.n_edges if rows == "edges" else getattr(g, rows) + 1
            check_operand(kernel, name, t, torch.int32, (n,), g.device)
            ptrs[name] = t.data_ptr()
        _graph_ptrs[g] = ptrs
    return ptrs


def device_guard(device: torch.device):
    """Make ``device`` current for a launch: ``torch.cuda.device(device)``,
    or no context at all when it is current already (the usual case; the
    switch costs microseconds a launch would pay each call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, for a C launcher (the
    raw handle, as ``torch.cuda.current_stream(device).cuda_stream`` gives
    it, without building a Stream object on every launch)."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's data pointer for a ``ctypes.c_void_p`` argument (None
    passes a null pointer)."""
    return None if t is None else t.data_ptr()


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
