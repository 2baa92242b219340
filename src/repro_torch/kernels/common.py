"""Operand checks and launch plumbing shared by the port's kernel wrappers.

A wrapper validates everything the CUDA kernel cannot (device, dtype,
shape, contiguity, autograd) in Python before it passes raw pointers,
launches on PyTorch's current stream, and raises when the launch reports
a CUDA error.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

__all__ = ["check_operand", "stream_handle", "ptr", "raise_on_error"]


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
            f"{kernel}: {name} requires grad, but the backward kernels "
            f"come with the training slice; run under torch.no_grad()")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C launcher."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
