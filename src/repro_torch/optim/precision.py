"""Precision policy for training (port of ``repro/optim/precision.py``).

One small config object decides three things, independently:

  * ``compute`` — the dtype the forward and backward run in. Parameters
    stay fp32 *master weights* (optimizer moments and updates are fp32;
    only the copy used inside the loss is cast), so bf16 training changes
    the model's arithmetic, never the update rule.
  * ``accum`` — the dtype reductions accumulate in. Per-edge
    normalization weights and every aggregation's accumulator stay fp32
    whatever ``compute`` is: the kernels load their operand dtype, sum in
    fp32 and round once at the store, and the plain routes upcast before
    they reduce.
  * ``comm`` — the wire format of the partitioned path's exchanges
    (``"none"`` or ``"int8"``). It is carried here; the full-graph and
    sampled trainers ignore it, as the JAX package's do.

``Precision.fp32()`` is the do-nothing default: at fp32 the trainers'
step is the pre-policy step, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Precision", "cast_tree", "cast_logits", "accum_dtype"]

_COMM_MODES = ("none", "int8")


class Precision(NamedTuple):
    """Compute / accumulation dtypes and the comm compression mode."""
    compute: torch.dtype = torch.float32
    accum: torch.dtype = torch.float32
    comm: str = "none"

    @classmethod
    def fp32(cls) -> "Precision":
        return cls()

    @classmethod
    def bf16(cls, comm: str = "none") -> "Precision":
        return cls(compute=torch.bfloat16, accum=torch.float32, comm=comm)

    @classmethod
    def parse(cls, name: str, comm: str = "none") -> "Precision":
        """``"fp32"`` or ``"bf16"``; anything else (``"fp16"`` included),
        or a comm mode other than ``"none"`` / ``"int8"``, raises
        ``ValueError``."""
        if comm not in _COMM_MODES:
            raise ValueError(f"comm must be one of {_COMM_MODES}: {comm!r}")
        if name == "fp32":
            return cls(comm=comm)
        if name == "bf16":
            return cls.bf16(comm=comm)
        raise ValueError(f"unknown precision preset: {name!r}")

    @property
    def mixed(self) -> bool:
        return self.compute != torch.float32

    def tag(self) -> str:
        """Short label for plan rows and bench output (``"bf16+int8"``)."""
        p = str(self.compute).replace("torch.", "").replace(
            "float32", "fp32").replace("bfloat16", "bf16")
        return p if self.comm == "none" else f"{p}+{self.comm}"


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict / list / tuple to
    ``dtype``; integer and boolean tensors and non-tensor leaves pass.
    The cast is differentiable, so gradients flow back in each leaf's
    own dtype."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [cast_tree(v, dtype) for v in tree]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum over ``dtype`` values accumulates in: fp32 for the
    half-precision types (the policy's ``accum``), else ``dtype`` itself —
    so an fp32 or fp64 reduction is the one it always was."""
    return torch.float32 if dtype in (torch.bfloat16,
                                      torch.float16) else dtype


def cast_logits(logits: torch.Tensor) -> torch.Tensor:
    """Loss inputs always go back to fp32: softmax / cross-entropy in bf16
    loses enough mantissa to visibly bend the loss trajectory."""
    return logits.to(torch.float32)
