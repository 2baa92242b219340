"""Meta-tensor stand-ins for every model input of a dry-run cell (port of
``repro/launch/input_specs.py``; no allocation).

``input_specs(arch, shape)`` returns the abstract inputs the step of that
cell runs on, as ``meta`` tensors of the shapes and dtypes of JAX's
``ShapeDtypeStruct``s: int32 tokens and labels, whisper's ``frames`` /
``memory`` and every cache leaf in the model dtype (the SSM state in
float32), the VLM's (3, B, S) positions, the decode ``token`` (B,) and a
0-d ``pos``. The dry run (``launch/dryrun.py``) turns them into fake
tensors, sharded as ``launch/shardings.py`` says.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs import SHAPES, get_config
from ..models.lm.config import ModelConfig
from ..models.lm.model import init_cache, lm_dtype

__all__ = ["spec", "train_batch_specs", "cache_shapes", "serve_extras_specs",
           "step_specs", "input_specs"]


def spec(shape, dtype: torch.dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, B: int, S: int
                      ) -> Dict[str, torch.Tensor]:
    batch = {"tokens": spec((B, S), torch.int32),
             "labels": spec((B, S), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = spec((B, cfg.enc_seq, cfg.d_model), lm_dtype(cfg))
    if cfg.family == "vlm":
        batch["positions"] = spec((3, B, S), torch.int32)
    return batch


def cache_shapes(cfg: ModelConfig, B: int, S: int):
    """The cache tree of ``models/lm/model.py``'s ``init_cache``, meta."""
    return init_cache(cfg, B, S, lm_dtype(cfg), "meta")


def serve_extras_specs(cfg: ModelConfig, B: int, S: int,
                       kind: str) -> Dict[str, torch.Tensor]:
    ex: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec" and kind == "prefill":
        # decode takes NO memory: cross-attention K/V live in the cache
        # (projected once at prefill)
        ex["memory"] = spec((B, cfg.enc_seq, cfg.d_model), lm_dtype(cfg))
    if cfg.family == "vlm" and kind == "prefill":
        ex["positions"] = spec((3, B, S), torch.int32)
    return ex


def step_specs(cfg: ModelConfig, B: int, S: int, kind: str
               ) -> Dict[str, Any]:
    """The meta trees a ``kind`` step of ``cfg`` takes at batch ``B``,
    length ``S``: ``batch``; or ``tokens``, ``cache``, ``extras``; or
    ``token``, ``cache``, ``pos``, ``extras``."""
    if kind == "train":
        return {"batch": train_batch_specs(cfg, B, S)}
    if kind == "prefill":
        return {"tokens": spec((B, S), torch.int32),
                "cache": cache_shapes(cfg, B, S),
                "extras": serve_extras_specs(cfg, B, S, "prefill")}
    # decode: one new token against an S-deep cache
    return {"token": spec((B,), torch.int32),
            "cache": cache_shapes(cfg, B, S),
            "pos": spec((), torch.int32),
            "extras": serve_extras_specs(cfg, B, S, "decode")}


def input_specs(arch: str, shape: str) -> Dict[str, Any]:
    """Abstract inputs for one (arch, shape) cell.

    Returns {"kind", "cfg", "B", "S", and the kind's meta trees}."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    return {"kind": kind, "cfg": cfg, "B": B, "S": S,
            **step_specs(cfg, B, S, kind)}
