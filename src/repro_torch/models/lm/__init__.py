"""The LM-family architecture stack (port of ``repro.models.lm``)."""
from . import layers, mamba2, model, moe, tp
from .config import ModelConfig
from .model import (LM, backbone, decode_step, encode, from_jax_params,
                    init_cache, init_params, loss_fn, prefill, to_jax_tree)

__all__ = ["ModelConfig", "layers", "model", "moe", "mamba2", "tp", "LM",
           "init_params", "loss_fn", "prefill", "decode_step", "init_cache",
           "backbone", "encode", "from_jax_params", "to_jax_tree"]
