"""Optimizers, schedules, gradient transforms and the precision policy
(port of ``repro.optim``).

Compressed exchanges (``optim/compression.py``) are ROADMAP A12.
"""
from .optimizers import (AdamState, SGDState, adamw, apply_updates,
                         clip_by_global_norm, global_norm, sgd)
from .precision import Precision, accum_dtype, cast_logits, cast_tree
from .schedules import constant, warmup_cosine, warmup_linear

__all__ = ["AdamState", "SGDState", "adamw", "sgd", "clip_by_global_norm",
           "apply_updates", "global_norm", "constant", "warmup_cosine",
           "warmup_linear", "Precision", "cast_tree", "cast_logits",
           "accum_dtype"]
