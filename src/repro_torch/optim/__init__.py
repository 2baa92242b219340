"""Optimizers, schedules and gradient transforms (port of ``repro.optim``).

Mixed precision and compressed exchanges (``optim/precision.py``,
``optim/compression.py``) are ROADMAP A12.
"""
from .optimizers import (AdamState, SGDState, adamw, apply_updates,
                         clip_by_global_norm, global_norm, sgd)
from .schedules import constant, warmup_cosine, warmup_linear

__all__ = ["AdamState", "SGDState", "adamw", "sgd", "clip_by_global_norm",
           "apply_updates", "global_norm", "constant", "warmup_cosine",
           "warmup_linear"]
