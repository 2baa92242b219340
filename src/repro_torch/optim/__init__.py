"""Optimizers, schedules, gradient transforms, the precision policy and
int8 compression with error feedback (port of ``repro.optim``).
"""
from .compression import (BLOCK, ErrorFeedbackState,
                          compress_payload, compressed_allreduce_terms,
                          init_error_feedback, int8_compress,
                          int8_decompress, quantize_with_feedback,
                          wire_bytes)
from .optimizers import (AdamState, SGDState, adamw, apply_updates,
                         clip_by_global_norm, global_norm, sgd)
from .precision import Precision, accum_dtype, cast_logits, cast_tree
from .schedules import constant, warmup_cosine, warmup_linear

__all__ = ["AdamState", "SGDState", "adamw", "sgd", "clip_by_global_norm",
           "apply_updates", "global_norm", "constant", "warmup_cosine",
           "warmup_linear", "Precision", "cast_tree", "cast_logits",
           "accum_dtype", "BLOCK", "ErrorFeedbackState",
           "init_error_feedback", "int8_compress", "int8_decompress",
           "quantize_with_feedback", "compress_payload", "wire_bytes",
           "compressed_allreduce_terms"]
