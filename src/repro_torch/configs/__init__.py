"""Architecture registry, copied from ``repro/configs/__init__.py``: one
module per assigned arch.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
``SHAPES`` defines the assigned input-shape cells; ``cells()`` enumerates
the (arch × shape) grid honoring the long_500k sub-quadratic skip rule.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from ..models.lm.config import ModelConfig

ARCHS = [
    "zamba2_2p7b", "qwen2_7b", "qwen2p5_14b", "llama3p2_3b",
    "internlm2_20b", "whisper_medium", "qwen2_vl_2b", "mixtral_8x22b",
    "granite_moe_3b", "mamba2_1p3b",
]

# canonical assignment ids -> module names
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b", "qwen2-7b": "qwen2_7b",
    "qwen2.5-14b": "qwen2p5_14b", "llama3.2-3b": "llama3p2_3b",
    "internlm2-20b": "internlm2_20b", "whisper-medium": "whisper_medium",
    "qwen2-vl-2b": "qwen2_vl_2b", "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-3b-a800m": "granite_moe_3b", "mamba2-1.3b": "mamba2_1p3b",
}

SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _module(arch: str):
    name = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def cells() -> List[Tuple[str, str]]:
    """All live (arch, shape) dry-run cells (skips noted in DESIGN.md)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape_applicable(cfg, shape):
                out.append((arch, shape))
    return out
