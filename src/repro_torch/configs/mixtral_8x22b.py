"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768,
        n_experts=8, top_k=2, sliding_window=4096, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, n_experts=4, top_k=2, sliding_window=16,
        dtype="float32")
