"""llama3.2-3b [dense] — small llama3 GQA [hf:meta-llama/Llama-3.2-*]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, rope_theta=5e5, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
        d_ff=96, vocab=128, tie_embeddings=True, dtype="float32")
