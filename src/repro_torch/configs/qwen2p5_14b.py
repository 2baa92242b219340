"""qwen2.5-14b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5 family]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
        d_ff=160, vocab=256, qkv_bias=True, dtype="float32")
