"""internlm2-20b [dense] — GQA [arXiv:2403.17297; hf]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92544, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, dtype="float32")
