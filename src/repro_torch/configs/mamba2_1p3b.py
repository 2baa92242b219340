"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_chunk=32, tie_embeddings=True, dtype="float32")
