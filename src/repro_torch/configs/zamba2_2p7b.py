"""zamba2-2.7b [hybrid] — 54 Mamba2 layers + shared attention block every
6 layers (single shared copy; the real model alternates two shared blocks
with LoRA — simplification noted in DESIGN.md) [arXiv:2411.15242; hf]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        shared_attn_every=6, rope_theta=1e4, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_chunk=32, shared_attn_every=2, tie_embeddings=True,
        dtype="float32")
