"""qwen2-vl-2b [vlm] — M-RoPE (t/h/w sections), dynamic-resolution vision
frontend STUBBED (input_specs supplies merged embeddings + 3-row position
ids) [arXiv:2409.12191; hf]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24), tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, qkv_bias=True,
        mrope_sections=(2, 3, 3), tie_embeddings=True, dtype="float32")
