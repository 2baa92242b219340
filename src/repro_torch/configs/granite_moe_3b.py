"""granite-moe-3b-a800m [moe] — 40 experts top-8 (structured field of the
assignment; its trailing comment says 32 — we follow the field, see
DESIGN.md config notes) [hf:ibm-granite/granite-3.0 family]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155,
        n_experts=40, top_k=8, rope_theta=1e4, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, n_experts=8, top_k=4, tie_embeddings=True,
        dtype="float32")
