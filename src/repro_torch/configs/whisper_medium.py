"""whisper-medium [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs supplies precomputed 1500-frame embeddings). 24 encoder +
24 decoder layers (the real whisper-medium; the assignment's "24L" is
read as per-stack depth — DESIGN.md config notes)
[arXiv:2212.04356]."""
from ..models.lm.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        norm="layernorm", act="gelu",
        n_enc_layers=24, enc_seq=1500)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, norm="layernorm", act="gelu",
        n_enc_layers=2, enc_seq=30, dtype="float32")
