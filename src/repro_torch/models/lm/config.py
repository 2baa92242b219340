"""Model configuration for the LM-family architectures (a copy of
``repro/models/lm/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: Optional[int] = None     # default d_model // n_heads
    qkv_bias: bool = False           # qwen2 family
    rope_theta: float = 1e6
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): shared attention block applied every N ssm layers
    shared_attn_every: int = 0

    # attention extras
    sliding_window: int = 0          # 0 = full attention (mixtral SWA)
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE

    # encoder-decoder (whisper): n_layers counts DECODER layers
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub frontend sequence length (1500)

    # training defaults
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape cell (DESIGN.md)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        Dh, Hq, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        mlp_dense = 3 * D * F if self.act == "swiglu" else 2 * D * F
        if self.family == "moe":
            mlp = self.n_experts * mlp_dense + D * self.n_experts  # + router
        else:
            mlp = mlp_dense
        if self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            blk = (D * (2 * di + 2 * N + H)       # in_proj
                   + self.ssm_conv * (di + 2 * N)  # depthwise conv
                   + 2 * H                        # A_log, dt_bias
                   + di                           # skip D
                   + di * D)                      # out_proj
            return emb + self.n_layers * (blk + 2 * D)
        if self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            blk = (D * (2 * di + 2 * N + H) + self.ssm_conv * (di + 2 * N)
                   + 2 * H + di + di * D)
            shared = attn + mlp_dense + 4 * D
            return emb + self.n_layers * (blk + 2 * D) + shared
        per_layer = attn + mlp + 4 * D
        total = emb + self.n_layers * per_layer
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + mlp_dense + 4 * D)
            total += self.n_layers * (attn + 2 * D)   # cross-attention
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mlp_dense = 3 * D * F if self.act == "swiglu" else 2 * D * F
        return self.param_count() - \
            self.n_layers * (self.n_experts - self.top_k) * mlp_dense
