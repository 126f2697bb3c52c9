"""Architecture + shape-cell configuration schema.

Each assigned architecture gets one module in this package defining
``CONFIG`` (full size, exact dims from the brief) and ``SMOKE_CONFIG``
(reduced same-family config for CPU smoke tests). ``shapes.py`` defines the
four input-shape cells and the applicability rules (which cells run for
which family).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512         # scatter-dispatch group (seq-chunk) size

    # Attention details
    qk_norm: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 10_000.0
    m_rope: bool = False
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)

    # Block internals
    mlp_kind: str = "swiglu"          # swiglu | squared_relu | gelu
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    use_bias: bool = False
    tie_embeddings: bool = False

    # Hybrid / recurrent structure (recurrentgemma, xlstm)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rnn_width: int = 0                # RG-LRU recurrence width (0 → d_model)
    conv1d_width: int = 4             # RG-LRU temporal conv window

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # VLM stub frontend
    num_patch_tokens: int = 0         # precomputed patch embeddings per sample

    dtype: str = "bfloat16"

    # ---------------------------------------------------------------- #
    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads {self.n_heads} % kv {self.n_kv_heads}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory/compute per token is bounded (long_500k ok)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6·N·D accounting."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.is_moe:
            per_expert = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            mlp = self.n_experts * per_expert + d * self.n_experts  # + router
        else:
            mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        block = attn + mlp
        n_blocks = self.n_layers + self.encoder_layers
        return emb + n_blocks * block

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_expert = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive
