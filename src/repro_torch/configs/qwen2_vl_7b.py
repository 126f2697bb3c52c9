"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (stub frontend)
[arXiv:2409.12191; hf]. The vision tower is a STUB: input_specs provide
precomputed patch embeddings merged into the sequence prefix."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    m_rope=True,
    m_rope_sections=(16, 24, 24),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    num_patch_tokens=256,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2-vl-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    m_rope=True,
    m_rope_sections=(2, 3, 3),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    num_patch_tokens=4,
)
