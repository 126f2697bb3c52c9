"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
