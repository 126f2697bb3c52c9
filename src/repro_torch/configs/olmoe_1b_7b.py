"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE_CONFIG = ArchConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe_capacity_factor=2.0,
)
