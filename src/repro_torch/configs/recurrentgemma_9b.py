"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2
[arXiv:2402.19427; unverified]. 38 layers = 12×(rec,rec,attn) + 2 rec tail."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE_CONFIG = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    block_pattern=("rec", "rec", "attn"),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
