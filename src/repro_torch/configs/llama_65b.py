"""llama-65b — the paper's own serving model (Table III). Not part of the
assigned 40-cell table; used by the reproduction narrative and engine demos."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-65b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=64,
    d_ff=22016,
    vocab_size=32000,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE_CONFIG = ArchConfig(
    name="llama-65b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
