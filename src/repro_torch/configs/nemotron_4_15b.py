"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="squared_relu",
    norm_kind="layernorm",
    norm_eps=1e-5,
)

SMOKE_CONFIG = ArchConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    mlp_kind="squared_relu",
    norm_kind="layernorm",
    norm_eps=1e-5,
)
