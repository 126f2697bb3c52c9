"""starcoder2-7b [dense] — GQA, RoPE, GELU MLP + biases [arXiv:2402.19173; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_bias=True,
    norm_eps=1e-5,
)

SMOKE_CONFIG = ArchConfig(
    name="starcoder2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=6,
    n_kv_heads=2,
    d_ff=288,
    vocab_size=256,
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_bias=True,
    norm_eps=1e-5,
)
