"""whisper-small [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356;
unverified]. input_specs provide precomputed frame embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_kind="gelu",
    norm_kind="layernorm",
    norm_eps=1e-5,
    use_bias=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    encoder_layers=12,
)

SMOKE_CONFIG = ArchConfig(
    name="whisper-small-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mlp_kind="gelu",
    norm_kind="layernorm",
    norm_eps=1e-5,
    use_bias=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    encoder_layers=2,
)
