"""llama3-8b [arXiv:2407.21783; unverified].

Dense LM: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    mlp_act="silu_gated",
    long_ok=False,  # full attention -> long_500k skipped
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    mlp_act="silu_gated",
    attn_chunk=32,
)
