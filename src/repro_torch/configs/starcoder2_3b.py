"""starcoder2-3b [arXiv:2402.19173; hf].

Dense LM: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
Sliding-window attention (4096) + RoPE -> sub-quadratic, long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="lm",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    attn_pattern=("local",),
    window=4096,
    rope_theta=1e5,
    mlp_act="gelu",
    long_ok=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    attn_pattern=("local",),
    window=32,
    mlp_act="gelu",
    attn_chunk=16,
)
