"""granite-20b (code) [arXiv:2405.04324; hf].

Dense LM: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
GPT-BigCode-style: plain GeLU MLP, multi-query attention.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="lm",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    mlp_act="gelu",
    long_ok=False,  # full attention -> long_500k skipped
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    vocab=512,
    mlp_act="gelu",
    attn_chunk=32,
)
