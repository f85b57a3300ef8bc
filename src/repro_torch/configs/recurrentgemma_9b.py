"""recurrentgemma-9b (Griffin) [arXiv:2402.19427; unverified].

Hybrid: 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern rec/rec/local (window 2048), RG-LRU width 4096.
38 = 12 scanned groups of 3 + 2 tail layers (rec, rec).
Constant-size recurrent state + O(window) ring caches -> long_500k native.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    attn_pattern=("rec", "rec", "local"),
    window=2048,
    lru_width=4096,
    rope_theta=1e4,
    mlp_act="gelu_gated",
    long_ok=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,   # 1 group of 3 + tail (rec, rec)
    d_model=48,
    n_heads=4,
    n_kv_heads=1,
    d_ff=96,
    vocab=512,
    attn_pattern=("rec", "rec", "local"),
    window=16,
    lru_width=48,
    mlp_act="gelu_gated",
    attn_chunk=16,
)
