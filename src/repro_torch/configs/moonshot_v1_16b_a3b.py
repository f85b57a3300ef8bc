"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B; hf].

MoE LM: 48L d_model=2048 16H (kv=16, MHA) d_ff=1408/expert vocab=163840,
64 experts top-6 (fine-grained experts, deepseek-style).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="lm",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
    rope_theta=5e4,
    mlp_act="silu_gated",
    long_ok=False,  # pure full attention -> long_500k skipped (DESIGN.md)
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=512,
    n_experts=8,
    top_k=2,
    rope_theta=5e4,
    mlp_act="silu_gated",
    attn_chunk=32,
)
