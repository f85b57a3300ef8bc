"""dbrx-132b [hf:databricks/dbrx-base; unverified].

MoE LM: 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352,
16 experts top-4 (fine-grained).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="lm",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
    mlp_act="silu_gated",
    long_ok=False,  # full attention -> long_500k skipped
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="lm",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    n_experts=4,
    top_k=2,
    mlp_act="silu_gated",
    attn_chunk=32,
)
