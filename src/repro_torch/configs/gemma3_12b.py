"""gemma3-12b [hf:google/gemma-3-1b-pt (family); unverified].

Dense LM: 48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360
vocab=262144.  5:1 local:global attention (window 1024); the hybrid
pattern keeps long_500k decodable (local layers use O(window) ring
caches; the 8 global layers hold sequence-sharded 512k caches).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="lm",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1e6,
    mlp_act="gelu_gated",
    long_ok=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="lm",
    n_layers=6,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=512,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    mlp_act="gelu_gated",
    attn_chunk=16,
)
