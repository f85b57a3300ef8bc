"""qwen2-vl-72b [arXiv:2409.12191; hf].

VLM backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
M-RoPE (temporal/height/width sections).  The vision tower is a STUB:
input_specs provide precomputed patch embeddings (B, S, d) plus the
3-stream M-RoPE position ids.  long_500k skipped (full attention).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="lm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    mlp_act="silu_gated",
    frontend="vision",
    long_ok=False,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    mrope=True,
    mrope_sections=(4, 2, 2),
    mlp_act="silu_gated",
    frontend="vision",
    attn_chunk=32,
)
