"""mamba2-370m [arXiv:2405.21060; unverified].

SSM (attention-free): 48L d_model=1024, ssm_state=128, expand=2
(d_inner=2048, 32 heads of 64), vocab=50280.  SSD chunked scan; decode
state is O(1) in context -> long_500k native.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,       # attention-free; SSD heads derive from expand*d/head_dim
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    attn_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    expand=2,
    ssm_chunk=256,
    long_ok=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    attn_pattern=("ssm",),
    ssm_state=16,
    ssm_head_dim=16,
    expand=2,
    ssm_chunk=16,
)
