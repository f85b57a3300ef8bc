"""whisper-small [arXiv:2212.04356; unverified].

Encoder-decoder audio backbone: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865.  The conv/log-mel frontend is a STUB: input_specs
provide precomputed frame embeddings (B, 1500, d).  Learned absolute
positions (no RoPE); the decoder position table is extended to the
assigned 32k shapes (original 448 — systems exercise, noted in DESIGN.md).
long_500k skipped (full attention).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    use_rope=False,
    max_pos=32768,
    tie_embeddings=True,
    mlp_act="gelu",
    frontend="audio",
    long_ok=False,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    enc_seq=24,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    use_rope=False,
    max_pos=128,
    tie_embeddings=True,
    mlp_act="gelu",
    frontend="audio",
    attn_chunk=16,
)
