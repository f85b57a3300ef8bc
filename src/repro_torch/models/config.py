"""Architecture configuration of the LM families (port of
``repro/models/config.py``).

Every field and default is the reference's, so the ten configs under
:mod:`repro_torch.configs` construct unchanged.  The training forward
reads ``remat_policy`` (``"dots"`` keeps the weight products through
each layer's checkpoint).  ``microbatches`` is the value a train cell
hands to ``TrainConfig(microbatches=...)``, as the reference's
``build_cell`` does.  The dry run reads ``serve_resident`` (its rules)
and ``bf16_gather`` (its counted gathers); ``unroll_groups`` changes
nothing on one card, and ``explicit_sp`` nothing at all: over a mesh
the port's seq-placed residual stream always gathers the normed block
input in the compute dtype, the transition the lever pins.  ``pdt``
and ``cdt`` are ``torch.dtype`` s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "lm" | "encdec" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention layout: ``attn_pattern`` cycles per layer.  entries:
    #   "global" (full causal), "local" (sliding window), "rec" (RG-LRU)
    attn_pattern: Tuple[str, ...] = ("global",)
    window: int = 0            # sliding-window size for "local" layers
    rope_theta: float = 1e4
    use_rope: bool = True      # False -> learned absolute positions (whisper)
    max_pos: int = 0           # learned-position table size (use_rope=False)
    mrope: bool = False        # qwen2-vl multimodal rotary (3 sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # MoE (0 experts -> dense MLP)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 128

    # hybrid (recurrentgemma): RG-LRU width defaults to d_model
    lru_width: Optional[int] = None

    # encoder-decoder (whisper): encoder depth + stub frontend length
    enc_layers: int = 0
    enc_seq: int = 1500        # precomputed frame embeddings (stub frontend)

    # numerics / compute
    mlp_act: str = "silu_gated"  # or "gelu", "gelu_gated"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    attn_chunk: int = 512       # q-chunk for memory-efficient attention
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # modality stub: "none" | "audio" (frame embeds) | "vision" (patch embeds)
    frontend: str = "none"

    # sub-quadratic long-context capable (SSM/hybrid/sliding-window) —
    # gates the long_500k cell (DESIGN.md skip list)
    long_ok: bool = False

    # unroll the layer-group scan (used by roofline calibration variants:
    # XLA cost_analysis counts a rolled scan body once regardless of the
    # trip count, so calibration compiles shallow UNROLLED models)
    unroll_groups: bool = False

    # §Perf hillclimb lever (serving): keep weights RESIDENT (replicated
    # over the data axis, sharded over model only) instead of ZeRO-3 —
    # decode otherwise re-gathers every layer's weights per generated token
    serve_resident: bool = False

    # §Perf hillclimb lever: gradient-accumulation microbatches (halves
    # the per-step activation live set per doubling)
    microbatches: int = 1

    # §Perf hillclimb lever: ZeRO-3 parameter gathers move bf16 instead of
    # fp32 (cast-before-gather): halves the per-layer FSDP all-gather bytes
    bf16_gather: bool = False

    # §Perf hillclimb lever: remat policy for the group scan:
    # "none" (full recompute) | "dots" (save matmul outputs)
    remat_policy: str = "none"

    # §Perf hillclimb lever: pin the Megatron-SP transition explicitly —
    # the normed block input is constrained to seq-REPLICATED right after
    # the (seq-sharded, fp32-internal) norm, so the all-gather moves bf16
    # norm OUTPUT instead of whatever fp32 intermediate GSPMD picks, and
    # its transpose becomes a bf16 reduce-scatter of the block cotangent.
    explicit_sp: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the logits dimension
        always shards across the TP axis (an unshardable vocab — e.g.
        mamba2's 50280 on a 16-way axis — replicates (B,S,V) fp32 logits
        and their gradients: tens of GiB).  Padded columns are masked to
        -inf in the forward pass."""
        return (self.vocab + 127) // 128 * 128

    @property
    def pdt(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self):
        return getattr(torch, self.compute_dtype)

    @property
    def group_size(self) -> int:
        return len(self.attn_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def n_tail(self) -> int:
        """Layers beyond the scanned groups (e.g. recurrentgemma 38 = 12*3+2)."""
        return self.n_layers - self.n_groups * self.group_size

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, k, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * hd * (h + 2 * k) + h * hd * d
        if self.n_experts > 0:
            gates = 3 if "gated" in self.mlp_act else 2
            mlp = self.n_experts * gates * d * f + d * self.n_experts
        else:
            gates = 3 if "gated" in self.mlp_act else 2
            mlp = gates * d * f
        if self.family == "ssm":
            di = self.expand * d
            nh = di // self.ssm_head_dim
            blk = d * (2 * di + 2 * self.ssm_state + nh) + di * d + 2 * di
        elif self.family == "hybrid":
            lru = self.lru_width or d
            rec = d * 2 * lru + 2 * lru * self.d_conv + 2 * lru * lru + lru * d
            n_rec = sum(1 for p in self.attn_pattern if p == "rec") * self.n_layers // len(self.attn_pattern)
            n_att = self.n_layers - n_rec
            return v * d + n_rec * (rec + mlp + 2 * d) + n_att * (attn + mlp + 2 * d) + d
        else:
            blk = attn + mlp + 2 * d
        total = v * d + self.n_layers * (blk if self.family == "ssm" else attn + mlp + 2 * d) + d
        if not self.tie_embeddings:
            total += v * d
        if self.enc_layers:
            total += self.enc_layers * (attn + mlp + 2 * d) + self.n_layers * attn  # cross-attn
        return total
