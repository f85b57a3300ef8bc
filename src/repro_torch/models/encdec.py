"""Encoder-decoder family (port of ``repro/models/encdec.py``, the
whisper-small backbone).

The conv/log-mel audio frontend is a STUB, as in the reference: callers
supply precomputed frame embeddings ``(B, enc_seq, d)``.  The encoder is
a bidirectional transformer; the decoder adds causal self-attention
(+KV cache) and cross-attention to the encoder output (cross K/V
computed once at prefill and cached).  Whisper uses learned absolute
positions (``use_rope=False``) and ties the unembedding to the token
embedding.

Caches are per-layer: a list with one ``{"self": {k, v}, "cross": {k,
v}}`` a decoder layer.  ``remat=True`` (training, no caches)
checkpoints each layer and saves nothing, as the reference's
``nothing_saveable`` scan bodies do whatever ``cfg.remat_policy`` says.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_slice_clamped, remat_call,
                                            unembed_logits)

Cache = Dict[str, Dict[str, torch.Tensor]]


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.attn = L.Attention(cfg, init)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.mlp = L.MLP(cfg, init)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.attn = L.Attention(cfg, init)
        self.ln_x = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.xattn = L.Attention(cfg, init)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.mlp = L.MLP(cfg, init)


class EncDec(nn.Module):
    """``embed (padded_vocab, d)``, ``enc_pos (enc_seq, d)``, ``dec_pos
    (max(max_pos, 1), d)``, the ``enc`` and ``dec`` layers, ``enc_norm``
    and ``final_norm``; run by :func:`encode` and :func:`decode`."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = init.dense((cfg.padded_vocab, cfg.d_model), cfg.pdt)
        self.enc_pos = init.dense((cfg.enc_seq, cfg.d_model), cfg.pdt)
        self.dec_pos = init.dense((max(cfg.max_pos, 1), cfg.d_model), cfg.pdt)
        self.enc = nn.ModuleList(EncLayer(cfg, init)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, init)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, cfg.pdt, init)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.pdt, init)


def param_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], T.Spec]:
    """Every parameter leaf's logical spec, keyed by its path in the
    reference's tree (``encdec.py::init_encdec``'s spec tree: the
    ``enc`` and ``dec`` stacks carry the leading layer axis)."""
    enc = {"ln1": L.RMSNORM_SPECS, "attn": L.ATTENTION_SPECS,
           "ln2": L.RMSNORM_SPECS, "mlp": L.mlp_specs(cfg)}
    dec = {"ln1": L.RMSNORM_SPECS, "attn": L.ATTENTION_SPECS,
           "ln_x": L.RMSNORM_SPECS, "xattn": L.ATTENTION_SPECS,
           "ln2": L.RMSNORM_SPECS, "mlp": L.mlp_specs(cfg)}
    specs = {("embed",): ("vocab", "fsdp"), ("enc_pos",): (None, "fsdp"),
             ("dec_pos",): (None, "fsdp")}
    if cfg.enc_layers > 0:
        specs.update(T.flat_specs(enc, ("enc",), stacked=True))
    if cfg.n_layers > 0:
        specs.update(T.flat_specs(dec, ("dec",), stacked=True))
    specs[("enc_norm", "scale")] = L.RMSNORM_SPECS["scale"]
    specs[("final_norm", "scale")] = L.RMSNORM_SPECS["scale"]
    return specs


def cache_specs(cfg: ModelConfig) -> Dict[Tuple[str, ...], T.Spec]:
    """Every cache leaf's logical spec, keyed by its path in the
    reference's cache tree (``init_encdec_cache``'s: ``self`` and
    ``cross`` stacked over the decoder layers)."""
    kv = T.layer_cache_specs("global")
    if cfg.n_layers == 0:
        return {}
    return T.flat_specs({"self": kv, "cross": kv}, stacked=True)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype: torch.dtype, device: torch.device) -> List[Cache]:
    def kv(s_len):
        return {n: torch.zeros((batch, s_len, cfg.n_kv_heads, cfg.hd),
                               dtype=dtype, device=device) for n in ("k", "v")}

    return [{"self": kv(max_seq), "cross": kv(cfg.enc_seq)}
            for _ in range(cfg.n_layers)]


def _enc_layer(lp: EncLayer, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    h = lp.ln1(x, cfg.norm_eps)
    mix, _ = lp.attn(h, causal=False)
    x = x + mix
    return x + lp.mlp(lp.ln2(x, cfg.norm_eps))


def encode(model: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, enc_seq, d) precomputed embeddings (stub frontend)."""
    cdt = cfg.cdt
    x = frames.to(cdt) + model.enc_pos.to(cdt)[None]
    for lp in model.enc:
        x = (remat_call(_enc_layer, "none", lp, x, cfg) if remat
             else _enc_layer(lp, x, cfg))
    return model.enc_norm(x, cfg.norm_eps)


def _dec_layer(lp: DecLayer, x: torch.Tensor,
               enc_out: Optional[torch.Tensor], lc: Optional[Cache],
               cfg: ModelConfig, cache_index: Optional[L.Position]
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """One decoder layer; returns (x, its new cache entry or None)."""
    cdt = cfg.cdt
    h = lp.ln1(x, cfg.norm_eps)
    mix, nself = lp.attn(h, cache=None if lc is None else lc["self"],
                         cache_index=cache_index)
    x = x + mix
    hx = lp.ln_x(x, cfg.norm_eps)
    if lc is not None and enc_out is None:
        # cross K/V already cached at prefill: score against them
        mixx = _cross_from_cache(lp.xattn, hx, lc["cross"], cfg)
        ncross = lc["cross"]
    else:
        mixx, _ = lp.xattn(hx, kv_source=enc_out, causal=False)
        ncross = None
        if lc is not None:
            # cache cross K/V for subsequent decode steps
            e = enc_out.to(cdt)
            k = L.project_heads(e, lp.xattn.wk.to(cdt))
            v = L.project_heads(e, lp.xattn.wv.to(cdt))
            ncross = {"k": k.to(lc["cross"]["k"].dtype),
                      "v": v.to(lc["cross"]["v"].dtype)}
    x = x + mixx
    x = x + lp.mlp(lp.ln2(x, cfg.norm_eps))
    return x, None if lc is None else {"self": nself, "cross": ncross}


def decode(
    model: EncDec,
    tokens: torch.Tensor,                 # (B, S)
    enc_out: Optional[torch.Tensor],      # (B, enc_seq, d); None if cached
    cfg: ModelConfig,
    caches: Optional[List[Cache]] = None,
    cache_index: Optional[L.Position] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
    cdt = cfg.cdt
    s = tokens.shape[1]
    x = model.embed[tokens].to(cdt)
    start = 0 if cache_index is None else cache_index
    x = x + _slice_clamped(model.dec_pos, start, s).to(cdt)[None]

    new_caches = None if caches is None else []
    for i, lp in enumerate(model.dec):
        if caches is None:
            x, _ = (remat_call(_dec_layer, "none", lp, x, enc_out, None, cfg,
                               cache_index) if remat
                    else _dec_layer(lp, x, enc_out, None, cfg, cache_index))
        else:
            x, nc = _dec_layer(lp, x, enc_out, caches[i], cfg, cache_index)
            new_caches.append(nc)

    x = model.final_norm(x, cfg.norm_eps)
    return unembed_logits(x, model.embed.T, cfg), new_caches


def _cross_from_cache(pa: L.Attention, hx: torch.Tensor,
                      cross: Dict[str, torch.Tensor], cfg: ModelConfig
                      ) -> torch.Tensor:
    """Cross-attention against cached encoder K/V (decode steps)."""
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kh
    cdt = cfg.cdt
    q = L.project_heads(hx, pa.wq.to(cdt))
    kf = torch.repeat_interleave(cross["k"].to(cdt), g, dim=2)
    vf = torch.repeat_interleave(cross["v"].to(cdt), g, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kf.float()) / math.sqrt(hd)
    pr = torch.softmax(scores, dim=-1).to(cdt)
    out = torch.einsum("bhqs,bshd->bqhd", pr, vf)
    return L.merge_heads(out, pa.wo.to(cdt))
