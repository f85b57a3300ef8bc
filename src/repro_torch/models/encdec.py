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

from repro_torch.distributed.sharding import (Placed, each, gather_axis,
                                              on_every_shard, place,
                                              to_whole)
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
    x = T._residual(x, mix)
    return T._residual(x, lp.mlp(lp.ln2(x, cfg.norm_eps)))


def encode(model: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = False):
    """frames: (B, enc_seq, d) precomputed embeddings (stub frontend).
    A placed model places them in the residual stream's layout
    (``transformer.stream_spec``: each model shard's positions where the
    model extent divides ``enc_seq``), runs every layer as the decoder's
    (attention non-causal and tensor-parallel, each block's input
    gathered over ``model`` and its output reduce-scattered back), norms
    the pieces and returns the encoder output gathered over ``model``
    once, whole on each model shard of a data group, for every decoder
    layer's cross K/V.  With
    ``remat=True`` each layer is checkpointed (:func:`remat_call`), as
    the reference checkpoints its encoder scan's body."""
    cdt = cfg.cdt
    if isinstance(model.embed, Placed):
        x = T.place_inputs(frames, model.mesh, model.rules, cfg)
        x = T.add_positions_mesh(x, model.enc_pos, 0, cfg)
    else:
        x = frames.to(cdt) + model.enc_pos.to(cdt)[None]
    for lp in model.enc:
        x = (remat_call(_enc_layer, "none", lp, x, cfg) if remat
             else _enc_layer(lp, x, cfg))
    x = model.enc_norm(x, cfg.norm_eps)
    return gather_axis(x, "model") if isinstance(x, Placed) else x


def _dec_layer(lp: DecLayer, x: torch.Tensor,
               enc_out: Optional[torch.Tensor], lc: Optional[Cache],
               cfg: ModelConfig, cache_index: Optional[L.Position]
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """One decoder layer; returns (x, its new cache entry or None)."""
    cdt = cfg.cdt
    placed = isinstance(x, Placed)
    h = lp.ln1(x, cfg.norm_eps)
    mix, nself = lp.attn(h, cache=None if lc is None else lc["self"],
                         cache_index=cache_index)
    x = T._residual(x, mix)
    hx = lp.ln_x(x, cfg.norm_eps)
    if lc is not None and enc_out is None:
        # cross K/V already cached at prefill: score against them
        mixx = (_cross_from_cache_mesh if placed else _cross_from_cache)(
            lp.xattn, hx, lc["cross"], cfg)
        ncross = lc["cross"]
    else:
        mixx, _ = lp.xattn(hx, kv_source=enc_out, causal=False)
        ncross = None
        if lc is not None and placed:
            ncross = _cache_cross_mesh(lp.xattn, enc_out, lc["cross"], cfg)
        elif lc is not None:
            # cache cross K/V for subsequent decode steps
            e = enc_out.to(cdt)
            k = L.project_heads(e, lp.xattn.wk.to(cdt))
            v = L.project_heads(e, lp.xattn.wv.to(cdt))
            ncross = {"k": k.to(lc["cross"]["k"].dtype),
                      "v": v.to(lc["cross"]["v"].dtype)}
    x = T._residual(x, mixx)
    x = T._residual(x, lp.mlp(lp.ln2(x, cfg.norm_eps)))
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
    if isinstance(model.embed, Placed):
        return _decode_mesh(model, tokens, enc_out, cfg, caches, cache_index,
                            remat)
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


# ----------------------------------------------------------------------
# over a device mesh
# ----------------------------------------------------------------------
def _decode_mesh(model: EncDec, tokens: torch.Tensor, enc_out: Optional[Placed],
                 cfg: ModelConfig, caches: Optional[List[Cache]],
                 cache_index: Optional[L.Position], remat: bool = False
                 ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
    """:func:`decode` over the model's device mesh, eagerly: the tokens
    looked up in the vocab-sharded table with the batch on ``data``, the
    learned positions added (``dec_pos``'s fsdp parts gathered), the
    residual stream in the decoder's layout
    (``transformer.stream_spec``: seq-placed where the model extent
    divides the tokens), each layer's self-attention, cross-attention
    (against the whole encoder output) and MLP tensor-parallel, the final
    norm on the pieces, the tied logits vocab-parallel over the gathered
    stream and gathered whole on the mesh's first device.  The caches
    are placed: self K/V written in place, the
    cross K/V projected at prefill into the ``kv_seq``-sharded cache.
    With ``remat=True`` (training, no caches) each layer is checkpointed
    with the placed ``enc_out`` among its arguments, so every layer's
    cross-attention gradient reaches the encoder output through that
    layer's recompute, as the reference's checkpointed decoder scan
    (``encdec.py:126-161``) carries it."""
    mesh, rules = model.mesh, model.rules
    if cache_index is not None:
        # each shard's copy of the position, read on its device
        cache_index = on_every_shard(cache_index, mesh)
    stream = T.stream_spec(rules, tokens.shape[:2] + (cfg.d_model,))
    x = T._embed_mesh(model.embed, place(tokens, mesh, (stream[0], None)),
                      cfg, stream)
    x = T.add_positions_mesh(x, model.dec_pos,
                             0 if cache_index is None else cache_index, cfg)
    new_caches = None if caches is None else []
    for i, lp in enumerate(model.dec):
        if remat and caches is None:
            x, nc = remat_call(_dec_layer, "none", lp, x, enc_out, None, cfg,
                               cache_index)
        else:
            x, nc = _dec_layer(lp, x, enc_out, None if caches is None
                               else caches[i], cfg, cache_index)
        if new_caches is not None:
            new_caches.append(nc)
    x = model.final_norm(x, cfg.norm_eps)
    return to_whole(T._unembed_mesh(gather_axis(x, "model"), model, cfg)), \
        new_caches


def _cache_cross_mesh(pa: L.Attention, enc_out: Placed,
                      cross: Dict[str, Placed], cfg: ModelConfig
                      ) -> Dict[str, Placed]:
    """The prefill's cross K/V: projected from the encoder output per
    ``kv_heads`` shard and written into the ``kv_seq``-sharded ``cross``
    cache through the head-to-sequence relayout, as a self-attention
    prefill writes its keys and values (``layers._prefill_cache``)."""
    wk, wv = L.use_param(pa.wk, cfg), L.use_param(pa.wv, cfg)
    spec = (enc_out.spec[0], None, wk.spec[1], None)
    k = each(L.project_heads, enc_out, wk, spec=spec)
    v = each(L.project_heads, enc_out, wv, spec=spec)
    return L._prefill_cache(k, v, cross, k.shape[1])


def _cross_from_cache_mesh(pa: L.Attention, hx: Placed,
                           cross: Dict[str, Placed], cfg: ModelConfig
                           ) -> Placed:
    """Cross-attention against the ``kv_seq``-sharded encoder K/V (decode
    steps): q column-parallel over ``heads``, gathered over ``model``;
    every query head against each shard's part of the encoder positions
    (all valid), the partial softmaxes combined in rank order
    (``layers.attend_kv_seq``); ``wo`` row-parallel, its output in the
    stream's layout of ``hx`` (gathered first where seq-placed)."""
    stream, hx = hx.spec, gather_axis(hx, "model")
    wq = L.use_param(pa.wq, cfg)
    q = each(L.project_heads, hx, wq, spec=(hx.spec[0], None, wq.spec[1], None))

    def valid(span, device):
        return torch.ones((1, span[1] - span[0]), dtype=torch.bool,
                          device=device)

    out = L.attend_kv_seq(gather_axis(q, "model"), cross["k"], cross["v"],
                          valid, cfg)
    return L.heads_out(out, q, L.use_param(pa.wo, cfg), stream)
