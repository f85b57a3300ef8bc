"""Mamba-2 block: state-space duality (SSD), chunked scan (port of
``repro/models/ssm.py``; arXiv:2405.21060).

The SSD algorithm splits the sequence into chunks of ``Q`` tokens:
intra-chunk terms are a (Q x Q) decay-masked attention-like product,
inter-chunk terms flow through a sequential loop over per-chunk states.
Decode carries the (nh, N, hp) state per layer.

Decay exponentials run in fp32, matmuls in the compute dtype, with the
reference's casts at the same points: the intra-chunk ``scores`` are cast
to ``cdt`` before the ``y_diag`` einsum and the state ``h`` is carried
in ``cdt``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (Placed, PerShard, each,
                                              gather_axis, reduce_sum,
                                              reshard)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Init, Position, _row_parallel,
                                       softplus, use_param)

Cache = Dict[str, torch.Tensor]


#: the logical specs of an :class:`SSMBlock`'s parameters
#: (``ssm.py::init_ssm_block``'s spec tree)
SSM_SPECS = {
    "w_z": ("fsdp", "mlp"), "w_x": ("fsdp", "mlp"),
    "w_b": ("fsdp", None), "w_c": ("fsdp", None),
    "w_dt": ("fsdp", None), "dt_bias": (None,), "a_log": (None,),
    "d_skip": (None,), "conv_x": (None, "mlp"), "conv_b": (None, None),
    "conv_c": (None, None), "norm": ("mlp",), "w_out": ("mlp", "fsdp"),
}


class SSMBlock(nn.Module):
    """The Mamba-2 mixer's parameters, the reference's names and shapes."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d = cfg.d_model
        di = cfg.expand * d
        n = cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        w = cfg.d_conv
        f32 = torch.float32
        self.cfg = cfg
        self.w_z = init.dense((d, di), cfg.pdt)
        self.w_x = init.dense((d, di), cfg.pdt)
        self.w_b = init.dense((d, n), cfg.pdt)
        self.w_c = init.dense((d, n), cfg.pdt)
        self.w_dt = init.dense((d, nh), cfg.pdt)
        self.dt_bias = init.full((nh,), 0.0, f32)
        self.a_log = init.const(torch.log(torch.arange(1, nh + 1, dtype=f32)))
        self.d_skip = init.full((nh,), 1.0, f32)
        self.conv_x = init.dense((w, di), cfg.pdt, fan_in=w)
        self.conv_b = init.dense((w, n), cfg.pdt, fan_in=w)
        self.conv_c = init.dense((w, n), cfg.pdt, fan_in=w)
        self.norm = init.full((di,), 1.0, cfg.pdt)
        self.w_out = init.dense((di, d), cfg.pdt, fan_in=di)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Optional[Position] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        return ssm_block(self, u, self.cfg, cache, cache_index)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq. x: (B,S,C); kernel: (w,C).

    Returns (y, new_tail) where tail carries the last w-1 inputs for
    decode continuation.
    """
    w = kernel.shape[0]
    pad = tail if tail is not None else x.new_zeros((x.shape[0], w - 1,
                                                     x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * kernel[i][None, None] for i in range(w))
    return F.silu(y), xp[:, -(w - 1):]


def _conv_step(window: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One decode position of :func:`_causal_conv`: ``window (B, w, C)``
    holds the last ``w`` inputs."""
    w = kernel.shape[0]
    return F.silu(sum(window[:, -w + i] * kernel[i] for i in range(w)))


def _ssd_chunk(h, xq, dtq, bq, cq_, a, causal):
    """One SSD chunk: the intra-chunk (Q x Q decay-masked) product plus
    the carried state's contribution; returns (the new state, the
    chunk's y)."""
    cdt = xq.dtype
    dtq = dtq.float()
    da = dtq * a                                            # (b,q,nh)
    cum = torch.cumsum(da, dim=1)
    seg = cum[:, :, None, :] - cum[:, None, :, :]           # (b,qi,qj,nh)
    # mask BEFORE exp: exp(+large) = inf
    seg = torch.where(causal[None, :, :, None], seg,
                      torch.full((), -1e30, device=xq.device))
    decay = torch.exp(seg)
    cb = torch.einsum("bqn,bkn->bqk", cq_.float(), bq.float())
    scores = (cb[..., None] * decay * dtq[:, None, :, :]).to(cdt)
    y_diag = torch.einsum("bqkh,bkhp->bqhp", scores, xq)
    # carried-state contribution + state update
    inner_decay = torch.exp(cum).to(cdt)                    # (b,q,nh)
    y_off = torch.einsum("bqn,bhnp,bqh->bqhp", cq_, h, inner_decay)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)
    wx = (dtq * decay_to_end).to(cdt)
    h = (torch.exp(cum[:, -1, :]).to(cdt)[..., None, None] * h
         + torch.einsum("bqn,bqh,bqhp->bhnp", bq, wx, xq))
    return h, y_diag + y_off


def ssd_chunked(
    x: torch.Tensor,       # (B, S, nh, hp)
    dt: torch.Tensor,      # (B, S, nh)   post-softplus
    a: torch.Tensor,       # (nh,)        negative
    bm: torch.Tensor,      # (B, S, N)
    cm: torch.Tensor,      # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y, final_state (B, nh, N, hp)).  Under
    autograd each chunk is checkpointed (``layers._chunk_checkpoint``,
    the reference's ``nothing_saveable`` scan body): its (b, Q, Q, nh)
    decay and score tensors are recomputed in the backward, not saved
    a chunk."""
    b, s, nh, hp = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    while s % q:        # odd lengths (tests): shrink to a divisor
        q -= 1
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    h = x.new_zeros((b, nh, n, hp)) if h0 is None else h0.to(x.dtype)
    ys = []
    for c0 in range(0, s, q):
        h, y = L._chunk_checkpoint(_ssd_chunk, h, x[:, c0:c0 + q],
                                   dt[:, c0:c0 + q], bm[:, c0:c0 + q],
                                   cm[:, c0:c0 + q], a, causal)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y, h


def ssm_block(
    p: SSMBlock,
    u: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Cache] = None,
    cache_index: Optional[Position] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full Mamba-2 mixer. Train/prefill when cache is None or s>1;
    single-token recurrent decode when s == 1 with a cache.  A placed
    ``u`` runs :func:`_ssm_block_mesh`."""
    if isinstance(u, Placed):
        return _ssm_block_mesh(p, u, cfg, cache)
    cdt = cfg.cdt
    w = {name: getattr(p, name).to(cdt) for name in _CAST}
    w.update({name: getattr(p, name) for name in _WHOLE_F32})
    nh = cfg.expand * cfg.d_model // cfg.ssm_head_dim
    y, new_cache = _ssm_mix(u, w, cfg, cache, (0, nh))
    # gated RMSNorm (mamba2) + output projection
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
         ).to(cdt) * p.norm.to(cdt)
    return y @ p.w_out.to(cdt), new_cache


#: the block's parameters used in the compute dtype, and the fp32 ones
#: used as they are stored (``w_dt`` whole in fp32, as the reference
#: casts it)
_CAST = ("w_z", "w_x", "w_b", "w_c", "conv_x", "conv_b", "conv_c")
_PER_HEAD = ("dt_bias", "a_log", "d_skip")
_WHOLE_F32 = ("w_dt",) + _PER_HEAD


def _ssm_mix(u: torch.Tensor, w: Dict[str, torch.Tensor], cfg: ModelConfig,
             cache: Optional[Cache], heads: Tuple[int, int]
             ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The mixer up to its gated RMSNorm: ``y * silu(z)`` and the new
    cache, for the SSD heads ``heads = (lo, hi)`` whose ``d_inner``
    columns ``w_z``, ``w_x``, ``conv_x`` and the cache's ``conv_x`` and
    ``ssm`` hold (all of them on one device); ``w_dt``, ``dt_bias``,
    ``a_log`` and ``d_skip`` are whole and sliced to those heads."""
    b, s, _ = u.shape
    hp = cfg.ssm_head_dim
    lo, hi = heads
    nh = hi - lo
    di = nh * hp
    cdt = cfg.cdt

    z = u @ w["w_z"]
    x = u @ w["w_x"]
    bm = u @ w["w_b"]
    cm = u @ w["w_c"]
    dt = softplus((u.float() @ w["w_dt"].float())[..., lo:hi]
                  + w["dt_bias"][lo:hi])
    a = -torch.exp(w["a_log"][lo:hi])  # (nh,)
    d_skip = w["d_skip"][lo:hi].to(cdt)

    if cache is not None and s == 1:
        # ---- decode: recurrent update ----
        cx = torch.cat([cache["conv_x"], x], dim=1)
        xb = torch.cat([cache["conv_b"], bm], dim=1)
        xcn = torch.cat([cache["conv_c"], cm], dim=1)
        xcv = _conv_step(cx, w["conv_x"])
        bcv = _conv_step(xb, w["conv_b"])
        ccv = _conv_step(xcn, w["conv_c"])
        xh = xcv.reshape(b, nh, hp)
        dt1 = dt[:, 0]                                         # (b, nh)
        decay = torch.exp(dt1 * a).to(cdt)                     # (b, nh)
        upd = torch.einsum("bn,bh,bhp->bhnp", bcv, dt1.to(cdt), xh)
        h = decay[..., None, None] * cache["ssm"] + upd
        y = torch.einsum("bn,bhnp->bhp", ccv, h)
        y = y + d_skip[None, :, None] * xh
        y = y.reshape(b, 1, di)
        new_cache = {"ssm": h, "conv_x": cx[:, 1:], "conv_b": xb[:, 1:],
                     "conv_c": xcn[:, 1:]}
    else:
        # ---- train/prefill: chunked SSD ----
        tail_x = cache["conv_x"] if cache is not None else None
        tail_b = cache["conv_b"] if cache is not None else None
        tail_c = cache["conv_c"] if cache is not None else None
        xcv, ntx = _causal_conv(x, w["conv_x"], tail_x)
        bcv, ntb = _causal_conv(bm, w["conv_b"], tail_b)
        ccv, ntc = _causal_conv(cm, w["conv_c"], tail_c)
        xh = xcv.reshape(b, s, nh, hp)
        h0 = cache["ssm"] if cache is not None else None
        y, h_final = ssd_chunked(xh, dt, a, bcv, ccv, cfg.ssm_chunk, h0)
        y = y + d_skip[None, None, :, None] * xh
        y = y.reshape(b, s, di)
        new_cache = None
        if cache is not None:
            new_cache = {"ssm": h_final, "conv_x": ntx, "conv_b": ntb,
                         "conv_c": ntc}
    return y * F.silu(z), new_cache


# ----------------------------------------------------------------------
# over a device mesh
# ----------------------------------------------------------------------
def heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the block runs head-parallel over ``mesh``'s ``model``
    axis: its extent (longer than 1) divides the SSD heads, and so
    ``d_inner``, whose ``mlp`` columns are whole heads.  Otherwise every
    model shard runs the block whole: ``conv_x`` and ``d_inner``'s
    leaves may still be split (an extent that divides ``d_inner`` and
    not the heads), and are gathered over ``model`` first."""
    model = mesh.shape["model"]
    nh = cfg.expand * cfg.d_model // cfg.ssm_head_dim
    return model > 1 and nh % model == 0


def gated_rmsnorm_mesh(y: Placed, scale: Placed, cfg: ModelConfig) -> Placed:
    """The gated RMSNorm over ``d_inner`` of a placed ``y`` (already
    gated, its ``d_inner`` on ``model`` or whole) with ``scale`` laid out
    like it: each shard's fp32 sum of squares, summed over ``model`` in
    rank order when ``d_inner`` is split, over the whole ``d_inner``
    before the ``rsqrt``."""
    di = cfg.expand * cfg.d_model
    cdt = cfg.cdt
    ss = each(lambda y: (y.float() * y.float()).sum(-1, keepdim=True), y,
              spec=y.spec[:2] + (None,))
    if y.spec[2] is not None:
        ss = reduce_sum(ss, y.spec[2])

    def norm(y, ss, sc):
        return (y.float() * torch.rsqrt(ss / di + cfg.norm_eps)).to(cdt) * sc

    return each(norm, y, ss, scale, spec=y.spec)


def _ssm_block_mesh(p: SSMBlock, u: Placed, cfg: ModelConfig,
                    cache: Optional[Dict[str, Placed]]
                    ) -> Tuple[Placed, Optional[Dict[str, Placed]]]:
    """The mixer over ``u``'s device mesh (``ssm.py:153``'s ``mlp``
    layout): with :func:`heads_split`, ``w_z``, ``w_x``, ``conv_x``,
    ``norm`` and the caches' ``conv_x`` and ``ssm`` are each shard's
    ``nh / model`` whole heads, the SSD chunk scan or the one-token
    decode runs on them, the gated RMSNorm sums its squares over
    ``model`` (:func:`gated_rmsnorm_mesh`) and ``w_out`` is
    row-parallel; ``w_b``, ``w_c``, ``w_dt`` and the B/C convolutions
    are whole on every model shard (their fsdp parts gathered over
    ``data``).  Without the split each model shard runs the block
    whole, its split leaves gathered, and keeps its part of the new
    ``conv_x``.  The scan and the convolutions run on the input gathered
    over ``model`` from a seq-placed stream; the output goes back to the
    stream's layout (:func:`~repro_torch.models.layers.to_stream`):
    reduce-scattered where ``w_out`` is split (a partial), narrowed to
    each shard's positions where the block ran whole."""
    mesh = u.mesh
    split = heads_split(cfg, mesh)
    stream, u = u.spec, gather_axis(u, "model")

    def shard_local(t: Placed) -> Placed:
        return t if split else gather_axis(t, "model")

    w = {name: shard_local(use_param(getattr(p, name), cfg))
         for name in _CAST}
    w["w_dt"] = gather_axis(p.w_dt, "data")
    w.update({name: getattr(p, name) for name in _PER_HEAD})
    names = list(w)
    c = None if cache is None else {k: shard_local(t) for k, t in cache.items()}
    nh = cfg.expand * cfg.d_model // cfg.ssm_head_dim
    nl = nh // mesh.shape["model"] if split else nh
    heads = PerShard((m * nl, (m + 1) * nl) if split else (0, nh)
                     for m in mesh.ranks("model"))

    def mix(u, span, *args):
        vals = dict(zip(names, args))
        return _ssm_mix(u, vals, cfg, None if c is None else dict(
            zip(c, args[len(names):])), span)

    out = each(mix, u, heads, *w.values(), *([] if c is None else c.values()),
               spec=None)
    bspec, mspec = u.spec[0], "model" if split else None
    y = Placed([o[0] for o in out], mesh, (bspec, None, mspec))
    y = gated_rmsnorm_mesh(y, shard_local(use_param(p.norm, cfg)), cfg)
    w_out = shard_local(use_param(p.w_out, cfg))
    new_cache = None
    if cache is not None:
        specs = {"ssm": (bspec, mspec, None, None),
                 "conv_x": (bspec, None, mspec),
                 "conv_b": (bspec, None, None), "conv_c": (bspec, None, None)}
        new_cache = {k: reshard(Placed([o[1][k] for o in out], mesh,
                                       specs[k]), cache[k].spec)
                     for k in cache}
    return _row_parallel(y, w_out, torch.matmul, stream), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
    di = cfg.expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    w = cfg.d_conv
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {
        "ssm": z(batch, nh, cfg.ssm_state, cfg.ssm_head_dim),
        "conv_x": z(batch, w - 1, di),
        "conv_b": z(batch, w - 1, cfg.ssm_state),
        "conv_c": z(batch, w - 1, cfg.ssm_state),
    }
