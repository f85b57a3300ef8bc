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

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, Position, softplus

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
    single-token recurrent decode when s == 1 with a cache."""
    b, s, d = u.shape
    di = cfg.expand * d
    hp = cfg.ssm_head_dim
    nh = di // hp
    cdt = cfg.cdt

    z = u @ p.w_z.to(cdt)
    x = u @ p.w_x.to(cdt)
    bm = u @ p.w_b.to(cdt)
    cm = u @ p.w_c.to(cdt)
    dt = softplus((u.float() @ p.w_dt.float()) + p.dt_bias)
    a = -torch.exp(p.a_log)  # (nh,)

    if cache is not None and s == 1:
        # ---- decode: recurrent update ----
        cx = torch.cat([cache["conv_x"], x], dim=1)
        xb = torch.cat([cache["conv_b"], bm], dim=1)
        xcn = torch.cat([cache["conv_c"], cm], dim=1)
        xcv = _conv_step(cx, p.conv_x.to(cdt))
        bcv = _conv_step(xb, p.conv_b.to(cdt))
        ccv = _conv_step(xcn, p.conv_c.to(cdt))
        xh = xcv.reshape(b, nh, hp)
        dt1 = dt[:, 0]                                         # (b, nh)
        decay = torch.exp(dt1 * a).to(cdt)                     # (b, nh)
        upd = torch.einsum("bn,bh,bhp->bhnp", bcv, dt1.to(cdt), xh)
        h = decay[..., None, None] * cache["ssm"] + upd
        y = torch.einsum("bn,bhnp->bhp", ccv, h)
        y = y + p.d_skip.to(cdt)[None, :, None] * xh
        y = y.reshape(b, 1, di)
        new_cache = {"ssm": h, "conv_x": cx[:, 1:], "conv_b": xb[:, 1:],
                     "conv_c": xcn[:, 1:]}
    else:
        # ---- train/prefill: chunked SSD ----
        tail_x = cache["conv_x"] if cache is not None else None
        tail_b = cache["conv_b"] if cache is not None else None
        tail_c = cache["conv_c"] if cache is not None else None
        xcv, ntx = _causal_conv(x, p.conv_x.to(cdt), tail_x)
        bcv, ntb = _causal_conv(bm, p.conv_b.to(cdt), tail_b)
        ccv, ntc = _causal_conv(cm, p.conv_c.to(cdt), tail_c)
        xh = xcv.reshape(b, s, nh, hp)
        h0 = cache["ssm"] if cache is not None else None
        y, h_final = ssd_chunked(xh, dt, a, bcv, ccv, cfg.ssm_chunk, h0)
        y = y + p.d_skip.to(cdt)[None, None, :, None] * xh
        y = y.reshape(b, s, di)
        new_cache = None
        if cache is not None:
            new_cache = {"ssm": h_final, "conv_x": ntx, "conv_b": ntb,
                         "conv_c": ntc}

    # gated RMSNorm (mamba2) + output projection
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
         ).to(cdt) * p.norm.to(cdt)
    return y @ p.w_out.to(cdt), new_cache


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
