"""RG-LRU recurrent block (port of ``repro/models/recurrent.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training/prefill evaluates the recurrence with a log-depth associative
scan (:func:`associative_scan`, the odd/even recursion of
``jax.lax.associative_scan``, so the products pair up as the
reference's do); decode carries ``h``.

The full Griffin recurrent *block* is: linear in -> causal conv(4) ->
RG-LRU, gated by a parallel GeLU branch, then linear out.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.sharding import (Placed, each, gather_axis,
                                              ranges)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Init, Position, _row_parallel, gelu,
                                       softplus, use_param)
from repro_torch.models.ssm import _causal_conv, _conv_step

Cache = Dict[str, torch.Tensor]
Pair = Tuple[torch.Tensor, torch.Tensor]

_C = 8.0


#: the logical specs of an :class:`RGLRUBlock`'s parameters
#: (``recurrent.py::init_rglru_block``'s spec tree)
RGLRU_SPECS = {
    "w_gate": ("fsdp", "mlp"), "w_lin": ("fsdp", "mlp"),
    "conv": (None, "mlp"), "w_a": ("fsdp", "mlp"), "b_a": (None,),
    "w_i": ("fsdp", "mlp"), "b_i": (None,), "lam": (None,),
    "w_out": ("mlp", "fsdp"),
}


class Gates(NamedTuple):
    """The RG-LRU gates' parameters for the channels a block computes."""

    w_a: torch.Tensor
    b_a: torch.Tensor
    w_i: torch.Tensor
    b_i: torch.Tensor
    lam: torch.Tensor


class RGLRUBlock(nn.Module):
    """The recurrent block's parameters, the reference's names and
    shapes."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        f32 = torch.float32
        self.cfg = cfg
        self.w_gate = init.dense((d, w), cfg.pdt)
        self.w_lin = init.dense((d, w), cfg.pdt)
        self.conv = init.dense((cfg.d_conv, w), cfg.pdt, fan_in=cfg.d_conv)
        self.w_a = init.dense((w, w), cfg.pdt)
        self.b_a = init.full((w,), 0.0, f32)
        self.w_i = init.dense((w, w), cfg.pdt)
        self.b_i = init.full((w,), 0.0, f32)
        # init so a^c in ~(0.9, 0.999): Lambda = softplus^{-1}(-log(a)/c)
        self.lam = init.full((w,), -4.0, f32)
        self.w_out = init.dense((w, d), cfg.pdt, fan_in=w)

    def forward(self, u: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Optional[Position] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        return rglru_block(self, u, self.cfg, cache, cache_index)


def associative_scan(fn: Callable[[Pair, Pair], Pair], elems: Pair,
                     dim: int = 1) -> Pair:
    """Inclusive scan of ``fn`` along ``dim``, by the odd/even recursion
    ``jax.lax.associative_scan`` uses (combine adjacent pairs, scan the
    half, fill in the even positions): log depth, and the same pairing
    of operands."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(ev, od, dim) for ev, od in zip(even, odd))


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """``even[0], odd[0], even[1], odd[1], ...`` along ``dim``."""
    ne, no = even.shape[dim], odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = ne + no
    out = even.new_empty(shape)
    idx = [slice(None)] * even.dim()
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def _combine(c1: Pair, c2: Pair) -> Pair:
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _gates(xf: torch.Tensor, p: Gates,
           own: Optional[torch.Tensor] = None) -> Pair:
    """``a`` and ``sqrt(1 - a^2) * i`` of the fp32 conv output ``xf``:
    ``p`` holds ``w_a``, ``b_a``, ``w_i``, ``b_i`` and ``lam`` for the
    channels computed, ``own`` the conv output of those channels where
    ``xf`` holds more (a model shard's, with ``xf`` whole)."""
    r = torch.sigmoid(xf @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(xf @ p.w_i.float() + p.b_i)
    a = torch.exp(-_C * softplus(p.lam) * r)
    own = xf if own is None else own
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * own)


def _rg_lru(x: torch.Tensor, p: Gates, h0: Optional[torch.Tensor],
            x_all: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, w). Returns (h_seq, h_final). fp32 recurrence.  With
    ``x_all`` (every channel's conv output) the gates of ``x``'s
    channels read it."""
    a, gated = (_gates(x.float(), p) if x_all is None
                else _gates(x_all.float(), p, x.float()))
    if h0 is not None:
        # fold the carried state in as a virtual step at t = -1
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0.float()[:, None], gated], dim=1)
    _, h = associative_scan(_combine, (a, gated), dim=1)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def rglru_block(
    p: RGLRUBlock,
    u: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Cache] = None,
    cache_index: Optional[Position] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    if isinstance(u, Placed):
        return _rglru_block_mesh(p, u, cfg, cache)
    cdt = cfg.cdt
    gate = gelu(u @ p.w_gate.to(cdt))
    x = u @ p.w_lin.to(cdt)

    if cache is not None and u.shape[1] == 1:
        # decode: conv tail + single recurrence step
        cx = torch.cat([cache["conv"], x], dim=1)
        xf = _conv_step(cx, p.conv.to(cdt)).float()          # (B, w)
        a, gated = _gates(xf, p)
        h = (a * cache["h"].float() + gated).to(cdt)
        y = (h * gate[:, 0])[:, None]                        # (B,1,w)
        new_cache = {"h": h, "conv": cx[:, 1:]}
    else:
        tail = cache["conv"] if cache is not None else None
        xc, ntail = _causal_conv(x, p.conv.to(cdt), tail)
        h0 = cache["h"] if cache is not None else None
        h, h_final = _rg_lru(xc, p, h0)
        y = h * gate
        new_cache = None
        if cache is not None:
            new_cache = {"h": h_final.to(cdt), "conv": ntail}
    return y @ p.w_out.to(cdt), new_cache


def _rglru_block_mesh(p: RGLRUBlock, u: Placed, cfg: ModelConfig,
                      cache: Optional[Dict[str, Placed]]
                      ) -> Tuple[Placed, Optional[Dict[str, Placed]]]:
    """The recurrent block over ``u``'s device mesh (``recurrent.py:94-95,
    :123``'s ``mlp`` layout): ``w_gate``, ``w_lin`` and the conv
    column-parallel over the LRU channels, each shard's conv local; its
    output gathered over ``model`` (``x @ w_a`` and ``x @ w_i`` contract
    over every channel) for each shard's columns of ``w_a`` and ``w_i``
    (their fsdp rows gathered over ``data``, used in fp32 as stored);
    ``b_a``, ``b_i`` and ``lam`` sliced to the shard's channels; the
    scan or the decode step local per channel, the caches' ``h`` and
    ``conv`` the shard's channels; ``w_out`` row-parallel.  Channels the
    model extent does not divide are whole on every shard.  A seq-placed
    ``u`` is gathered over ``model`` first, and the output goes back to
    the stream's layout (:func:`~repro_torch.models.layers.to_stream`):
    reduce-scattered where ``w_out`` is split, narrowed where whole."""
    cdt = cfg.cdt
    stream, u = u.spec, gather_axis(u, "model")
    w_gate, w_lin = use_param(p.w_gate, cfg), use_param(p.w_lin, cfg)
    conv = use_param(p.conv, cfg)
    w_a, w_i = gather_axis(p.w_a, "data"), gather_axis(p.w_i, "data")
    spec = (u.spec[0], None, w_gate.spec[1])
    cols = ranges(w_gate, 1)

    def gates(w_a, b_a, w_i, b_i, lam, span):
        lo, hi = span
        return Gates(w_a, b_a[lo:hi], w_i, b_i[lo:hi], lam[lo:hi])

    g = each(gates, w_a, p.b_a, w_i, p.b_i, p.lam, cols, spec=None)
    gate = each(lambda u, w: gelu(u @ w), u, w_gate, spec=spec)
    x = each(torch.matmul, u, w_lin, spec=spec)

    if cache is not None and u.shape[1] == 1:
        cx = each(lambda c, x: torch.cat([c, x], dim=1), cache["conv"], x,
                  spec=cache["conv"].spec)
        xf = each(lambda cx, k: _conv_step(cx, k).float(), cx, conv,
                  spec=spec[::2])
        xf_all = gather_axis(xf, "model")

        def step(xf, xf_all, g, h, gate):
            a, gated = _gates(xf_all, g, xf)
            h = (a * h.float() + gated).to(cdt)
            return (h * gate[:, 0])[:, None], h

        y, h = each(step, xf, xf_all, g, cache["h"], gate,
                    spec=[spec, cache["h"].spec])
        new_cache = {"h": h, "conv": each(lambda cx: cx[:, 1:], cx,
                                          spec=cx.spec)}
    else:
        tail = () if cache is None else (cache["conv"],)
        xc, ntail = each(_causal_conv, x, conv, *tail, spec=[spec, spec])
        xc_all = gather_axis(xc, "model")

        def scan(xc, xc_all, g, gate, *h0):
            h, h_final = _rg_lru(xc, g, h0[0] if h0 else None, xc_all)
            return h * gate, h_final.to(cdt)

        h0 = () if cache is None else (cache["h"],)
        y, h_final = each(scan, xc, xc_all, g, gate, *h0,
                          spec=[spec, spec[::2]])
        new_cache = None if cache is None else {"h": h_final, "conv": ntail}
    return _row_parallel(y, use_param(p.w_out, cfg), torch.matmul,
                         stream), new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, w), dtype=dtype,
                            device=device),
    }
