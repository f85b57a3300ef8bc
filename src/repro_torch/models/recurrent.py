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

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, Position, gelu, softplus
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


def _gates(xf: torch.Tensor, p: RGLRUBlock) -> Pair:
    """``a`` and ``sqrt(1 - a^2) * i`` of the fp32 conv output ``xf``."""
    r = torch.sigmoid(xf @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(xf @ p.w_i.float() + p.b_i)
    a = torch.exp(-_C * softplus(p.lam) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)


def _rg_lru(x: torch.Tensor, p: RGLRUBlock, h0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, w). Returns (h_seq, h_final). fp32 recurrence."""
    a, gated = _gates(x.float(), p)
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


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, w), dtype=dtype,
                            device=device),
    }
