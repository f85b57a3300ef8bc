"""Gradient compression with error feedback (port of
``repro/training/compression.py``).

Per-tensor symmetric int8 quantization cuts a gradient all-reduce's
traffic 4x against fp32 (2x against bf16); **error feedback** (Seide et
al. '14 / Karimireddy et al. '19) accumulates the quantization residual
locally and re-injects it the next step, preserving convergence.

Usage::

    comp = GradCompression.init(params)
    grads_q, comp = comp.compress(grads)     # int8 + scales (+ residual)
    # ... all-reduce the int8 payload ...
    grads = decompress(grads_q)

Trees are mappings of names to tensors.  On one card nothing is reduced:
:func:`apply` quantizes and dequantizes around the optimizer update, so
the numerics are exercised as a reducer would see them.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Compressed(NamedTuple):
    q: Tree       # int8 tensors
    scale: Tree   # fp32 per-tensor scales (0-d)


class GradCompression(NamedTuple):
    """Error-feedback state: the local quantization residual per tensor."""

    residual: Tree

    @classmethod
    def init(cls, params: Mapping[str, torch.Tensor]) -> "GradCompression":
        return cls(residual={n: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for n, p in params.items()})

    def compress(self, grads: Mapping[str, torch.Tensor]
                 ) -> Tuple[Compressed, "GradCompression"]:
        q, s, r = {}, {}, {}
        with torch.no_grad():
            for name, g in grads.items():
                corrected = g.float() + self.residual[name]
                scale = torch.clamp(torch.max(torch.abs(corrected)),
                                    min=1e-12) / 127.0
                q[name] = torch.clamp(torch.round(corrected / scale),
                                      -127, 127).to(torch.int8)
                s[name] = scale
                r[name] = corrected - q[name].float() * scale
        return Compressed(q, s), GradCompression(residual=r)


def decompress(c: Compressed) -> Tree:
    return {n: q.float() * c.scale[n] for n, q in c.q.items()}


def compressed_bytes(c: Compressed) -> int:
    return sum(q.numel() for q in c.q.values()) + 4 * len(c.scale)


def apply(grads: Mapping[str, torch.Tensor], ef_state: GradCompression
          ) -> Tuple[Tree, GradCompression]:
    """Quantize -> (conceptual reduce) -> dequantize, with error feedback.
    Returns (approx_grads, new_ef_state)."""
    c, new_state = ef_state.compress(grads)
    return decompress(c), new_state
