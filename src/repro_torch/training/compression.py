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

A placed gradient (a model on a device mesh) is quantized piece by
piece on each shard's stream, its residual placed with its spec.  Its
scale is taken over the leaf's whole gradient, as the reference's
global ``max |g|`` is: each part's maximum on its shard, the largest of
them on the mesh's first device, moved to every shard, so every piece
quantizes with the same scale.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

from repro_torch.distributed.sharding import (Placed, each, on_every_shard,
                                              placed_full, replica_groups)

Tree = Dict[str, Union[torch.Tensor, Placed]]


def _scale(corrected: Union[torch.Tensor, Placed]) -> torch.Tensor:
    """``clamp(max |corrected|, 1e-12) / 127`` over the whole leaf (a
    placed one's parts' maxima, one replica each, compared on the mesh's
    first device)."""
    if not isinstance(corrected, Placed):
        top = torch.max(torch.abs(corrected))
    else:
        mesh, parts = corrected.mesh, []
        for group in replica_groups(corrected):
            s = group[0]
            with mesh.on(s):
                part = torch.max(torch.abs(corrected.pieces[s]))
            parts.append(mesh.move(part, None, src=s))
        top = torch.max(torch.stack(parts))
    return torch.clamp(top, min=1e-12) / 127.0


def _quantize(corrected: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    return q, corrected - q.float() * scale


class Compressed(NamedTuple):
    q: Tree       # int8 tensors
    scale: Tree   # fp32 per-tensor scales (0-d)


class GradCompression(NamedTuple):
    """Error-feedback state: the local quantization residual per tensor."""

    residual: Tree

    @classmethod
    def init(cls, params: Mapping[str, Union[torch.Tensor, Placed]]
             ) -> "GradCompression":
        return cls(residual={
            n: placed_full(p.shape, p.spec, p.mesh, 0.0, torch.float32)
            if isinstance(p, Placed) else
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()})

    def compress(self, grads: Mapping[str, Union[torch.Tensor, Placed]]
                 ) -> Tuple[Compressed, "GradCompression"]:
        q, s, r = {}, {}, {}
        with torch.no_grad():
            for name, g in grads.items():
                res = self.residual[name]
                if not isinstance(g, Placed):
                    corrected = g.float() + res
                    s[name] = _scale(corrected)
                    q[name], r[name] = _quantize(corrected, s[name])
                    continue
                corrected = each(lambda g, res: g.float() + res, g, res,
                                 spec=g.spec)
                s[name] = _scale(corrected)
                q[name], r[name] = each(
                    _quantize, corrected, on_every_shard(s[name], g.mesh),
                    spec=[g.spec, g.spec])
        return Compressed(q, s), GradCompression(residual=r)


def decompress(c: Compressed) -> Tree:
    out = {}
    for n, q in c.q.items():
        if isinstance(q, Placed):
            out[n] = each(lambda q, sc: q.float() * sc, q,
                          on_every_shard(c.scale[n], q.mesh), spec=q.spec)
        else:
            out[n] = q.float() * c.scale[n]
    return out


def compressed_bytes(c: Compressed) -> int:
    """The int8 payload's bytes (each leaf's whole gradient once) and
    its scales'."""
    return (sum(math.prod(q.shape) for q in c.q.values())
            + 4 * len(c.scale))


def apply(grads: Mapping[str, torch.Tensor], ef_state: GradCompression
          ) -> Tuple[Tree, GradCompression]:
    """Quantize -> (conceptual reduce) -> dequantize, with error feedback.
    Returns (approx_grads, new_ef_state)."""
    c, new_state = ef_state.compress(grads)
    return decompress(c), new_state
