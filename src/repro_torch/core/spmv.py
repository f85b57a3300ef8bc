"""Order-pinned block-hierarchical reductions (port of
``repro/core/spmv.py:60-96``, without the mesh).

The solve's inner products combine per-partition-block partial sums in a
fixed left-to-right order, so the trajectory does not depend on how a
library happens to reassociate a global sum.  On CUDA tensors
:func:`make_det_dot` runs kernel K2's block-partial reduction
(``ops.det_dot``), the same code the fused update uses for ``rz'``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def make_det_dot(nblocks: int):
    """Build ``dot(a, b)``: per-block partials, then a left-to-right chain
    over the ``nblocks`` partials; a 0-d tensor on ``a``'s device."""

    def det_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ops.det_dot(a, b, nblocks)

    return det_dot


def make_det_rowdots(nblocks: int):
    """Row-batched :func:`make_det_dot`: ``rowdots(M, w)[i] ==
    det_dot(M[i], w)`` in exact arithmetic for an ``(rows, n)`` matrix,
    with the same block-hierarchical order (plain PyTorch)."""

    def det_rowdots(m_rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        rows = m_rows.shape[0]
        partials = (m_rows * w[None, :]).reshape(rows, nblocks, -1).sum(dim=2)
        acc = partials[:, 0]
        for i in range(1, nblocks):
            acc = acc + partials[:, i]
        return acc

    return det_rowdots
