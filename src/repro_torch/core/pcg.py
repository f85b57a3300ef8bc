"""Preconditioned Conjugate Gradient, one iteration at a time (port of
``repro/core/pcg.py:46-77``).

One iteration (paper Algorithm 1 lines 3-8) runs

    ap = A p                                   (K1, stencil7)
    alpha = rz / det_dot(p, ap)                (K2's block reduction)
    x, r, z, rz' = fused_cg_update(...)        (K2)
    beta = rz' / rz ;  p = z + beta p

with ``alpha`` and ``beta`` kept as 0-d device tensors: the step never
pulls a value to the host.  The preconditioner must be diagonal (it
exposes ``inv_diag``, which K2 reads).  We use ``alpha = r'z / p'Ap``,
identical to the paper's ``r'z / r'Ap`` in exact arithmetic.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.spmv import make_det_dot
from repro_torch.core.state import PCGState
from repro_torch.kernels import ops


def init_state(op, precond, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
               dot: Optional[Callable] = None) -> PCGState:
    dot = make_det_dot(op.nblocks) if dot is None else dot
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - op.apply(x0)
    z0 = precond.apply(r0)
    return PCGState(
        x=x0, r=r0, z=z0, p=z0, rz=dot(r0, z0),
        beta_prev=torch.zeros((), dtype=b.dtype, device=b.device), k=0,
    )


def make_step(op_apply: Callable, inv_diag: torch.Tensor,
              nblocks: int) -> Callable[[PCGState], PCGState]:
    """One PCG iteration with the Jacobi-type preconditioner
    ``z = r * inv_diag``; every inner product is the order-pinned
    ``nblocks`` block dot."""
    dot = make_det_dot(nblocks)

    def step(state: PCGState) -> PCGState:
        ap = op_apply(state.p)                                   # (A) SpMV
        alpha = state.rz / dot(state.p, ap)                      # line 3
        x, r, z, rz_new = ops.fused_cg_update(                   # lines 4-7a
            state.x, state.r, state.p, ap, alpha, inv_diag, nblocks)
        beta = rz_new / state.rz                                 # line 7
        p = z + beta * state.p                                   # line 8
        return PCGState(x=x, r=r, z=z, p=p, rz=rz_new, beta_prev=beta,
                        k=state.k + 1)

    return step
