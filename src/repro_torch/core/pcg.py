"""Preconditioned Conjugate Gradient, one iteration at a time (port of
``repro/core/pcg.py:46-77``).

One iteration (paper Algorithm 1 lines 3-8) runs

    ap = A p                                   (K1, stencil7)
    alpha = rz / det_dot(p, ap)                (K2's block reduction)
    x, r, z, rz' = fused_cg_update(...)        (K2)
    beta = rz' / rz ;  p = z + beta p

with ``alpha`` and ``beta`` kept as 0-d device tensors: the step never
pulls a value to the host.  :func:`make_persist_step` is the same
iteration with K4 (``ops.fused_cg_update_persist``) in place of K2: it
also hands back the erasure stripe of the input ``p`` (its chunks and
parity), and its state is bitwise the K2 step's.  The preconditioner must be diagonal (it
exposes ``inv_diag``, which K2 reads).  We use ``alpha = r'z / p'Ap``,
identical to the paper's ``r'z / r'Ap`` in exact arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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


def _iteration(state: PCGState, op_apply: Callable, dot: Callable,
               update: Callable) -> Tuple[PCGState, tuple]:
    """Lines 3-8 around ``update`` (K2 or K4, which return ``x, r, z,
    rz'`` first); returns the new state and ``update``'s other outputs."""
    ap = op_apply(state.p)                                       # (A) SpMV
    alpha = state.rz / dot(state.p, ap)                          # line 3
    x, r, z, rz_new, *extra = update(state.x, state.r, state.p,  # lines 4-7a
                                     ap, alpha)
    beta = rz_new / state.rz                                     # line 7
    p = z + beta * state.p                                       # line 8
    return PCGState(x=x, r=r, z=z, p=p, rz=rz_new, beta_prev=beta,
                    k=state.k + 1), tuple(extra)


def make_step(op_apply: Callable, inv_diag: torch.Tensor,
              nblocks: int) -> Callable[[PCGState], PCGState]:
    """One PCG iteration with the Jacobi-type preconditioner
    ``z = r * inv_diag``; every inner product is the order-pinned
    ``nblocks`` block dot."""
    dot = make_det_dot(nblocks)

    def update(x, r, p, ap, alpha):
        return ops.fused_cg_update(x, r, p, ap, alpha, inv_diag, nblocks)

    def step(state: PCGState) -> PCGState:
        return _iteration(state, op_apply, dot, update)[0]

    return step


def make_persist_step(op_apply: Callable, inv_diag: torch.Tensor,
                      nblocks: int, k_data: int, nparity: int
                      ) -> Callable[[PCGState], Tuple[PCGState, Dict]]:
    """:func:`make_step` with K4 in place of K2: returns ``(state,
    {"p": (chunks, parity)})``, the stripe of the *input* state's ``p``
    (``k_data`` chunks per partition block and ``nparity`` GF(2^8) parity
    rows).  The state is bitwise :func:`make_step`'s."""
    dot = make_det_dot(nblocks)

    def update(x, r, p, ap, alpha):
        return ops.fused_cg_update_persist(x, r, p, ap, alpha, inv_diag,
                                           nblocks, k_data, nparity)

    def step(state: PCGState) -> Tuple[PCGState, Dict]:
        new, (chunks, parity) = _iteration(state, op_apply, dot, update)
        return new, {"p": (chunks, parity)}

    return step
