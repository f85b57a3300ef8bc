"""Restarted GMRES(m) as a :class:`RecoverableSolver` (port of
``repro/solvers/gmres.py``).

One driver "iteration" is a full restart cycle: an m-step Arnoldi process
(right-preconditioned, classical Gram-Schmidt with reorthogonalization)
followed by the small least-squares solve and the update ``x <- x + P V
y``.

At a restart the whole algorithm state collapses to the iterate ``x``,
so the ``(m+1)``-vector Krylov basis is never persisted: minimal
recovery set ``{x^(k)}``, history 1 — the iterate-only pattern shared
with weighted Jacobi (:class:`~repro_torch.solvers.base.IterateOnlyRecovery`);
a mid-cycle failure costs at most one cycle of work.

On the device: the basis, ``m+1`` vectors (2.8 GB at 256^3 float64, m =
20; sharded vectors on a mesh, so each shard keeps its slab of every
basis vector), the stencil applies (K1), the norms (``det_dot``) and the
projections (``make_det_rowdots``).  The ``(m+1) x m`` least-squares solve runs in
``numpy.linalg.lstsq`` on the host on every device, one read of the
Hessenberg matrix per cycle, so the CPU and CUDA runs of the port agree
and match the reference's SVD-based ``jnp.linalg.lstsq``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.spmv import make_det_dot, make_det_rowdots
from repro_torch.core.state import RecoverySchema
from repro_torch.solvers.base import IterateOnlyRecovery, RecoverableSolver

GMRES_SCHEMA = RecoverySchema("gmres", vectors=("x",), scalars=(), history=1)


class GMRESState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor  # true residual b - A x at the cycle boundary
    k: int           # completed restart cycles


class RestartedGMRESSolver(IterateOnlyRecovery, RecoverableSolver):
    name = "gmres"
    schema = GMRES_SCHEMA
    state_cls = GMRESState

    def __init__(self, m: int = 20):
        if m < 1:
            raise ValueError(f"restart length must be >= 1, got {m}")
        self.m = int(m)

    def make_step(self, op, precond):
        m = self.m
        op_apply, precond_apply = op.apply, precond.apply
        # Order-pinned reductions: the projections are block-hierarchical
        # row-dots; the combines ``basis.T @ h`` are row-weighted sums
        # over the small basis axis, added left to right (elementwise
        # along the vector axis, so a slab's values never depend on
        # another's).
        mesh = getattr(op, "mesh", None)
        dot = make_det_dot(op.nblocks, mesh)
        rowdots = make_det_rowdots(op.nblocks, mesh)

        def combine(rows, coeffs):
            # sum_i coeffs[i] * rows[i], from i = 0
            total = rows[0] * coeffs[0]
            for row, c in zip(rows[1:], coeffs[1:]):
                total = total + row * c
            return total

        def cycle(state: GMRESState) -> GMRESState:
            x, r = state.x, state.r
            dt, dev = r.dtype, r.device
            tiny = torch.finfo(dt).tiny
            beta = torch.sqrt(dot(r, r))
            basis = [r / torch.clamp(beta, min=tiny)]
            hess = torch.zeros((m + 1, m), dtype=dt, device=dev)
            for j in range(m):
                w = op_apply(precond_apply(basis[j]))
                # CGS2 over the j+1 built vectors; the second pass
                # restores MGS-grade orthogonality.
                h1 = rowdots(basis, w)
                w = w - combine(basis, h1)
                h2 = rowdots(basis, w)
                w = w - combine(basis, h2)
                hnorm = torch.sqrt(dot(w, w))
                basis.append(w / torch.clamp(hnorm, min=tiny))
                hess[:j + 1, j] = h1 + h2
                hess[j + 1, j] = hnorm
            # the cycle's one host read: the Hessenberg matrix and beta
            rhs = np.zeros(m + 1)
            rhs[0] = float(beta)
            y, *_ = np.linalg.lstsq(hess.cpu().numpy(), rhs, rcond=None)
            y = torch.as_tensor(y, dtype=dt, device=dev)
            dx = precond_apply(combine(basis[:m], y))
            return GMRESState(x=x + dx, r=r - op_apply(dx),  # = b - A x_new
                              k=state.k + 1)

        return cycle
