"""Weighted Jacobi as a :class:`RecoverableSolver` (port of
``repro/solvers/jacobi.py``).

The stationary iteration ``x^(k+1) = x^(k) + omega * P r^(k)`` with
``P = preconditioner`` (classically ``D^{-1}``) and ``r = b - A x``.

Minimal recovery set: ``{x^(k)}`` alone — the entire lost state is
derivable from the persisted ``x`` shard plus static data:

    r_F = b_F - A[F,F] x_F - A[F,~F] x_{~F}

so ``history = 1`` and recovery needs no local solve at all (shared with
restarted GMRES via :class:`~repro_torch.solvers.base.IterateOnlyRecovery`).
One iteration is one stencil apply (K1) and elementwise updates; it has
no reductions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.state import RecoverySchema
from repro_torch.solvers.base import IterateOnlyRecovery, RecoverableSolver

JACOBI_SCHEMA = RecoverySchema("jacobi", vectors=("x",), scalars=(), history=1)


class JacobiState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    k: int


def make_step(op_apply, precond_apply, omega):
    """One weighted-Jacobi iteration.  ``omega`` is a Python float (solo
    path) or a ``(lanes, 1)`` column (the service's lane step): the body
    is shared."""

    def step(state: JacobiState) -> JacobiState:
        z = precond_apply(state.r)
        x = state.x + omega * z
        r = state.r - omega * op_apply(z)   # r = b - A x, incrementally
        return JacobiState(x=x, r=r, k=state.k + 1)

    return step


class WeightedJacobiSolver(IterateOnlyRecovery, RecoverableSolver):
    name = "jacobi"
    schema = JACOBI_SCHEMA
    state_cls = JacobiState
    batchable = True

    def __init__(self, omega: float = 2.0 / 3.0):
        self.omega = float(omega)

    def make_step(self, op, precond):
        return make_step(op.apply, precond.apply, self.omega)

    @classmethod
    def lane_step(cls, op_apply, precond, dot, params):
        return make_step(op_apply, precond.apply, params["omega"])

    def lane_params(self):
        return {"omega": self.omega}

    # ------------------------------------------------------------------
    @classmethod
    def from_problem(cls, op=None, precond=None,
                     omega: Optional[float] = None) -> "WeightedJacobiSolver":
        """Pick the damping weight.  With spectral bounds of ``P A``
        available the optimal stationary weight is ``2/(mu_min+mu_max)``;
        otherwise the classic smoother default 2/3."""
        if omega is not None:
            return cls(omega=omega)
        if op is not None and precond is not None:
            from repro_torch.solvers.chebyshev import spectral_bounds

            try:
                lo, hi = spectral_bounds(op, precond)
                return cls(omega=2.0 / (lo + hi))
            except (ValueError, NotImplementedError):
                pass
        return cls()
