"""BiCGStab as a :class:`RecoverableSolver` (port of
``repro/solvers/bicgstab.py``).

Preconditioned BiCGStab (van der Vorst '92), right-preconditioned form:
the state carries the *true* residual ``r = b - A x``, so convergence
monitoring and recovery share PCG's invariants.

Minimal recovery set: ``{r^(k), p^(k), rho_k, alpha_k, omega_k}`` —
two vectors and three scalars, history 1.  Reconstruction at the
recovery point:

    r_F, p_F              <- persisted
    A[F,F] x_F = b_F - r_F - A[F,~F] x_{~F}     (local solve, Alg. 3 l.7-8)
    v_F = (A P p)[F]                            (recompute)

The shadow residual ``rhat0 = r^(0)`` is derived static data (``b - A
x0``), regenerable on a replacement node without persistence, so it is
not part of the persisted set; :meth:`BiCGStabSolver.init_state` sets
it.  The reference pins ``phat``/``shat`` with an XLA optimization
barrier so they are materialized once; eager PyTorch materializes them
once by construction, so the port needs no counterpart.  One iteration
is two stencil applies (K1) and four block dots (``det_dot``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.reconstruction import solve_x_from_residual
from repro_torch.core.state import RecoverySchema, RecoverySet
from repro_torch.solvers.base import RecoverableSolver, solver_dot

BICGSTAB_SCHEMA = RecoverySchema(
    "bicgstab", vectors=("r", "p"), scalars=("rho", "alpha", "omega"),
    history=1)


class BiCGStabState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor      # true residual b - A x
    p: torch.Tensor
    v: torch.Tensor      # A P p
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    k: int


def make_step(op_apply, precond_apply, dot, rhat0):
    """One BiCGStab iteration.  ``rhat0`` is the solve's shadow residual
    (solo path) or the lanes' ``(lanes, n)`` stack (the service's lane
    step): the body is shared."""

    def step(state: BiCGStabState) -> BiCGStabState:
        rho_new = dot(rhat0, state.r)
        beta = (rho_new / state.rho) * (state.alpha / state.omega)
        p = state.r + beta * (state.p - state.omega * state.v)
        phat = precond_apply(p)
        v = op_apply(phat)
        alpha = rho_new / dot(rhat0, v)
        s = state.r - alpha * v
        shat = precond_apply(s)
        t = op_apply(shat)
        omega = dot(t, s) / dot(t, t)
        x = state.x + alpha * phat + omega * shat
        r = s - omega * t
        return BiCGStabState(x=x, r=r, p=p, v=v, rho=rho_new, alpha=alpha,
                             omega=omega, k=state.k + 1)

    return step


class BiCGStabSolver(RecoverableSolver):
    name = "bicgstab"
    schema = BICGSTAB_SCHEMA
    state_vector_fields = ("x", "r", "p", "v")
    state_nan_scalars = ()
    batchable = True

    def __init__(self):
        self._rhat0 = None

    def init_state(self, op, precond, b, x0=None) -> BiCGStabState:
        x0 = torch.zeros_like(b) if x0 is None else x0
        r0 = b - op.apply(x0)
        self._rhat0 = r0  # derived static data (see module docstring)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        zero = torch.zeros_like(b)
        return BiCGStabState(x=x0, r=r0, p=zero, v=zero, rho=one, alpha=one,
                             omega=one, k=0)

    def make_step(self, op, precond):
        if self._rhat0 is None:
            raise RuntimeError("init_state must run before make_step")
        return make_step(op.apply, precond.apply, solver_dot(op), self._rhat0)

    @classmethod
    def lane_step(cls, op_apply, precond, dot, params):
        # No barrier, as in the reference's lane step (and the port's
        # solo step: eager PyTorch materializes phat/shat once).
        return make_step(op_apply, precond.apply, dot, params["rhat0"])

    def lane_params(self):
        if self._rhat0 is None:
            raise RuntimeError("init_state must run before lane_params")
        return {"rhat0": self._rhat0}

    def recovery_set(self, state, on_device: bool = False) -> RecoverySet:
        def vector(v):
            return v if on_device else self.host_shard(v)

        return RecoverySet(
            k=int(state.k),
            scalars={"rho": float(state.rho), "alpha": float(state.alpha),
                     "omega": float(state.omega)},
            vectors={"r": vector(state.r), "p": vector(state.p)},
        )

    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        part = op.partition
        failed = list(failed_blocks)
        cur = sets[-1]
        at = part.device_of(b, failed)

        def device(v, where=b.device):
            return torch.as_tensor(v, dtype=b.dtype, device=where)

        r_f = device(cur.vectors["r"], at)
        p_f = device(cur.vectors["p"], at)
        r = part.scatter(snapshot.r, r_f, failed)
        p = part.scatter(snapshot.p, p_f, failed)
        x = solve_x_from_residual(op, b, snapshot.x, r_f, failed, local_method)
        # v = A P p is derivable once p is whole again.  The reference
        # sums A[F,F](P p)_F + A[F,~F](P p)_{~F}; the port restricts one
        # full apply instead, which computes every row of F from the
        # same neighbours in the same order as the step did, so v_F is
        # bitwise the lost one.  (The split rounds differently, and
        # BiCGStab amplifies that last bit about tenfold per iteration:
        # 6e-16 in v became 8e-7 in x ten iterations later at 64^3.)
        phat = precond.apply(p)
        v = part.scatter(snapshot.v,
                         part.restrict(op.apply(phat), failed), failed)
        return BiCGStabState(
            x=x, r=r, p=p, v=v,
            rho=device(cur.scalars["rho"]),
            alpha=device(cur.scalars["alpha"]),
            omega=device(cur.scalars["omega"]),
            k=snapshot.k,
        )
