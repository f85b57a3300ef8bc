"""Chebyshev iteration as a :class:`RecoverableSolver` (port of
``repro/solvers/chebyshev.py``).

Preconditioned Chebyshev semi-iteration (Saad, Alg. 12.1) in three-term
direction form, driven by spectral bounds ``[lmin, lmax]`` of ``P A``:

    sigma = d / c,  d = (lmax + lmin)/2,  c = (lmax - lmin)/2
    rho_0 = 1/sigma,   alpha_0 = 1/d,   p_0 = z_0
    rho_{k+1}  = 1 / (2 sigma - rho_k)
    beta_{k+1} = rho_k * c * alpha_k / 2
    alpha_{k+1}= 2 rho_{k+1} / c
    p_{k+1} = z_{k+1} + beta_{k+1} p_k,   x_{k+1} = x_k + alpha_k p_k

The scalars come from a deterministic recurrence — no inner products —
kept as 0-d tensors of ``b``'s dtype on its device, so one iteration is
one stencil apply (K1) and elementwise updates with no host read.  The
direction structure ``p = z + beta p_prev`` is PCG's, so exact
reconstruction reuses Algorithm 3
(:func:`repro_torch.core.reconstruction.reconstruct_direction_form`)
with the persisted pair ``(p^(k-1), p^(k))`` — recovery set ``{p, beta,
alpha, rho, k}``, history 2.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.reconstruction import reconstruct_direction_form
from repro_torch.core.spmv import make_det_dot
from repro_torch.core.state import RecoverySchema, RecoverySet
from repro_torch.solvers.base import RecoverableSolver, base_operator

CHEBYSHEV_SCHEMA = RecoverySchema(
    "chebyshev", vectors=("p",), scalars=("beta", "alpha", "rho"), history=2)


class ChebyshevState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    alpha: torch.Tensor      # alpha_k: the step applied by the NEXT iteration
    rho: torch.Tensor        # rho_k of the Chebyshev recurrence
    beta_prev: torch.Tensor  # beta_k linking p_k = z_k + beta_k p_{k-1}
    k: int


def spectral_bounds(op, precond, power_iters: int = 100,
                    seed: int = 0) -> Tuple[float, float]:
    """Bounds ``[lmin, lmax]`` on the spectrum of ``P A``.

    Three routes, most exact first:

    - closed form for the 7-point stencil with identity/Jacobi
      preconditioning (eigenvalues of the 3-D Dirichlet Laplacian are
      known analytically),
    - dense eigenvalues for ``op.n <= 2048`` (any operator and
      preconditioner): the columns of ``P A`` are built on the op's
      device in one batched apply and ``np.linalg.eigvals`` runs on the
      host, as in the reference,
    - shifted power iteration otherwise, every inner product and norm
      through the block dot (with safety margins: Chebyshev tolerates
      slightly wide bounds, diverges on too narrow ones).
    """
    from repro_torch.core.poisson import (
        IdentityPreconditioner,
        JacobiPreconditioner,
        StencilOperator,
    )

    # Bounds are placement-independent: unwrap a ShardedOperator so the
    # closed-form stencil route still fires; the power iteration's dots
    # keep the mesh's order, bitwise the unsharded one.
    mesh = getattr(op, "mesh", None)
    op = base_operator(op)

    if isinstance(op, StencilOperator) and isinstance(
            precond, (IdentityPreconditioner, JacobiPreconditioner)):
        spread = sum(np.cos(np.pi / (dim + 1)) for dim in op.grid)
        lo, hi = 6.0 - 2.0 * spread, 6.0 + 2.0 * spread
        if isinstance(precond, JacobiPreconditioner):
            lo, hi = lo / 6.0, hi / 6.0  # P = D^{-1} = I/6 for the stencil
        return lo, hi

    def m_apply(v):
        return precond.apply(op.apply(v))

    if op.n <= 2048:
        eye = torch.eye(op.n, dtype=op.dtype, device=op.device)
        cols = m_apply(eye).T.cpu().numpy()
        eigs = np.linalg.eigvals(cols).real  # P A ~ P^1/2 A P^1/2: real
        return float(eigs.min()), float(eigs.max())

    # power iteration for lmax; shifted power iteration for lmin
    rng = np.random.default_rng(seed)
    v0 = torch.as_tensor(rng.standard_normal(op.n), dtype=op.dtype,
                         device=op.device)
    det_dot = make_det_dot(getattr(op, "nblocks", 1), mesh)

    def power(apply_fn, v):
        # the Rayleigh quotient stays on the device; only the last one
        # crosses to the host
        for _ in range(power_iters):
            w = apply_fn(v)
            lam = det_dot(v, w) / det_dot(v, v)
            v = w / torch.sqrt(det_dot(w, w))
        return float(lam)

    hi = power(m_apply, v0)
    lo = hi - power(lambda u: hi * u - m_apply(u), v0)
    return 0.9 * max(lo, 1e-12 * hi), 1.05 * hi


def make_step(op_apply, precond_apply, c, sigma):
    """One Chebyshev iteration: one stencil apply, no reductions.
    ``c``/``sigma`` are Python floats (solo path) or ``(lanes, 1)``
    columns (the service's lane step): the recurrence body is shared."""

    def step(state: ChebyshevState) -> ChebyshevState:
        ap = op_apply(state.p)                    # the only SpMV
        x = state.x + state.alpha * state.p
        r = state.r - state.alpha * ap
        z = precond_apply(r)
        rho_new = 1.0 / (2.0 * sigma - state.rho)   # scalar recurrence:
        beta = state.rho * c * state.alpha / 2.0    # no reductions
        alpha_new = 2.0 * rho_new / c
        p = z + beta * state.p
        return ChebyshevState(x=x, r=r, z=z, p=p, alpha=alpha_new,
                              rho=rho_new, beta_prev=beta, k=state.k + 1)

    return step


class ChebyshevSolver(RecoverableSolver):
    name = "chebyshev"
    schema = CHEBYSHEV_SCHEMA
    state_vector_fields = ("x", "r", "z", "p")
    state_nan_scalars = ()
    batchable = True

    def __init__(self, lam_min: float, lam_max: float):
        if not (0.0 < lam_min < lam_max):
            raise ValueError(f"need 0 < lam_min < lam_max, got [{lam_min}, {lam_max}]")
        self.lam_min = float(lam_min)
        self.lam_max = float(lam_max)
        self.d = (lam_max + lam_min) / 2.0
        self.c = (lam_max - lam_min) / 2.0

    def init_state(self, op, precond, b, x0=None) -> ChebyshevState:
        x0 = torch.zeros_like(b) if x0 is None else x0
        r0 = b - op.apply(x0)
        z0 = precond.apply(r0)

        def scalar(v):
            return torch.tensor(v, dtype=b.dtype, device=b.device)

        return ChebyshevState(
            x=x0, r=r0, z=z0, p=z0,
            alpha=scalar(1.0 / self.d), rho=scalar(self.c / self.d),
            beta_prev=scalar(0.0), k=0,
        )

    def make_step(self, op, precond):
        return make_step(op.apply, precond.apply, self.c, self.d / self.c)

    @classmethod
    def lane_step(cls, op_apply, precond, dot, params):
        return make_step(op_apply, precond.apply, params["c"],
                         params["sigma"])

    def lane_params(self):
        # Bounds are computed from the tenant's *real* operator
        # (spectral_bounds in from_problem); only the recurrence
        # coefficients travel into the lane.
        return {"c": self.c, "sigma": self.d / self.c}

    def recovery_set(self, state, on_device: bool = False) -> RecoverySet:
        p = state.p if on_device else self.host_shard(state.p)
        return RecoverySet(
            k=int(state.k),
            scalars={"beta": float(state.beta_prev),
                     "alpha": float(state.alpha),
                     "rho": float(state.rho)},
            vectors={"p": p},
        )

    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        prev, cur = sets[-2], sets[-1]

        def device(v):
            return torch.as_tensor(v, dtype=b.dtype, device=b.device)

        x, r, z, p = reconstruct_direction_form(
            op, precond, b, snapshot, list(failed_blocks),
            p_prev_f=device(prev.vectors["p"]),
            p_cur_f=device(cur.vectors["p"]),
            beta=cur.scalars["beta"],
            local_method=local_method,
        )
        return ChebyshevState(
            x=x, r=r, z=z, p=p,
            alpha=device(cur.scalars["alpha"]),
            rho=device(cur.scalars["rho"]),
            beta_prev=device(cur.scalars["beta"]),
            k=snapshot.k,
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_problem(cls, op=None, precond=None,
                     lam_min: Optional[float] = None,
                     lam_max: Optional[float] = None) -> "ChebyshevSolver":
        if lam_min is None or lam_max is None:
            if op is None or precond is None:
                raise ValueError(
                    "chebyshev needs spectral bounds: pass lam_min/lam_max "
                    "or (op, precond) to estimate them")
            lo, hi = spectral_bounds(op, precond)
            lam_min = lo if lam_min is None else lam_min
            lam_max = hi if lam_max is None else lam_max
        return cls(lam_min=lam_min, lam_max=lam_max)
