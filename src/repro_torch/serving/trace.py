"""Deterministic multi-tenant request traces (port of
``repro/serving/trace.py``).

One seeded generator feeds the service and its tests, and it draws the
reference's sequence: the same seed gives the same requests in both
packages, so a trace replays through either service.  Uses
:class:`random.Random` (not numpy or torch) so the draw sequence is
pinned by seed alone.

A :class:`ServiceRequest` is declarative: grid / solver / spec /
failure choices, no built objects.  ``SolveService.submit_request``
materializes the :class:`~repro_torch.api.Problem` (on the service's
device) and the specs at submission.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence, Tuple

from repro_torch.solvers.driver import FailureEvent

#: tenant grids mixed by the generator: (grid, nblocks) with nblocks
#: dividing nz (the z-slab partition constraint).  Sizes straddle the
#: power-of-two bucket boundaries so traces exercise both padded and
#: exact-fit lanes: (3,4,4)/(4,4,4) share bucket (4,4,4); (4,6,6),
#: (6,6,6), (5,8,8) and (8,8,8) share bucket (8,8,8).
GRID_CHOICES: Tuple[Tuple[Tuple[int, int, int], int], ...] = (
    ((3, 4, 4), 3),
    ((4, 4, 4), 4),
    ((4, 6, 6), 4),
    ((6, 6, 6), 6),
    ((5, 8, 8), 5),
    ((8, 8, 8), 8),
)

#: (solver family, tol, maxiter) — tolerances matched to the family's
#: convergence rate on the small trace grids (Jacobi is a smoother, not
#: a Krylov method, so it gets the loose target).
SOLVER_CHOICES: Tuple[Tuple[str, float, int], ...] = (
    ("pcg", 1e-9, 500),
    ("bicgstab", 1e-9, 500),
    ("chebyshev", 1e-8, 1500),
    ("jacobi", 1e-6, 3000),
)

#: resilience spec mix: registry spec strings plus None, which asks the
#: service to pick via the advisor (repro.api.ResilienceSpec.advise).
SPEC_CHOICES: Tuple[Optional[str], ...] = (
    "nvm-prd",
    "replicated(nvm-prd x2)",
    "erasure(nvm-prd x4+p)",
    None,
)

#: specs whose declared capabilities survive a PRD (persistence-node)
#: loss — the survivable_only generator upgrades a PRD victim to one
PRD_SAFE_SPECS: Tuple[str, ...] = (
    "replicated(nvm-prd x2)",
    "erasure(nvm-prd x4+p)",
)


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    """One declarative tenant request in a service trace."""

    tenant: str
    at_step: int                      # service step at which it arrives
    grid: Tuple[int, int, int]
    nblocks: int
    preconditioner: str = "jacobi"
    solver: str = "pcg"
    tol: float = 1e-9
    maxiter: int = 500
    backend: Optional[str] = None     # spec string; None = advisor picks
    persist_mode: str = "sync"
    period: int = 1
    nshards: int = 1                  # declared logical shard layout
    failures: Tuple[FailureEvent, ...] = ()
    capture_states_at: Tuple[int, ...] = ()

    def problem(self, device="cuda"):
        """Materialize the Poisson problem this request describes, on
        ``device`` (the card unless the caller asks for the CPU)."""
        from repro_torch import api

        return api.Problem.poisson(*self.grid, nblocks=self.nblocks,
                                   preconditioner=self.preconditioner,
                                   device=device)

    def solver_spec(self):
        from repro_torch import api

        return api.SolverSpec(self.solver, tol=self.tol,
                              maxiter=self.maxiter)

    def resilience_spec(self):
        """The request's ResilienceSpec, or None for advisor choice."""
        from repro_torch import api

        if self.backend is None:
            return None
        return api.ResilienceSpec(self.backend,
                                  persist_mode=self.persist_mode,
                                  period=self.period)


def _divisor_shards(rng: random.Random, nblocks: int) -> int:
    """A shard count > 1 dividing nblocks (logical layout for shard=
    events), falling back to nblocks itself for prime block counts."""
    divs = [d for d in range(2, nblocks + 1) if nblocks % d == 0]
    return rng.choice(divs) if divs else nblocks


def _failure(rng: random.Random, nblocks: int, nshards: int,
             kind: str) -> FailureEvent:
    at = rng.randrange(3, 9)
    if kind == "shard":
        return FailureEvent(shard=rng.randrange(nshards), at_iteration=at)
    if kind == "prd":
        return FailureEvent(blocks=(rng.randrange(nblocks),),
                            at_iteration=at, prd=True)
    return FailureEvent(blocks=(rng.randrange(nblocks),), at_iteration=at)


def generate_request_trace(
    seed: int,
    nrequests: int = 6,
    failure_rate: float = 0.5,
    survivable_only: bool = False,
    max_arrival_step: int = 4,
    solvers: Sequence[Tuple[str, float, int]] = SOLVER_CHOICES,
    specs: Sequence[Optional[str]] = SPEC_CHOICES,
) -> Tuple[ServiceRequest, ...]:
    """The shared deterministic request trace.

    Draws ``nrequests`` tenants with seeded sizes, arrival steps, solver
    families, spec families, and (with probability ``failure_rate``) one
    block / PRD / shard failure event each.  ``survivable_only=True``
    upgrades every PRD victim to a PRD-safe spec so the whole trace is
    plan-acceptable — the benchmark's sustained-load mode; the fuzz leg
    keeps it False and asserts the planner names the violating event at
    submission instead.
    """
    # repro-lint: noqa[RL203] -- explicitly seeded Random instance (not the process-global stream); stdlib keeps traces importable by runtime-free tooling
    rng = random.Random(seed)
    requests = []
    for i in range(nrequests):
        grid, nblocks = rng.choice(GRID_CHOICES)
        solver, tol, maxiter = rng.choice(list(solvers))
        spec = rng.choice(list(specs))
        persist_mode = rng.choice(("sync", "overlap"))
        period = rng.choice((1, 3))
        precond = rng.choice(("jacobi", "identity"))
        nshards = 1
        failures: Tuple[FailureEvent, ...] = ()
        if rng.random() < failure_rate:
            kind = rng.choice(("block", "prd", "shard"))
            if kind == "shard":
                nshards = _divisor_shards(rng, nblocks)
            failures = (_failure(rng, nblocks, nshards, kind),)
            if survivable_only and failures[0].prd and (
                    spec is not None and spec not in PRD_SAFE_SPECS):
                spec = PRD_SAFE_SPECS[i % len(PRD_SAFE_SPECS)]
        requests.append(ServiceRequest(
            tenant=f"t{i}",
            at_step=rng.randrange(0, max_arrival_step + 1),
            grid=grid, nblocks=nblocks, preconditioner=precond,
            solver=solver, tol=tol, maxiter=maxiter,
            backend=spec, persist_mode=persist_mode, period=period,
            nshards=nshards, failures=failures,
        ))
    return tuple(requests)
