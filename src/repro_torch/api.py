"""``repro_torch.api`` — the front door of the port: problem, solver,
resilience, solve (port of the ``repro/api.py`` subset the main path
needs).

A recoverable solve is three declarations and one call; it runs on the
CUDA device unless the problem is built with ``device="cpu"``::

    from repro_torch import api

    result = api.solve(
        api.Problem.poisson(64, nblocks=8),
        api.SolverSpec("pcg"),
        api.ResilienceSpec("nvm-prd", persist_mode="overlap"),
        failures=[api.FailureEvent(blocks=(1, 2), at_iteration=20)],
    )
    assert result.converged

The solve takes its device from the problem's tensors.  Of the
composite backends, the ``erasure(<child> xK+Pp)`` stripe is ported
(with ``ResilienceSpec(fused_persist=True)``); the replicated and tiered
composites, the advisor, sharding and the multi-tenant service are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.poisson import PRECONDITIONERS, make_poisson_problem
from repro_torch.nvm.backend import (
    BackendCapabilities,
    PersistenceBackend,
    UnrecoverableFailure,
    backend_names,
    unknown_name_error,
)
from repro_torch.solvers import driver as _driver
from repro_torch.solvers.driver import (
    CampaignPlan,
    FailureCampaign,
    FailureEvent,
    FailurePlan,
    SolveConfig,
    SolveReport,
    UnsurvivableCampaignError,
    plan_campaign,
)
from repro_torch.solvers.registry import SOLVERS, make_backend, make_solver

__all__ = [
    "Problem",
    "SolverSpec",
    "ResilienceSpec",
    "SolveResult",
    "solve",
    "solver_names",
    "backend_names",
    "BackendCapabilities",
    "PersistenceBackend",
    "UnrecoverableFailure",
    "CampaignPlan",
    "UnsurvivableCampaignError",
    "plan_campaign",
    "FailureCampaign",
    "FailureEvent",
    "FailurePlan",
    "SolveConfig",
    "SolveReport",
]


def solver_names() -> list:
    """All registered solver names."""
    return sorted(SOLVERS)


@dataclasses.dataclass(frozen=True)
class Problem:
    """A linear system ``A x = b`` with a preconditioner: the operator is
    matrix-free and block-partitioned (the failure/recovery unit)."""

    op: Any
    b: Any
    precond: Any

    @property
    def device(self) -> torch.device:
        return self.b.device

    @classmethod
    def poisson(cls, nz: int, ny: Optional[int] = None,
                nx: Optional[int] = None, nblocks: int = 4,
                preconditioner: str = "jacobi",
                dtype: torch.dtype = torch.float64,
                device: Union[str, torch.device] = "cuda") -> "Problem":
        """The paper's benchmark: a 7-point 3-D Poisson stencil with a
        smooth right-hand side, split into ``nblocks`` z-slabs, built on
        ``device`` (CUDA unless the caller asks for the CPU; raises when
        no CUDA device is visible)."""
        op, b = make_poisson_problem(nz, ny if ny is not None else nz,
                                     nx if nx is not None else nz,
                                     nblocks=nblocks, dtype=dtype,
                                     device=device)
        return cls(op=op, b=b, precond=_preconditioner(preconditioner, op))

    @classmethod
    def from_parts(cls, op, b, precond=None) -> "Problem":
        """Wrap an existing operator / rhs / preconditioner triple."""
        if precond is None:
            precond = PRECONDITIONERS["identity"](op)
        return cls(op=op, b=b, precond=precond)


def _preconditioner(name: str, op):
    try:
        pre_cls = PRECONDITIONERS[name]
    except KeyError:
        raise unknown_name_error("preconditioner", name,
                                 PRECONDITIONERS) from None
    return pre_cls(op)


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Which solver, to what accuracy (``options`` go to the factory)."""

    name: str = "pcg"
    tol: float = 1e-10
    maxiter: int = 10_000
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, problem: Problem):
        return make_solver(self.name, problem.op, problem.precond,
                           **dict(self.options))


@dataclasses.dataclass(frozen=True)
class ResilienceSpec:
    """Which persistence backend, and how persistence is scheduled.

    ``backend`` is a registry name or stripe spec (``"nvm-prd"``,
    ``"nvm-homogeneous"``, ``"erasure(nvm-prd x4+2p)"``), an already-built :class:`~repro_torch.nvm.backend.PersistenceBackend`,
    or None for an unprotected run.  ``persist_mode`` picks the pipeline
    ("sync" or "overlap"); ``period`` the ESRP persistence period;
    ``plan_campaigns`` keeps the pre-flight campaign planner on.
    ``fused_persist`` takes the fused persist path: an ``erasure(...)``
    stripe encodes its parity on the device (kernel K3) and, in overlap
    mode, stages from the update pass (kernel K4); the solve is bitwise
    the same as without it.  ``dtype`` is the slot payload type;
    ``options`` go to the backend factory."""

    backend: Union[str, PersistenceBackend, None] = "nvm-prd"
    persist_mode: str = "sync"
    period: int = 1
    plan_campaigns: bool = True
    fused_persist: bool = False
    dtype: Any = np.float64
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, problem: Problem, solver) -> Optional[PersistenceBackend]:
        if self.backend is None or isinstance(self.backend, PersistenceBackend):
            return self.backend
        return make_backend(self.backend, problem.op, dtype=self.dtype,
                            solver=solver, **dict(self.options))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of :func:`solve`: the final solver state (tensors on the
    problem's device), the report, any captured states, and the
    backend."""

    state: Any
    report: SolveReport
    captured: Dict[int, Any]
    backend: Optional[PersistenceBackend]

    @property
    def x(self) -> np.ndarray:
        """The solution iterate as a host array."""
        return self.state.x.detach().cpu().numpy()

    @property
    def converged(self) -> bool:
        return self.report.converged

    @property
    def relres(self) -> float:
        return self.report.final_relres

    @property
    def iterations(self) -> int:
        return self.report.iterations

    @property
    def capabilities(self) -> Optional[BackendCapabilities]:
        return None if self.backend is None else self.backend.capabilities


def solve(
    problem: Problem,
    solver: Union[SolverSpec, str] = SolverSpec(),
    resilience: Union[ResilienceSpec, str, None] = None,
    failures: Union[FailureCampaign, Sequence, Tuple] = (),
    x0=None,
    capture_states_at: Sequence[int] = (),
    tracer=None,
) -> SolveResult:
    """Build the solver and backend from their specs and run the
    recoverable solve on the problem's device.

    ``solver`` and ``resilience`` accept bare name strings as shorthand
    for default specs; ``resilience=None`` runs unprotected (and refuses
    injected failures, like the driver).  ``tracer`` (a
    :class:`repro_torch.obs.Tracer`) records spans and events through the
    driver and the persistence sessions."""
    if isinstance(solver, str):
        solver = SolverSpec(solver)
    if isinstance(resilience, str):
        resilience = ResilienceSpec(resilience)
    if resilience is None:
        resilience = ResilienceSpec(backend=None)

    built_solver = solver.build(problem)
    backend = resilience.build(problem, built_solver)
    config = SolveConfig(
        tol=solver.tol,
        maxiter=solver.maxiter,
        persistence_period=resilience.period,
        persist_mode=resilience.persist_mode,
        plan_campaign=resilience.plan_campaigns,
        fused_persist=resilience.fused_persist,
        tracer=tracer,
    )
    state, report, captured = _driver.solve(
        built_solver, problem.op, problem.b, problem.precond,
        config=config, backend=backend, failures=failures, x0=x0,
        capture_states_at=capture_states_at,
    )
    return SolveResult(state=state, report=report, captured=captured,
                       backend=backend)
