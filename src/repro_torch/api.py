"""``repro_torch.api`` — the front door of the port: problem, solver,
resilience, solve, advise, and the multi-tenant solve service (port of
``repro/api.py``).

A recoverable solve is three declarations and one call; it runs on the
CUDA device unless the problem is built with ``device="cpu"``::

    from repro_torch import api

    result = api.solve(
        api.Problem.poisson(64, nblocks=8),
        api.SolverSpec("chebyshev"),
        api.ResilienceSpec("replicated(nvm-prd x2)", persist_mode="overlap"),
        failures=[api.FailureEvent(blocks=(1, 2), at_iteration=20)],
    )
    assert result.converged

The solve takes its device from the problem's tensors.  Every solver of
the zoo (``pcg``, ``jacobi``, ``chebyshev``, ``bicgstab``, ``gmres``)
runs on every backend family: ``esr``, ``nvm-prd``, ``nvm-homogeneous``
and the composites ``replicated(...)``, ``tiered(...)`` and
``erasure(<child> xK+Pp)`` (with ``ResilienceSpec(fused_persist=True)``
the stripe encodes on the device).  :func:`advise` ranks candidate specs
against a failure campaign.  :class:`SolveService` (and :func:`serve`,
which replays a request trace through a fresh one) hosts many tenants at
once, one lane of a batched bucket each; a tenant declares its logical
shard layout with ``nshards=``.  ``Problem.poisson(..., nshards=4)`` (or
:meth:`Problem.with_shards`) lays a solo problem out over a data mesh of
four shards, by default all on its device with a stream each, or with
``with_shards(4, mesh=make_data_mesh(4))`` one card a shard: each
shard's slab of every vector is a tensor of its own on its shard's
device, the solve runs shard by shard, bitwise the unsharded one, and
``FailureEvent(shard=...)`` kills one shard's blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.poisson import PRECONDITIONERS, make_poisson_problem
from repro_torch.distributed.sharding import (
    gather,
    place_preconditioner,
    shard_problem,
)
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
    SpecAdvice,
    SpecRanking,
    UnsurvivableCampaignError,
    advise_spec,
    plan_campaign,
)
from repro_torch.solvers.registry import SOLVERS, make_backend, make_solver
from repro_torch.serving.solve_service import (
    ServiceConfig,
    ServiceError,
    ServiceTicket,
    SolveService,
)
from repro_torch.serving.trace import ServiceRequest, generate_request_trace

__all__ = [
    "Problem",
    "SolverSpec",
    "ResilienceSpec",
    "SolveResult",
    "solve",
    "advise",
    "default_candidate_specs",
    "solver_names",
    "backend_names",
    "BackendCapabilities",
    "PersistenceBackend",
    "UnrecoverableFailure",
    "CampaignPlan",
    "UnsurvivableCampaignError",
    "plan_campaign",
    "advise_spec",
    "SpecAdvice",
    "SpecRanking",
    "FailureCampaign",
    "FailureEvent",
    "FailurePlan",
    "SolveConfig",
    "SolveReport",
    "SolveService",
    "ServiceConfig",
    "ServiceError",
    "ServiceTicket",
    "ServiceRequest",
    "generate_request_trace",
    "serve",
]


#: the composite spec families — they take arguments, so the default
#: candidate list names one canonical instantiation of each
_COMPOSITE_FAMILIES = ("replicated", "tiered", "erasure")


def solver_names() -> list:
    """All registered solver names."""
    return sorted(SOLVERS)


def default_candidate_specs() -> Tuple[str, ...]:
    """The advisor's default candidate list: every non-composite
    registered backend by name, plus canonical instantiations of each
    composite family across the footprint/distance trade-off."""
    base = tuple(n for n in backend_names() if n not in _COMPOSITE_FAMILIES)
    return base + (
        "tiered(nvm-prd)",
        "replicated(nvm-prd x2)",
        "replicated(nvm-prd x3)",
        "erasure(nvm-prd x4+p)",
        "erasure(nvm-prd x6+2p)",
    )


def advise(
    problem: "Problem",
    campaign,
    candidates: Optional[Sequence[str]] = None,
    solver: Union["SolverSpec", str] = "pcg",
    dtype: Any = np.float64,
    tracer=None,
) -> SpecAdvice:
    """Rank candidate resilience specs against a campaign for this
    problem: each spec is built (sized for the problem, persisting the
    solver's schema), filtered through
    :func:`~repro_torch.solvers.driver.plan_campaign`, and the survivors
    ranked by storage footprint with the modeled persist cost of one
    probe event of ``problem.op.n`` values as tie-breaker
    (:func:`~repro_torch.solvers.driver.advise_spec`).  The solver is
    built on the problem's device (a Chebyshev solver takes its
    spectral bounds there); the probe writes run on the host.  A
    ``tracer`` (repro_torch.obs) records per-candidate
    ``advise.candidate`` events and the ``advise.chosen`` verdict."""
    if isinstance(solver, str):
        solver = SolverSpec(solver)
    built_solver = solver.build(problem)
    if candidates is None:
        candidates = default_candidate_specs()
    built = [(spec, make_backend(spec, problem.op, dtype=dtype,
                                 solver=built_solver))
             for spec in candidates]
    return advise_spec(campaign, built, probe_values=problem.op.n,
                       tracer=tracer)


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

    @property
    def nshards(self) -> int:
        """Shards the operator is laid out over (1 = unsharded; >1 when
        the operator is a
        :class:`~repro_torch.distributed.sharding.ShardedOperator`)."""
        layout = getattr(self.op, "layout", None)
        return 1 if layout is None else layout.nshards

    def with_shards(self, nshards: int, mesh=None) -> "Problem":
        """Lay this problem out over ``nshards`` shards of a 1-D ``data``
        mesh, every shard on the problem's device unless ``mesh`` places
        them (``make_data_mesh(nshards)``: one card a shard where there
        are enough) (:func:`repro_torch.distributed.sharding.shard_problem`):
        block-rows map contiguously onto shards, ``b`` and the
        preconditioner's vectors become sharded vectors (one slab a
        shard, on its device), the solve runs shard by shard, bitwise the
        unsharded one, and the driver's fail/persist/recover path becomes
        per-shard addressable (``FailureEvent(shard=...)``).  Raises if
        the problem is already sharded."""
        if getattr(self.op, "layout", None) is not None:
            raise ValueError(
                "problem is already sharded; shard the unsharded "
                "problem instead of re-sharding")
        sop, sb = shard_problem(self.op, self.b, nshards, mesh=mesh)
        return dataclasses.replace(
            self, op=sop, b=sb,
            precond=place_preconditioner(self.precond, sop))

    @classmethod
    def poisson(cls, nz: int, ny: Optional[int] = None,
                nx: Optional[int] = None, nblocks: int = 4,
                preconditioner: str = "jacobi",
                dtype: torch.dtype = torch.float64,
                device: Union[str, torch.device] = "cuda",
                nshards: int = 1) -> "Problem":
        """The paper's benchmark: a 7-point 3-D Poisson stencil with a
        smooth right-hand side, split into ``nblocks`` z-slabs, built on
        ``device`` (CUDA unless the caller asks for the CPU; raises when
        no CUDA device is visible).  ``nshards > 1`` shards the problem
        (see :meth:`with_shards`)."""
        op, b = make_poisson_problem(nz, ny if ny is not None else nz,
                                     nx if nx is not None else nz,
                                     nblocks=nblocks, dtype=dtype,
                                     device=device)
        problem = cls(op=op, b=b, precond=_preconditioner(preconditioner, op))
        if nshards != 1:
            problem = problem.with_shards(nshards)
        return problem

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

    ``backend`` is a registry name or composable spec string
    (``"nvm-prd"``, ``"esr"``, ``"replicated(nvm-prd x2)"``,
    ``"tiered(nvm-homogeneous)"``, ``"erasure(nvm-prd x4+2p)"``), an
    already-built :class:`~repro_torch.nvm.backend.PersistenceBackend`,
    or None for an unprotected run.  ``persist_mode`` picks the pipeline
    ("sync" or "overlap"); ``period`` the ESRP persistence period;
    ``plan_campaigns`` keeps the pre-flight campaign planner on.
    ``nshards`` pins the expected shard count of the problem: ``None``
    accepts any layout, an integer makes :func:`solve` refuse a problem
    whose shard axis disagrees.  ``fused_persist`` takes the fused
    persist path: an ``erasure(...)`` stripe encodes its parity on the
    device (kernel K3) and, in overlap mode on an unsharded problem,
    stages from the update pass (kernel K4); the solve is bitwise the
    same as without it.  ``dtype`` is the slot payload type; ``options``
    go to the backend factory."""

    backend: Union[str, PersistenceBackend, None] = "nvm-prd"
    persist_mode: str = "sync"
    period: int = 1
    plan_campaigns: bool = True
    nshards: Optional[int] = None
    fused_persist: bool = False
    dtype: Any = np.float64
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, problem: Problem, solver) -> Optional[PersistenceBackend]:
        if self.backend is None or isinstance(self.backend, PersistenceBackend):
            return self.backend
        return make_backend(self.backend, problem.op, dtype=self.dtype,
                            solver=solver, **dict(self.options))

    @classmethod
    def advise(cls, problem: Problem, campaign,
               candidates: Optional[Sequence[str]] = None,
               solver: Union["SolverSpec", str] = "pcg",
               **spec_kwargs) -> "ResilienceSpec":
        """The cheapest-spec advisor: return a :class:`ResilienceSpec`
        for the cheapest candidate whose declared capabilities carry
        ``campaign`` — e.g. a double-storage-loss campaign picks
        ``erasure(nvm-prd x6+2p)`` (1.33x storage) over
        ``replicated(nvm-prd x3)`` (3x) on footprint grounds.
        ``spec_kwargs`` (``persist_mode``, ``period``, ...) are forwarded
        to the spec.  Raises :class:`UnsurvivableCampaignError` when no
        candidate survives; use :func:`advise` for the full ranking."""
        advice = advise(problem, campaign, candidates, solver=solver,
                        dtype=spec_kwargs.get("dtype", np.float64))
        if advice.chosen is None:
            raise UnsurvivableCampaignError(
                "no candidate spec survives the campaign: "
                + "; ".join(f"[{r.spec}] {r.reason}"
                            for r in advice.rejected))
        return cls(advice.chosen, **spec_kwargs)


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
        """The solution iterate as a host array (a sharded solve's slabs
        gathered here, by ``sharding.gather``)."""
        return gather(self.state.x).detach().cpu().numpy()

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
    if (resilience.nshards is not None
            and resilience.nshards != problem.nshards):
        raise ValueError(
            f"ResilienceSpec.nshards={resilience.nshards} but the "
            f"problem is laid out over nshards={problem.nshards}; "
            f"re-shard with Problem.with_shards({resilience.nshards}) "
            f"or drop the spec's shard pin")

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


def serve(
    requests: Sequence[ServiceRequest],
    lanes: int = 4,
    max_queue: int = 8,
    tracer=None,
    device: str = "cuda",
) -> Dict[str, ServiceTicket]:
    """Replay a multi-tenant request trace through a fresh
    :class:`SolveService` whose problems are built on ``device`` (the
    card unless the caller asks for the CPU), and return tenant ->
    ticket; each accepted ticket carries its :class:`SolveResult`.  For
    incremental submission use the service object directly::

        svc = api.SolveService(api.ServiceConfig(lanes=8))
        ticket = svc.submit(problem, "pcg", failures=campaign)
        svc.drain()
    """
    svc = SolveService(ServiceConfig(lanes=lanes, max_queue=max_queue,
                                     tracer=tracer, device=device))
    return svc.replay(requests)
