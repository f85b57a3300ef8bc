"""The recoverable solver zoo of the port: generic ESR for distributed
iterative solvers (port of ``repro/solvers``).

- :mod:`repro_torch.solvers.base` — the :class:`RecoverableSolver`
  interface and :class:`~repro_torch.core.state.RecoverySchema`-driven
  payloads.
- :mod:`repro_torch.solvers.driver` — the generic solve loop
  (persistence schedule, failure injection, survivor snapshot,
  recovery, reporting) and the spec advisor.
- solver adapters: :mod:`~repro_torch.solvers.pcg` (history-2 pair, the
  paper), :mod:`~repro_torch.solvers.chebyshev` (reduction-free
  scalars), :mod:`~repro_torch.solvers.jacobi` and
  :mod:`~repro_torch.solvers.gmres` (single-vector ``{x}`` sets),
  :mod:`~repro_torch.solvers.bicgstab` (multi-vector ``{r, p}`` set).
- :mod:`repro_torch.solvers.registry` — sweep solvers x backends by name.
"""
from repro_torch.solvers.base import RecoverableSolver  # noqa: F401
from repro_torch.solvers.bicgstab import BICGSTAB_SCHEMA, BiCGStabSolver  # noqa: F401
from repro_torch.solvers.chebyshev import (  # noqa: F401
    CHEBYSHEV_SCHEMA,
    ChebyshevSolver,
    spectral_bounds,
)
from repro_torch.solvers.driver import (  # noqa: F401
    CampaignPlan,
    FailureCampaign,
    FailureEvent,
    FailurePlan,
    PlannedRecovery,
    SolveConfig,
    SolveReport,
    SpecAdvice,
    SpecRanking,
    UnsurvivableCampaignError,
    advise_spec,
    plan_campaign,
    should_persist,
    solve,
)
from repro_torch.solvers.gmres import GMRES_SCHEMA, RestartedGMRESSolver  # noqa: F401
from repro_torch.solvers.jacobi import JACOBI_SCHEMA, WeightedJacobiSolver  # noqa: F401
from repro_torch.solvers.pcg import PCGSolver  # noqa: F401
from repro_torch.solvers.registry import (  # noqa: F401
    BACKENDS,
    SOLVERS,
    make_backend,
    make_solver,
)
