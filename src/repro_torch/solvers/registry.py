"""The solver zoo registry and backend factory (port of
``repro/solvers/registry.py``).

Tests and examples iterate ``SOLVERS`` to run every ESR-recoverable
solver against every persistence backend; the factories wire schemas
through so each backend's slot layout matches the solver it protects.
Backends resolve through the single registry in
:mod:`repro_torch.nvm.backend`, composable spec strings included::

    solver  = make_solver("chebyshev", op, precond)
    backend = make_backend("replicated(nvm-prd x2)", op, solver=solver)
    state, report, _ = driver.solve(solver, op, b, precond, backend=backend)

Unknown names raise with a did-you-mean hint.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np

# Deprecated table view (``BACKENDS[name](...)`` warns); the live
# registry is repro_torch.nvm.backend.
from repro_torch.core.nvm_esr import BACKENDS  # noqa: F401
from repro_torch.core.state import RecoverySchema
from repro_torch.nvm.backend import (
    PersistenceBackend,
    create_backend,
    unknown_name_error,
)
from repro_torch.solvers.base import RecoverableSolver
from repro_torch.solvers.bicgstab import BiCGStabSolver
from repro_torch.solvers.chebyshev import ChebyshevSolver
from repro_torch.solvers.gmres import RestartedGMRESSolver
from repro_torch.solvers.jacobi import WeightedJacobiSolver
from repro_torch.solvers.pcg import PCGSolver

SOLVERS: Dict[str, Type[RecoverableSolver]] = {
    "pcg": PCGSolver,
    "jacobi": WeightedJacobiSolver,
    "chebyshev": ChebyshevSolver,
    "bicgstab": BiCGStabSolver,
    "gmres": RestartedGMRESSolver,
}


def make_solver(name: str, op=None, precond=None, **opts) -> RecoverableSolver:
    """Build a registered solver, deriving problem-dependent parameters
    (Chebyshev bounds, Jacobi weight) from ``(op, precond)`` when given."""
    try:
        cls = SOLVERS[name]
    except KeyError:
        raise unknown_name_error("solver", name, SOLVERS) from None
    return cls.from_problem(op, precond, **opts)


def make_backend(
    name: str,
    op,
    dtype=np.float64,
    solver: Optional[RecoverableSolver] = None,
    schema: Optional[RecoverySchema] = None,
    **opts,
) -> PersistenceBackend:
    """Build a registered backend sized for ``op``'s partition, persisting
    ``solver``'s (or ``schema``'s) recovery set; defaults to PCG's.

    ``name`` may be any registry name or a composable spec string —
    ``"replicated(nvm-prd x2)"``, ``"erasure(nvm-prd x4+p)"``,
    ``"tiered(nvm-homogeneous)"``."""
    if solver is not None:
        if schema is not None and schema != solver.schema:
            raise ValueError(
                f"conflicting schemas: solver {solver.name!r} declares "
                f"{solver.schema.solver!r} but schema={schema.solver!r} was "
                f"passed explicitly — give one or the other")
        schema = solver.schema
    return create_backend(name, op.nblocks, op.partition.block_size, dtype,
                          schema=schema, **opts)
