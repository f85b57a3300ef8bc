"""The solver registry and backend factory (port of
``repro/solvers/registry.py``, PCG only for now).

    solver  = make_solver("pcg", op, precond)
    backend = make_backend("nvm-prd", op, solver=solver)
    state, report, _ = driver.solve(solver, op, b, precond, backend=backend)

Unknown names raise with a did-you-mean hint.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np

from repro_torch.core.state import RecoverySchema
from repro_torch.nvm.backend import (
    PersistenceBackend,
    create_backend,
    unknown_name_error,
)
from repro_torch.solvers.base import RecoverableSolver
from repro_torch.solvers.pcg import PCGSolver

SOLVERS: Dict[str, Type[RecoverableSolver]] = {
    "pcg": PCGSolver,
}


def make_solver(name: str, op=None, precond=None, **opts) -> RecoverableSolver:
    """Build a registered solver for ``(op, precond)``."""
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
    ``solver``'s (or ``schema``'s) recovery set; defaults to PCG's."""
    if solver is not None:
        if schema is not None and schema != solver.schema:
            raise ValueError(
                f"conflicting schemas: solver {solver.name!r} declares "
                f"{solver.schema.solver!r} but schema={schema.solver!r} was "
                f"passed explicitly — give one or the other")
        schema = solver.schema
    return create_backend(name, op.nblocks, op.partition.block_size, dtype,
                          schema=schema, **opts)
