"""Carry the reference package's data across into the port.

A solver has no weights: what crosses between the two packages is the
problem data, the solver state and the persisted slots.  Problems and
states cross as numpy arrays through the functions below; slots cross
through the wire format itself (bytes encoded by either package's
``RecoverySchema.encode`` decode in the other).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api import Problem, _preconditioner
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.state import PCGState
from repro_torch.solvers.bicgstab import BiCGStabState
from repro_torch.solvers.chebyshev import ChebyshevState
from repro_torch.solvers.gmres import GMRESState
from repro_torch.solvers.jacobi import JacobiState

#: solver name -> its state class (every field but ``k`` is a tensor:
#: block vectors, or 0-d scalars)
STATE_CLASSES = {
    "pcg": PCGState,
    "jacobi": JacobiState,
    "chebyshev": ChebyshevState,
    "bicgstab": BiCGStabState,
    "gmres": GMRESState,
}


def problem_from_numpy(grid: Sequence[int], nblocks: int, b: np.ndarray,
                       preconditioner: str = "jacobi",
                       device: Union[str, torch.device] = "cuda") -> Problem:
    """The Poisson problem on ``grid = (nz, ny, nx)`` with right-hand side
    ``b`` (its dtype is the problem's), placed on ``device``, with the
    named preconditioner (``"identity"``, ``"jacobi"`` or
    ``"block_jacobi"``)."""
    dev = resolve_device(device)
    b_t = torch.as_tensor(np.array(b)).to(dev).reshape(-1)
    nz, ny, nx = grid
    op = StencilOperator(nz, ny, nx, nblocks, dtype=b_t.dtype, device=dev)
    if b_t.numel() != op.n:
        raise ValueError(f"b has {b_t.numel()} values, grid {tuple(grid)} "
                         f"needs {op.n}")
    return Problem(op=op, b=b_t, precond=_preconditioner(preconditioner, op))


#: the 0-d reduction/recurrence scalars among the state fields
_SCALARS = frozenset({"rz", "beta_prev", "alpha", "rho", "omega"})


def _state_class(fields: Mapping[str, np.ndarray], solver: Optional[str]):
    if solver is not None:
        return STATE_CLASSES[solver]
    matches = sorted(name for name, cls in STATE_CLASSES.items()
                     if set(cls._fields) == set(fields))
    if len(matches) != 1:
        raise ValueError(
            f"fields {sorted(fields)} match the states of {matches}; name "
            f"the solver (one of {sorted(STATE_CLASSES)})")
    return STATE_CLASSES[matches[0]]


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device: Union[str, torch.device] = "cuda",
                     solver: Optional[str] = None):
    """A solver state from numpy fields (block vectors, scalars and the
    iteration count ``k``), placed on ``device``.  The state class is
    ``solver``'s (``"pcg"``, ``"jacobi"``, ``"chebyshev"``,
    ``"bicgstab"``, ``"gmres"``) or, without it, the one whose field set
    the mapping has (Jacobi and GMRES share ``x, r, k``: name one)."""
    dev = resolve_device(device)
    cls = _state_class(fields, solver)
    vals = {f: torch.as_tensor(np.array(fields[f])).to(dev)
            for f in cls._fields if f != "k"}
    for f in _SCALARS.intersection(vals):
        vals[f] = vals[f].reshape(())
    return cls(k=int(fields["k"]), **vals)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy` (host copies; ``k`` is an
    ``int``)."""
    out: Dict[str, object] = {f: getattr(state, f).detach().cpu().numpy()
                              for f in state._fields if f != "k"}
    out["k"] = int(state.k)
    return out
