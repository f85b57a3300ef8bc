"""Carry the reference package's data across into the port.

A solver has no weights: what crosses between the two packages is the
problem data, the solver state and the persisted slots.  Problems and
states cross as numpy arrays through the functions below; slots cross
through the wire format itself (bytes encoded by either package's
``RecoverySchema.encode`` decode in the other).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api import Problem, _preconditioner
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.state import PCGState

_VECTORS = ("x", "r", "z", "p")
_SCALARS = ("rz", "beta_prev")


def problem_from_numpy(grid: Sequence[int], nblocks: int, b: np.ndarray,
                       preconditioner: str = "jacobi",
                       device: Union[str, torch.device] = "cuda") -> Problem:
    """The Poisson problem on ``grid = (nz, ny, nx)`` with right-hand side
    ``b`` (its dtype is the problem's), placed on ``device``."""
    dev = resolve_device(device)
    b_t = torch.as_tensor(np.array(b)).to(dev).reshape(-1)
    nz, ny, nx = grid
    op = StencilOperator(nz, ny, nx, nblocks, dtype=b_t.dtype, device=dev)
    if b_t.numel() != op.n:
        raise ValueError(f"b has {b_t.numel()} values, grid {tuple(grid)} "
                         f"needs {op.n}")
    return Problem(op=op, b=b_t, precond=_preconditioner(preconditioner, op))


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device: Union[str, torch.device] = "cuda") -> PCGState:
    """A :class:`PCGState` from numpy fields (``x, r, z, p`` vectors,
    ``rz, beta_prev`` scalars, ``k``), placed on ``device``."""
    dev = resolve_device(device)
    vals = {f: torch.as_tensor(np.array(fields[f])).to(dev)
            for f in _VECTORS + _SCALARS}
    for f in _SCALARS:
        vals[f] = vals[f].reshape(())
    return PCGState(k=int(fields["k"]), **vals)


def state_to_numpy(state: PCGState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy` (host copies; ``k`` is an
    ``int``)."""
    out: Dict[str, object] = {f: getattr(state, f).detach().cpu().numpy()
                              for f in _VECTORS + _SCALARS}
    out["k"] = int(state.k)
    return out
