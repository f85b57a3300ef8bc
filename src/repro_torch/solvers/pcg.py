"""PCG as a :class:`RecoverableSolver` (port of ``repro/solvers/pcg.py``).

The algorithm and its exact reconstruction live in
:mod:`repro_torch.core.pcg` and :mod:`repro_torch.core.reconstruction`;
this module adapts them to the generic driver.  Recovery set:
``{p^(k), p^(k-1), beta^(k-1), k}`` — one vector, one scalar, history 2.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import pcg as _core_pcg
from repro_torch.core import reconstruction
from repro_torch.core.state import PCG_SCHEMA, RecoverySet
from repro_torch.solvers.base import RecoverableSolver, solver_dot


class PCGSolver(RecoverableSolver):
    name = "pcg"
    schema = PCG_SCHEMA
    state_vector_fields = ("x", "r", "z", "p")
    state_nan_scalars = ("rz",)

    def init_state(self, op, precond, b, x0=None):
        return _core_pcg.init_state(op, precond, b, x0, dot=solver_dot(op))

    def make_step(self, op, precond):
        inv_diag = getattr(precond, "inv_diag", None)
        if inv_diag is None:
            raise NotImplementedError(
                f"the port's PCG step fuses a diagonal preconditioner into "
                f"kernel K2; {type(precond).__name__} exposes no inv_diag")
        return _core_pcg.make_step(op.apply, inv_diag, op.nblocks)

    def recovery_set(self, state) -> RecoverySet:
        return RecoverySet(
            k=int(state.k),
            scalars={"beta": float(state.beta_prev)},
            vectors={"p": self.host_shard(state.p)},
        )

    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        prev, cur = sets[-2], sets[-1]

        def device(v):
            return torch.as_tensor(v, dtype=b.dtype, device=b.device)

        return reconstruction.reconstruct(
            op, precond, b,
            state_surviving=snapshot,
            failed_blocks=list(failed_blocks),
            p_prev_f=device(prev.vectors["p"]),
            p_cur_f=device(cur.vectors["p"]),
            beta=cur.scalars["beta"],
            local_method=local_method,
            dot=solver_dot(op),
        )
