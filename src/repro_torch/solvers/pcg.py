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
    batchable = True

    def init_state(self, op, precond, b, x0=None):
        return _core_pcg.init_state(op, precond, b, x0, dot=solver_dot(op))

    def make_step(self, op, precond):
        """K2's fused step for a diagonal preconditioner (one exposing
        ``inv_diag``), the unfused step for any other; on a sharded
        operator both reduce shard by shard (K2 once a shard)."""
        inv_diag = getattr(precond, "inv_diag", None)
        mesh = getattr(op, "mesh", None)
        if inv_diag is None:
            return _core_pcg.make_generic_step(op.apply, precond.apply,
                                               op.nblocks, mesh)
        return _core_pcg.make_step(op.apply, inv_diag, op.nblocks, mesh)

    @classmethod
    def lane_step(cls, op_apply, precond, dot, params):
        # PCG's scalars (rz, beta) live in the state; no per-lane params.
        # K2's lane mode fuses the lanes' diagonal preconditioners.
        return _core_pcg.make_lane_step(op_apply, precond.inv_diag, dot)

    def make_persist_step(self, op, precond, k_data: int, nparity: int):
        """The step with K4 in place of K2: returns ``(state, staged)``,
        ``staged`` mapping ``"p"`` (the input state's, the vector the
        recovery set persists) to its stripe ``(chunks, parity)``.  K4
        fuses the preconditioner, so it must be diagonal (the driver only
        asks for this step when it is)."""
        inv_diag = getattr(precond, "inv_diag", None)
        if inv_diag is None:
            raise ValueError(
                f"kernel K4 fuses a diagonal preconditioner; "
                f"{type(precond).__name__} exposes no inv_diag")
        return _core_pcg.make_persist_step(op.apply, inv_diag, op.nblocks,
                                           k_data, nparity)

    def recovery_set(self, state, on_device: bool = False) -> RecoverySet:
        p = state.p if on_device else self.host_shard(state.p)
        return RecoverySet(k=int(state.k),
                           scalars={"beta": float(state.beta_prev)},
                           vectors={"p": p})

    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        prev, cur = sets[-2], sets[-1]
        # the payloads land where the local solve runs: the first failed
        # block's shard's device
        at = op.partition.device_of(b, list(failed_blocks))

        def device(v):
            return torch.as_tensor(v, dtype=b.dtype, device=at)

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
