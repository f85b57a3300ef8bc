"""The :class:`RecoverableSolver` interface (port of ``repro/solvers/base.py``).

An ESR-recoverable solver is an iteration whose lost state is exactly
derivable from (a) a few persisted vectors/scalars — its
:class:`~repro_torch.core.state.RecoverySchema` — plus (b) the surviving
shards and (c) static data.  The generic driver
(:mod:`repro_torch.solvers.driver`) handles scheduling, failure
injection, snapshots and reporting; each solver supplies ``init_state`` /
``make_step``, ``recovery_set``, ``reconstruct`` and ``wipe``.
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.spmv import make_det_dot
from repro_torch.core.state import RecoverySchema, RecoverySet, wipe_vectors
from repro_torch.kernels import ops


def solver_dot(op):
    """The inner product a solver must use: block-hierarchical with a
    pinned combine order over the operator's partition blocks, so the
    trajectory is bitwise the same whether ``op`` is a plain operator or
    a :class:`~repro_torch.distributed.sharding.ShardedOperator` on any
    shard count."""
    return make_det_dot(op.nblocks, getattr(op, "mesh", None))


def base_operator(op):
    """Unwrap a :class:`~repro_torch.distributed.sharding.ShardedOperator`
    (or any delegating wrapper exposing ``base``) for code that
    dispatches on the concrete operator type, e.g. closed-form spectral
    bounds."""
    return getattr(op, "base", op)


def device_norm(v: torch.Tensor) -> float:
    """``||v||`` computed on ``v``'s device (``sqrt(det_dot(v, v))``); only
    the scalar crosses to the host."""
    return float(torch.sqrt(ops.det_dot(v, v, 1)))


class RecoverableSolver(abc.ABC):
    """Base class / protocol for ESR-recoverable iterative solvers."""

    #: registry name ("pcg", ...)
    name: str = ""
    #: minimal recovery set declaration (drives backend slot layout)
    schema: RecoverySchema
    #: state fields holding block-distributed vectors (failure wipes them)
    state_vector_fields: Sequence[str] = ()
    #: state fields holding non-replicated reduction scalars (NaN'd on
    #: failure; restored by reconstruction)
    state_nan_scalars: Sequence[str] = ()

    #: whether the solver offers a :meth:`lane_step` for the batched
    #: multi-tenant service path; GMRES's restart-cycle step is
    #: host-orchestrated and stays solo-only
    batchable = False

    @abc.abstractmethod
    def init_state(self, op, precond, b, x0=None):
        """State after 0 completed iterations (with ``k`` and ``r``)."""

    @abc.abstractmethod
    def make_step(self, op, precond):
        """Return the one-iteration transition ``state -> state``."""

    @abc.abstractmethod
    def recovery_set(self, state, on_device: bool = False) -> RecoverySet:
        """The minimal persisted payload at this iteration: host arrays,
        or with ``on_device`` the state's own tensors (the erasure
        stripe then encodes them before the device-to-host copy)."""

    @abc.abstractmethod
    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        """Exactly rebuild the failed shards at ``snapshot.k``; ``sets``
        holds the recovered payload unions, oldest -> newest."""

    # ------------------------------------------------------------------
    @classmethod
    def lane_step(cls, op_apply, precond, dot, params):
        """One-iteration transition of a *bucket* of tenant lanes — the
        multi-tenant service path, where the reference vmaps one lane's
        step (:func:`repro_torch.solvers.driver.make_batched_step`).

        The state it takes holds ``(lanes, n)`` vector fields and
        ``(lanes, 1)`` per-lane scalar columns, so the solo step body
        broadcasts over the lanes unchanged; ``op_apply`` is the masked
        lane operator (one K1 launch for the bucket), ``precond`` the
        diagonal lane preconditioner (``apply`` and ``inv_diag``, both
        ``(lanes, n)``), ``dot`` the per-lane inner product (one
        ``det_dot_lanes`` launch, a ``(lanes, 1)`` column), and every
        per-tenant quantity (Chebyshev's ``c``/``sigma``, the Jacobi
        weight, BiCGStab's shadow residual) arrives stacked in ``params``
        as tensors.  Solvers share the step body with :meth:`make_step`.
        """
        raise NotImplementedError(
            f"solver {cls.name!r} has no batched lane step "
            f"(batchable={cls.batchable})")

    def lane_params(self):
        """The per-lane ``params`` :meth:`lane_step` consumes (name ->
        float or ``(n,)`` tensor), read off a solver built for this
        tenant (after :meth:`init_state` for solvers whose params are
        derived there).  Default: none."""
        return {}

    # ------------------------------------------------------------------
    def residual_norm(self, state) -> float:
        # One scalar crosses to the host; the reduction runs on the
        # device in a fixed order, so repeated runs read the same bits.
        return device_norm(state.r)

    def wipe(self, state, partition, blocks):
        """Simulate failure: failed shards of every distributed vector (and
        any non-replicated reduction scalar) become garbage."""
        return wipe_vectors(state, partition, blocks,
                            self.state_vector_fields, self.state_nan_scalars)

    # ------------------------------------------------------------------
    def host_shard(self, arr: torch.Tensor) -> np.ndarray:
        """Device -> host pull of a persisted vector: the one copy of the
        NVM-ESR tap (no collective)."""
        return arr.detach().cpu().numpy()

    @classmethod
    def from_problem(cls, op=None, precond=None, **opts) -> "RecoverableSolver":
        """Registry hook: build a solver tuned to (op, precond)."""
        return cls(**opts)


class IterateOnlyRecovery:
    """Shared implementation for solvers whose minimal recovery set is the
    iterate itself — schema ``{x}``, history 1.  The state class must be
    ``(x, r, k)``; reconstruction is a scatter of the persisted shard plus
    the direct residual restriction (no local solve)."""

    state_cls: type
    state_vector_fields = ("x", "r")
    state_nan_scalars = ()

    def init_state(self, op, precond, b, x0=None):
        x0 = torch.zeros_like(b) if x0 is None else x0
        return self.state_cls(x=x0, r=b - op.apply(x0), k=0)

    def recovery_set(self, state, on_device: bool = False) -> RecoverySet:
        x = state.x if on_device else self.host_shard(state.x)
        return RecoverySet(k=int(state.k), scalars={}, vectors={"x": x})

    def reconstruct(self, op, precond, b, snapshot, failed_blocks,
                    sets: Sequence[RecoverySet], local_method: str = "auto"):
        from repro_torch.core.reconstruction import residual_on_failed

        part = op.partition
        failed = list(failed_blocks)
        x_f = torch.as_tensor(sets[-1].vectors["x"], dtype=b.dtype,
                              device=b.device)
        x = part.scatter(snapshot.x, x_f, failed)
        r = part.scatter(snapshot.r, residual_on_failed(op, b, x, failed), failed)
        return self.state_cls(x=x, r=r, k=snapshot.k)
