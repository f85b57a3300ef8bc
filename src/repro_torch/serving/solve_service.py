"""Multi-tenant batched solve service with failure-isolated tenants (port
of ``repro/serving/solve_service.py``).

Many concurrent :class:`~repro_torch.api.Problem` requests share one
process: the service buckets them by padded size (pad each grid
dimension to the next power of two, min 4, so a handful of bucket shapes
serve arbitrary tenant sizes), embeds each tenant in one *lane* of a
fixed-width bucket, and advances every bucket with one batched
recoverable driver step (:func:`repro_torch.solvers.driver.
make_batched_step`).  The reference vmaps one lane's jitted step; the
port's hand-written kernels have no batching rule, so the lane axis is
explicit: one K1 launch applies every lane's operator, and PCG's lane
step runs K2 and ``det_dot`` in lane mode (``ops.fused_cg_update_lanes``,
``ops.det_dot_lanes``) — one launch each for the whole bucket.

**Masked lane embedding.**  A tenant grid sits in the corner of the
bucket grid behind a boolean mask ``m``; the lane operator is::

    A_lane(x) = where(m, stencil7(where(m, x, 0)), x)

— the tenant's own 7-point Dirichlet stencil on tenant cells (masked
neighbours contribute exactly the 0.0 the tenant's own zero boundary
would), and the *identity* on padding cells, which keeps the lane
operator SPD.  With ``b`` zero-embedded and ``x0 = 0``, padding entries
stay exactly 0.0 through every batchable solver family, so unpadding is
a pure gather.  Preconditioning is per-lane *data*, not code: a diagonal
``pdiag`` vector (1 on padding), which is why lanes carry
identity/Jacobi preconditioners only.

**Failure isolation.**  Each admitted tenant owns a full
:class:`~repro_torch.solvers.driver.PersistencePipeline` — its own
backend, session, campaign plan and metrics registry — with the tenant's
*declared logical* :class:`~repro_torch.distributed.sharding.ShardLayout`,
so ``shard=`` kills resolve to block sets without any device mesh.  A
:class:`~repro_torch.solvers.driver.FailureEvent` (block, shard or PRD
kill) addresses one tenant inside a live batch: the victim's lane state
is unpadded, recovered through the standard engine (wipe → drain → fetch
→ reconstruct → rollback) in tenant space, re-embedded, and written back
to its lane; every persisted payload comes from *unpadded lane states*.
Cohabitant lanes are untouched — lane ``i``'s output depends only on
lane ``i``'s inputs (the lane kernels reduce within a lane, never
across, and nothing reduces, checks or syncs over the bucket: a free
lane's ``0/0`` stays in its lane), so a cohabitant's trajectory is
bitwise its solo no-failure run through the same bucket shape.

**Admission.**  :meth:`SolveService.submit` validates the request,
resolves the resilience spec via the advisor
(:meth:`repro_torch.api.ResilienceSpec.advise`) when none is given, and
plans the campaign at submission — an unsurvivable campaign raises
:class:`~repro_torch.solvers.driver.UnsurvivableCampaignError` naming the
violating event.  The admission queue is bounded: a full queue returns a
``ServiceTicket(accepted=False)`` (counted, not raised).  Queue wait is
measured in deterministic service *steps*; it lands in each tenant's
:class:`~repro_torch.solvers.driver.SolveReport`
(``service_queue_wait_steps`` / ``service_lane_steps`` /
``service_batch_occupancy``) and in the service-labeled
:class:`~repro_torch.obs.metrics.MetricsRegistry`.

All of a service's tenants live on one device (the first tenant's); the
overlap window of a tenant's staged commit is the bucket step's wall
time, taken after the device finished the step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.poisson import (
    IdentityPreconditioner,
    JacobiPreconditioner,
    StencilOperator,
)
from repro_torch.distributed.sharding import ShardLayout
from repro_torch.kernels import ops
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.trace import ServiceRequest
from repro_torch.solvers.base import base_operator, device_norm
from repro_torch.solvers.driver import (
    PersistencePipeline,
    SolveConfig,
    SolveReport,
    _synchronize,
    make_batched_step,
    resolve_shard_events,
    should_persist,
)
from repro_torch.solvers.registry import SOLVERS

__all__ = [
    "ServiceConfig",
    "ServiceError",
    "ServiceTicket",
    "SolveService",
]


class ServiceError(ValueError):
    """A request the service cannot host (wrong operator family,
    non-diagonal preconditioner, non-batchable solver, a device other
    than its cohabitants').  Distinct from admission-control rejection,
    which is a ``ServiceTicket(accepted=False)``, and from campaign
    planning, which raises UnsurvivableCampaignError naming the violating
    event."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-wide knobs.

    ``lanes`` is the *fixed* lane width of every bucket — fixed so a
    bucket shape's step never changes, which scopes the cohabitant
    bit-identity contract.  ``max_queue`` bounds the admission queue; a
    submit against a full queue is rejected with a ticket, not an
    exception.  ``tracer`` feeds the service spans/events and every
    tenant pipeline.  ``device`` is where :meth:`SolveService.
    submit_request` builds a request's problem (the card unless the
    caller asks for the CPU)."""

    lanes: int = 4
    max_queue: int = 8
    tracer: Optional[object] = None
    device: str = "cuda"


@dataclasses.dataclass
class ServiceTicket:
    """Admission-control outcome for one submitted request.  After the
    tenant completes (``SolveService.step``/``drain``/``replay``),
    ``result`` holds its :class:`~repro_torch.api.SolveResult`."""

    tenant: str
    accepted: bool
    reason: str = ""
    submitted_step: int = 0
    result: Optional[object] = None


def _bucket_dim(d: int) -> int:
    """Next power of two >= max(d, 4) — the bucket edge for a tenant grid
    edge (size bucketing: few shapes, bounded waste)."""
    p = 4
    while p < d:
        p *= 2
    return p


def _masked_stencil(mask: torch.Tensor, x: torch.Tensor,
                    grid: Tuple[int, int, int]) -> torch.Tensor:
    """``where(m, stencil7(where(m, x, 0)), x)`` on ``(..., n)`` vectors
    of the bucket grid: one K1 launch however many lanes lead."""
    xin = torch.where(mask, x, 0.0).reshape(*x.shape[:-1], *grid)
    return torch.where(mask, ops.stencil7(xin).reshape(x.shape), x)


class _LaneOperator:
    """One tenant's masked view of a bucket grid (module docstring): the
    tenant stencil on masked-in cells, identity on padding.  Used solo
    for ``init_state`` only; the batched step applies the same
    arithmetic to the stacked lanes, so init and step agree bit for
    bit."""

    def __init__(self, grid: Tuple[int, int, int], mask: torch.Tensor):
        self.grid = tuple(grid)
        self.mask = mask
        self.nblocks = 1  # lane dot = det_dot over one block

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _masked_stencil(self.mask, x, self.grid)


class _LanePreconditioner:
    """Diagonal preconditioner as lane data (1.0 on padding): one lane's
    ``(n,)`` or a bucket's ``(lanes, n)``."""

    def __init__(self, pdiag: torch.Tensor):
        self.inv_diag = pdiag

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.inv_diag


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner products as a ``(lanes, 1)`` column (one
    ``det_dot_lanes`` launch); lane ``i`` is bitwise ``det_dot(a[i],
    b[i], 1)``, the dot of the lane's solo init."""
    return ops.det_dot_lanes(a, b).unsqueeze(-1)


class _Tenant:
    """One admitted request: the real problem (for persistence and
    recovery, which run in tenant space) plus its lane embedding (for the
    batched step, which runs in bucket space)."""

    def __init__(self, name: str, problem, solver, config: SolveConfig,
                 backend, campaign, layout: ShardLayout, ticket: ServiceTicket,
                 capture_at: Sequence[int] = ()):
        self.name = name
        self.op = problem.op
        self.precond = problem.precond
        self.b = problem.b
        self.solver = solver
        self.tol = config.tol
        self.maxiter = config.maxiter
        self.period = config.persistence_period
        self.capture_at = frozenset(int(k) for k in capture_at)
        self.captured: Dict[int, object] = {}
        self.bnorm = device_norm(self.b)
        self.backend = backend
        self.ticket = ticket

        grid = tuple(base_operator(self.op).grid)
        self.bucket_grid = tuple(_bucket_dim(d) for d in grid)
        self.bucket_n = math.prod(self.bucket_grid)
        self.n_t = int(self.op.n)
        self.dtype = self.b.dtype
        device = self.b.device

        mask = torch.zeros(self.bucket_grid, dtype=torch.bool, device=device)
        mask[:grid[0], :grid[1], :grid[2]] = True
        self.lane_mask = mask.reshape(-1)
        self.idx = torch.nonzero(self.lane_mask).reshape(-1)

        pdiag = torch.ones(self.bucket_n, dtype=self.dtype, device=device)
        if isinstance(self.precond, JacobiPreconditioner):
            pdiag[self.idx] = self.precond.inv_diag
        self.lane_pdiag = pdiag
        b_pad = torch.zeros(self.bucket_n, dtype=self.dtype, device=device)
        b_pad[self.idx] = self.b

        # Lane-space init BEFORE the pipeline: solvers that derive lane
        # params in init_state (BiCGStab's rhat0) must see the lane b.
        lane_op = _LaneOperator(self.bucket_grid, self.lane_mask)
        self.lane_init = solver.init_state(lane_op, _LanePreconditioner(pdiag),
                                           b_pad)
        self.lane_params = solver.lane_params()

        # The tenant's own persistence/recovery engine, in TENANT space:
        # real operator, real preconditioner, declared logical layout.
        # plan_campaign fires here — at submission — so an unsurvivable
        # campaign raises before the tenant ever reaches the queue.
        self.pipe = PersistencePipeline(solver, self.op, self.precond, self.b,
                                        config, backend, campaign,
                                        layout=layout)
        self.report = SolveReport(solver=solver.name,
                                  persist_mode=config.persist_mode,
                                  metrics=self.pipe.metrics)
        self.wait_steps = 0
        self.lane_steps = 0
        self.occupancy_sum = 0.0

    @property
    def bucket_key(self) -> Tuple[str, Tuple[int, int, int], str]:
        return (self.solver.name, self.bucket_grid, str(self.dtype))

    def unpad(self, lane_state):
        """Lane -> tenant space: gather vector fields at the masked-in
        indices (a pure gather — padding is exactly 0 by invariant);
        scalars are copied out of the bucket (so no tenant state aliases
        a lane the bucket later overwrites) and ``k`` becomes an int."""

        def take(name, a):
            if name == "k":
                return int(a)
            if a.dim() == 1 and a.shape[0] == self.bucket_n:
                return a.index_select(0, self.idx)
            return a.clone()

        return type(lane_state)(*[take(f, v) for f, v in
                                  zip(lane_state._fields, lane_state)])

    def pad(self, state):
        """Tenant -> lane space: scatter vector fields into a zeroed
        bucket vector (re-establishing the padding-is-0 invariant after a
        recovery rewrites the tenant state)."""

        def put(name, a):
            if name != "k" and a.dim() == 1 and a.shape[0] == self.n_t:
                out = torch.zeros(self.bucket_n, dtype=a.dtype,
                                  device=a.device)
                out[self.idx] = a
                return out
            return a

        return type(state)(*[put(f, v) for f, v in zip(state._fields, state)])


class _Bucket:
    """One bucket shape: (solver family, bucket grid, dtype) with a fixed
    number of lanes.  Stacked lane data (mask, pdiag, per-lane solver
    params) and stacked states advance together through one batched step;
    free lanes carry inert data (mask all False, pdiag/params 1) whose
    arithmetic never feeds a live lane.  Vector fields are ``(lanes, n)``
    on the device, per-lane scalars ``(lanes,)``, params ``(lanes, 1)`` or
    ``(lanes, n)``, and ``k`` a ``(lanes,)`` host tensor: the host reads
    it every step without waiting for the device."""

    def __init__(self, solver_cls, grid: Tuple[int, int, int], lanes: int,
                 dtype: torch.dtype, device: torch.device):
        self.grid = tuple(grid)
        self.n = math.prod(grid)
        self.lanes = lanes
        self.dtype = dtype
        self.device = device
        self.tenants: List[Optional[_Tenant]] = [None] * lanes
        self.masks = torch.zeros((lanes, self.n), dtype=torch.bool,
                                 device=device)
        self.pdiags = torch.ones((lanes, self.n), dtype=dtype, device=device)
        self.params: Dict[str, torch.Tensor] = {}
        self.states = None
        self.occupancy = 0.0

        grid_t = self.grid

        def make_lane_ops(lane):
            mask = lane["mask"]

            def op_apply(x):
                return _masked_stencil(mask, x, grid_t)

            return (op_apply, _LanePreconditioner(lane["pdiag"]), _lane_dot,
                    lane["params"])

        self.step = make_batched_step(solver_cls, make_lane_ops)

    def free_lane_count(self) -> int:
        return sum(1 for t in self.tenants if t is None)

    def live(self) -> List[_Tenant]:
        return [t for t in self.tenants if t is not None]

    def lane_data(self) -> Dict[str, object]:
        return {"mask": self.masks, "pdiag": self.pdiags,
                "params": self.params}

    def lane_state(self, i: int):
        return type(self.states)(*[a[i] for a in self.states])

    def set_lane_state(self, i: int, state) -> None:
        for stack, v in zip(self.states, state):
            stack[i] = v

    def admit(self, tenant: _Tenant) -> int:
        i = self.tenants.index(None)
        self.tenants[i] = tenant
        self.masks[i] = tenant.lane_mask
        self.pdiags[i] = tenant.lane_pdiag
        init = tenant.lane_init
        params = {name: torch.as_tensor(v, dtype=self.dtype,
                                        device=self.device).reshape(-1)
                  for name, v in tenant.lane_params.items()}
        if self.states is None:
            self.states = type(init)(*[
                torch.zeros(self.lanes, dtype=torch.int64) if f == "k"
                else torch.zeros((self.lanes,) + tuple(v.shape),
                                 dtype=v.dtype, device=v.device)
                for f, v in zip(init._fields, init)])
            self.params = {name: torch.ones((self.lanes, v.numel()),
                                            dtype=self.dtype,
                                            device=self.device)
                           for name, v in params.items()}
        self.set_lane_state(i, init)
        for name, v in params.items():
            self.params[name][i] = v
        return i

    def free(self, i: int) -> None:
        self.tenants[i] = None
        self.masks[i] = False
        self.pdiags[i] = 1.0
        for stack in self.states:
            stack[i] = 0
        for stack in self.params.values():
            stack[i] = 1.0


class SolveService:
    """The multi-tenant batched solve service (module docstring).

    Drive it with :meth:`submit` + :meth:`step`/:meth:`drain`, or replay
    a declarative :class:`~repro_torch.serving.trace.ServiceRequest`
    trace with :meth:`replay`.  ``service.metrics`` is the
    service-labeled registry (counters ``service.submitted`` /
    ``service.rejected`` / ``service.admitted`` / ``service.completed``,
    gauge ``service.queue_depth``, histograms
    ``service.queue_wait_steps`` / ``service.batch_occupancy``)."""

    def __init__(self, config: ServiceConfig = ServiceConfig()):
        self.config = config
        # normalize the tracer once; every site identity-guards
        self._trace = config.tracer or None
        self.metrics = MetricsRegistry(service="solve")
        self._queue: List[_Tenant] = []
        self._buckets: Dict[tuple, _Bucket] = {}
        self._now = 0
        self._nsubmitted = 0
        self._device: Optional[torch.device] = None

    @property
    def now(self) -> int:
        """Completed service steps (the deterministic service clock)."""
        return self._now

    @property
    def active(self) -> int:
        return sum(len(b.live()) for b in self._buckets.values())

    @property
    def queued(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ admission
    def submit(self, problem, solver=None, resilience=None, failures=(),
               *, tenant: Optional[str] = None, nshards: int = 1,
               capture_states_at: Sequence[int] = ()) -> ServiceTicket:
        """Submit one tenant request.

        ``solver``/``resilience`` accept specs or registry name strings;
        ``resilience=None`` asks the advisor for the cheapest spec that
        carries ``failures``.  ``nshards`` declares the tenant's
        *logical* shard layout (``shard=`` events resolve against it; it
        also becomes the report's ``nshards`` and the per-shard traffic
        labels).  Raises :class:`ServiceError` for requests the service
        cannot host and UnsurvivableCampaignError (from the submission-
        time campaign plan or the advisor) naming the violating event;
        returns a rejected ticket — no exception — when the bounded
        queue is full."""
        from repro_torch import api

        self.metrics.counter("service.submitted").inc()
        name = tenant if tenant is not None else f"tenant{self._nsubmitted}"
        self._nsubmitted += 1
        trace = self._trace
        if trace is not None:
            trace.event("service.submit", tenant=name, step=self._now)

        if solver is None:
            solver = api.SolverSpec()
        elif isinstance(solver, str):
            solver = api.SolverSpec(solver)
        if isinstance(resilience, str):
            resilience = api.ResilienceSpec(resilience)

        op = problem.op
        if not isinstance(base_operator(op), StencilOperator):
            raise ServiceError(
                f"service buckets embed 7-point stencil operators only, "
                f"got {type(base_operator(op)).__name__}")
        if not isinstance(problem.precond,
                          (IdentityPreconditioner, JacobiPreconditioner)):
            raise ServiceError(
                f"service lanes carry diagonal (identity/Jacobi) "
                f"preconditioners only, got "
                f"{type(problem.precond).__name__}")
        device = problem.b.device
        if self._device is not None and device != self._device:
            raise ServiceError(
                f"the service's tenants live on {self._device}; a problem "
                f"on {device} cannot share its buckets")
        solver_cls = SOLVERS.get(solver.name)
        if solver_cls is None:
            from repro_torch.nvm.backend import unknown_name_error

            raise unknown_name_error("solver", solver.name, SOLVERS)
        if not getattr(solver_cls, "batchable", False):
            raise ServiceError(
                f"solver {solver.name!r} has no batched lane step; run "
                f"it through api.solve")

        layout = ShardLayout(op.nblocks, nshards)
        campaign = resolve_shard_events(failures, layout)
        if resilience is None:
            resilience = api.ResilienceSpec.advise(problem, campaign,
                                                   solver=solver)

        # Bounded admission queue: backpressure before any build work.
        if len(self._queue) >= self.config.max_queue:
            self.metrics.counter("service.rejected").inc()
            if trace is not None:
                trace.event("service.reject", tenant=name,
                            reason="queue full")
            return ServiceTicket(tenant=name, accepted=False,
                                 reason="queue full",
                                 submitted_step=self._now)

        built = solver.build(problem)
        backend = resilience.build(problem, built)
        cfg = SolveConfig(tol=solver.tol, maxiter=solver.maxiter,
                          persistence_period=resilience.period,
                          persist_mode=resilience.persist_mode,
                          plan_campaign=resilience.plan_campaigns,
                          tracer=self._trace)
        ticket = ServiceTicket(tenant=name, accepted=True,
                               submitted_step=self._now)
        t = _Tenant(name, problem, built, cfg, backend, campaign, layout,
                    ticket, capture_states_at)
        self._device = device
        self._queue.append(t)
        self.metrics.gauge("service.queue_depth").set(len(self._queue))
        return ticket

    def submit_request(self, req: ServiceRequest) -> ServiceTicket:
        """Submit a declarative trace request (repro_torch.serving.trace),
        its problem built on ``config.device``."""
        return self.submit(req.problem(device=self.config.device),
                           solver=req.solver_spec(),
                           resilience=req.resilience_spec(),
                           failures=req.failures, tenant=req.tenant,
                           nshards=req.nshards,
                           capture_states_at=req.capture_states_at)

    def _admit(self) -> None:
        """Order-preserving first-fit: walk the queue once, seating every
        request whose bucket has a free lane (later requests may seat
        past a blocked head — deterministic, and keeps unrelated bucket
        shapes from head-of-line blocking each other)."""
        trace = self._trace
        still: List[_Tenant] = []
        for t in self._queue:
            bucket = self._buckets.get(t.bucket_key)
            if bucket is None:
                bucket = _Bucket(SOLVERS[t.solver.name], t.bucket_grid,
                                 self.config.lanes, t.dtype, t.b.device)
                self._buckets[t.bucket_key] = bucket
            if bucket.free_lane_count() == 0:
                still.append(t)
                continue
            lane = bucket.admit(t)
            t.wait_steps = self._now - t.ticket.submitted_step
            self.metrics.counter("service.admitted").inc()
            if trace is not None:
                trace.event("service.admit", tenant=t.name, lane=lane,
                            waited=t.wait_steps)
                trace.event("solve.begin", solver=t.solver.name,
                            mode=t.report.persist_mode, maxiter=t.maxiter)
            # Iteration 0 counts as persisted (driver contract) — from
            # the UNPADDED lane init, like every later persist point.
            if t.pipe.session is not None:
                t.pipe.persist_point(t.unpad(t.lane_init))
        self._queue = still
        self.metrics.gauge("service.queue_depth").set(len(self._queue))

    # ------------------------------------------------------------ stepping
    def step(self) -> None:
        """One deterministic service step: admit from the queue, then for
        every bucket run the driver loop-top per live lane (capture /
        convergence / failure injection+recovery), one batched step, and
        the post-step persistence schedule."""
        self._admit()
        trace = self._trace
        if trace is None:
            self._step_buckets()
        else:
            with trace.span("service.step", step=self._now,
                            active=self.active, queued=len(self._queue)):
                self._step_buckets()
        self._now += 1

    def _step_buckets(self) -> None:
        for key in sorted(self._buckets):
            bucket = self._buckets[key]
            for i, t in enumerate(list(bucket.tenants)):
                if t is not None:
                    self._pre_step(bucket, i, t)
            live = bucket.live()
            if not live:
                continue
            bucket.occupancy = len(live) / bucket.lanes
            t0 = time.perf_counter()
            bucket.states = bucket.step(bucket.states, bucket.lane_data())
            # the overlap window ends when the device finished the step
            _synchronize(bucket.device)
            window = time.perf_counter() - t0
            for i, t in enumerate(list(bucket.tenants)):
                if t is not None:
                    self._post_step(bucket, i, t, window)

    def _pre_step(self, bucket: _Bucket, i: int, t: _Tenant) -> None:
        """The driver loop-top for one lane, iterated exactly like the
        solo loop's ``continue``: capture, residual append, convergence,
        then at most one pending failure event per pass — a recovery
        rolls k back and the loop re-checks at the recovered k."""
        while True:
            st = bucket.lane_state(i)
            k = int(st.k)
            if k >= t.maxiter:
                self._finalize(bucket, i, t, st)
                return
            st_t = t.unpad(st)
            if k in t.capture_at:
                t.captured[k] = st_t
            relres = t.solver.residual_norm(st_t) / t.bnorm
            t.report.residual_history.append(relres)
            if relres < t.tol:
                t.report.converged = True
                self._finalize(bucket, i, t, st)
                return
            ev = t.pipe.pop_event(k)
            if ev is None:
                return
            st_rec = t.pipe.inject(ev, st_t, k)
            if st_rec is not st_t:
                # Block/shard recovery: re-embed the reconstructed
                # tenant state into the lane (padding back to exact 0).
                bucket.set_lane_state(i, t.pad(st_rec))
            # storage-only kills leave the lane untouched; either way
            # the loop re-runs at the (possibly rolled-back) k.

    def _post_step(self, bucket: _Bucket, i: int, t: _Tenant,
                   window: float) -> None:
        st = bucket.lane_state(i)
        t.lane_steps += 1
        t.occupancy_sum += bucket.occupancy
        pipe = t.pipe
        if pipe.session is None:
            return
        if pipe.staged_state is not None:
            # Overlap window: the staged commit rides behind this
            # step's batched compute (the bucket's measured wall).
            pipe.persist_commit(window)
        if should_persist(int(st.k), t.period, pipe.history):
            pipe.persist_point(t.unpad(st))

    def _finalize(self, bucket: _Bucket, i: int, t: _Tenant,
                  lane_state) -> None:
        st_t = t.unpad(lane_state)
        tm = t.pipe.metrics
        tm.counter("service.wait_steps").inc(t.wait_steps)
        tm.counter("service.lane_steps").inc(t.lane_steps)
        t.pipe.finalize(t.report, st_t, t.bnorm)
        rep = t.report
        # Derived views: read the service fields back OUT of the tenant
        # registry, like every other report counter.
        rep.service_queue_wait_steps = tm.counter_value("service.wait_steps")
        rep.service_lane_steps = tm.counter_value("service.lane_steps")
        rep.service_batch_occupancy = (
            t.occupancy_sum / t.lane_steps if t.lane_steps else 0.0)
        self.metrics.counter("service.completed").inc()
        self.metrics.histogram("service.queue_wait_steps").observe(
            float(t.wait_steps))
        self.metrics.histogram("service.batch_occupancy").observe(
            rep.service_batch_occupancy)
        trace = self._trace
        if trace is not None:
            trace.event("service.complete", tenant=t.name,
                        iterations=rep.iterations, converged=rep.converged)
        from repro_torch import api

        t.ticket.result = api.SolveResult(state=st_t, report=rep,
                                          captured=t.captured,
                                          backend=t.backend)
        bucket.free(i)

    # ------------------------------------------------------------ driving
    def drain(self, max_steps: int = 100_000) -> None:
        """Step until the queue and every lane are empty."""
        steps = 0
        while self._queue or self.active:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"service did not drain within {max_steps} steps "
                    f"({self.active} active, {len(self._queue)} queued)")

    def replay(self, requests: Sequence[ServiceRequest],
               max_steps: int = 100_000) -> Dict[str, ServiceTicket]:
        """Replay a declarative request trace against the service clock:
        each request is submitted when its ``at_step`` arrives, the
        service steps while work is live, and idle gaps fast-forward to
        the next arrival.  Returns tenant -> ticket (rejected tickets
        included; their ``result`` stays None)."""
        pending = sorted(requests, key=lambda r: (r.at_step, r.tenant))
        tickets: Dict[str, ServiceTicket] = {}
        i = 0
        steps = 0
        while i < len(pending) or self._queue or self.active:
            while i < len(pending) and pending[i].at_step <= self._now:
                tickets[pending[i].tenant] = self.submit_request(pending[i])
                i += 1
            if self._queue or self.active:
                self.step()
            else:
                self._now += 1  # idle tick toward the next arrival
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"service replay did not finish within {max_steps} "
                    f"steps ({self.active} active, {len(self._queue)} "
                    f"queued, {len(pending) - i} pending)")
        return tickets
