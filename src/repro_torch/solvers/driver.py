"""Generic ESR solve loop for any :class:`RecoverableSolver` (port of
``repro/solvers/driver.py``: the config, campaign, planner, spec
advisor, report, persistence pipeline, solve loop and the batched lane
step of the multi-tenant service).  A problem sharded on a data mesh
(:class:`~repro_torch.distributed.sharding.ShardedOperator`) solves
shard by shard, bitwise its unsharded solve, and ``FailureEvent(shard=
...)`` kills one shard's blocks.

The runtime machinery of the paper:

- the persistence schedule (classic ESR: every iteration; ESRP: bursts of
  ``schema.history`` successive iterations every period ``T``),
- the persistence *pipeline*: synchronous (persist on the critical path,
  the paper's host-pull baseline) or overlapped (``session.begin`` stages
  the payload, ``session.commit`` flushes it while the next iteration's
  compute is in flight),
- failure injection — single plans or multi-event :class:`FailureCampaign`
  scenarios (overlapping failures during an in-flight recovery, repeated
  failures of the same block, ``prd=True`` events that crash the
  persistence service itself),
- campaign *planning* (:func:`plan_campaign`) against the backend's
  declared :class:`~repro_torch.nvm.backend.BackendCapabilities`,
- the survivor-side snapshot at the last *durable* persistence run,
- recovery (backend fetch + solver-specific exact reconstruction) with
  the rollback-agreement cross-check,
- convergence monitoring and reporting.

The solve runs on the device of the right-hand side ``b``.  Per
iteration the host reads one scalar (the residual norm) and, at each
persistence point, the persisted vector (``RecoverableSolver.host_shard``)
or, on the fused persist path of an erasure stripe, its K+P stripe
shards, encoded on the device first (kernel K3, or K4 inside the step).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.nvm.backend import (
    BackendCapabilities,
    ErasureSession,
    StagedStripe,
    UnrecoverableFailure,
    open_persist_session,
)
from repro_torch.distributed.sharding import place_state
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.solvers.base import device_norm

PERSIST_MODES = ("sync", "overlap")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    tol: float = 1e-10            # relative residual tolerance ||r|| / ||b||
    maxiter: int = 10_000
    persistence_period: int = 1   # T=1: classic ESR; T>1: ESRP bursts
    local_solve: str = "auto"     # reconstruction local solver
    persist_mode: str = "sync"    # "sync": persist on the critical path;
    #                               "overlap": commit hides behind compute
    plan_campaign: bool = True    # pre-flight plan_campaign() against the
    #                               backend's declared capabilities; False
    #                               runs unplanned (failures surface at the
    #                               recovery fetch instead)
    fused_persist: bool = False   # fused persist path (DESIGN.md §13):
    #                               an erasure stripe encodes parity on
    #                               the device (K3) from the device
    #                               recovery set; in overlap mode the
    #                               staging is deferred into the next
    #                               iteration's timed window and, when
    #                               K | block_size, rides that step in
    #                               kernel K4.  Slot bytes and commit
    #                               order equal the numpy path's, so
    #                               solves are bitwise identical either way
    tracer: Optional[object] = None  # a repro_torch.obs.Tracer records
    #                               spans / events through the pipeline;
    #                               None (or any falsy tracer) keeps the
    #                               hot path a strict no-op


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Inject a failure of ``blocks`` right after iteration ``at_iteration``
    (the single-event form, kept for the pre-campaign API)."""

    at_iteration: int
    blocks: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One failure in a :class:`FailureCampaign`.

    Exactly one trigger must be set:

    - ``at_iteration`` — fire when the solver reaches this iteration
      (equivalent to a :class:`FailurePlan`).
    - ``during_recovery_at`` — fire *while the recovery* of the
      ``at_iteration`` event with this trigger value is in flight: the
      driver has already fetched recovery payloads for the earlier failed
      set when this event lands, so that fetch is discarded and the
      recovery restarts with the enlarged union (an overlapping failure).
      ``blocks`` may repeat already-failed blocks (a second crash of the
      same node mid-recovery).

    ``prd=True`` additionally crashes the **persistence-service node**
    (the PRD node / pool service) at the trigger: staged payloads die,
    unflushed epochs are torn away, and — unless the backend's
    :class:`~repro_torch.nvm.backend.BackendCapabilities` declare
    ``survives_prd_loss`` (mirrors, the ``erasure(...)`` stripe) — any
    later recovery fetch raises
    :class:`~repro_torch.nvm.backend.UnrecoverableFailure`.  A ``prd`` event
    may carry no blocks (the PRD dies alone; the solve itself
    continues, unprotected).

    ``shard`` names a *shard* instead of (or in addition to) explicit
    blocks: the event kills every block the shard owns (the paper's
    per-node failure unit).  The driver resolves ``shard`` against the
    solve's :class:`~repro_torch.distributed.sharding.ShardLayout` (a
    service tenant's declared logical one) before planning, so the
    planner and the recovery engine only ever see blocks; a ``shard``
    event without a layout is an error (there is no node to kill)."""

    blocks: Tuple[int, ...] = ()
    at_iteration: Optional[int] = None
    during_recovery_at: Optional[int] = None
    prd: bool = False
    shard: Optional[int] = None

    def __post_init__(self):
        if not self.blocks and self.shard is None and not self.prd:
            raise ValueError("a FailureEvent needs at least one block")
        if (self.at_iteration is None) == (self.during_recovery_at is None):
            raise ValueError(
                "set exactly one of at_iteration / during_recovery_at")
        if self.at_iteration is not None and self.at_iteration < 1:
            raise ValueError(
                f"FailureEvent.at_iteration must be >= 1 (iteration 0 "
                f"precedes the first persisted recovery point), got "
                f"{self.at_iteration}")
        if self.shard is not None and self.shard < 0:
            raise ValueError(
                f"FailureEvent.shard must be >= 0, got {self.shard}")


@dataclasses.dataclass(frozen=True)
class FailureCampaign:
    """A multi-failure scenario: iteration-triggered events plus
    overlapping events that land during those events' recoveries."""

    events: Tuple[FailureEvent, ...]

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        triggers = {e.at_iteration for e in self.events
                    if e.at_iteration is not None}
        for e in self.events:
            if (e.during_recovery_at is not None
                    and e.during_recovery_at not in triggers):
                raise ValueError(
                    f"during_recovery_at={e.during_recovery_at} matches no "
                    f"at_iteration event in the campaign")


class UnsurvivableCampaignError(UnrecoverableFailure):
    """Raised by :func:`plan_campaign` *before iteration 0* for a
    campaign the backend's declared capabilities provably cannot
    survive.  Subclasses :class:`~repro_torch.nvm.backend.UnrecoverableFailure`
    because it reports the same fact — a recovery fetch that cannot be
    served — just at plan time instead of mid-solve."""


@dataclasses.dataclass(frozen=True)
class PlannedRecovery:
    """One recovery the campaign will force: the iteration that triggers
    it, the final failed-block union its fetch must serve (after all
    overlapping events), how many persistence-service losses will have
    accumulated by its last fetch, and how many stale-fetch restarts
    overlapping events will cause."""

    at_iteration: int
    blocks: Tuple[int, ...]
    storage_losses: int
    restarts: int


@dataclasses.dataclass(frozen=True)
class CampaignPlan:
    """The planner's verdict on a survivable campaign: the recoveries it
    will force, in trigger order, and the total storage losses."""

    recoveries: Tuple[PlannedRecovery, ...]
    storage_losses: int


def resolve_shard_events(campaign, layout=None) -> "FailureCampaign":
    """Resolve ``FailureEvent(shard=...)`` triggers into block sets.

    ``layout`` is the solve's
    :class:`~repro_torch.distributed.sharding.ShardLayout` (None for an
    unsharded solve).  Each shard event's block set becomes the union of
    its explicit blocks and the blocks the shard owns, so everything
    downstream — the planner's budget walk, ``solver.wipe``,
    ``session.fail``, the recovery fetch — speaks blocks only.  A shard
    event without a layout is refused (there is no node to kill), and an
    out-of-range shard index fails here, before iteration 0."""
    campaign = _as_campaign(campaign)
    if not any(e.shard is not None for e in campaign.events):
        return campaign
    if layout is None:
        raise ValueError(
            "FailureEvent(shard=...) needs a sharded solve: the operator "
            "carries no ShardLayout (shard the problem with "
            "Problem.with_shards, declare the tenant's nshards= on the "
            "solve service, or address blocks directly)")
    events = []
    for ev in campaign.events:
        if ev.shard is None:
            events.append(ev)
            continue
        blocks = tuple(sorted(set(ev.blocks) | set(layout.blocks_of(ev.shard))))
        events.append(dataclasses.replace(ev, blocks=blocks, shard=None))
    return FailureCampaign(tuple(events))


def plan_campaign(campaign, capabilities: BackendCapabilities,
                  tracer=None, layout=None) -> CampaignPlan:
    """Check a campaign against a backend's declared capabilities.

    Walks the campaign exactly as the solve loop will execute it —
    iteration-triggered events in order, each recovery absorbing its
    ``during_recovery_at`` events one refetch at a time — and verifies
    that every recovery *fetch* the campaign forces can be served:

    - the failed-block union at each fetch must not exceed
      ``capabilities.max_block_failures`` (peer-RAM copy placement),
    - the persistence-service losses accumulated by each fetch must not
      exceed ``capabilities.max_storage_failures`` (mirror / parity
      budget) — a ``prd=True`` event *after* the last fetch is
      survivable and accepted, matching the runtime semantics,
    - any failed blocks at all require ``capabilities.survives_node_loss``.

    Returns the :class:`CampaignPlan` for a survivable campaign; raises
    :class:`UnsurvivableCampaignError` naming the violating
    :class:`FailureEvent` otherwise.  ``campaign`` may be a
    :class:`FailureCampaign` or any sequence :func:`solve` accepts.
    ``layout`` (a :class:`~repro_torch.distributed.sharding.ShardLayout`)
    resolves ``shard=`` events to their block sets first.
    A ``tracer`` (repro_torch.obs) records the verdict as a ``plan.accept``
    or ``plan.reject`` event.
    """
    trace = tracer or None
    campaign = resolve_shard_events(campaign, layout)
    try:
        plan = _plan_campaign_walk(campaign, capabilities)
    except UnsurvivableCampaignError as e:
        if trace is not None:
            trace.event("plan.reject", reason=str(e))
        raise
    if trace is not None:
        trace.event("plan.accept", recoveries=len(plan.recoveries),
                    storage_losses=plan.storage_losses)
    return plan


def _plan_campaign_walk(campaign,
                        capabilities: BackendCapabilities) -> CampaignPlan:
    campaign = _as_campaign(campaign)
    max_storage = capabilities.max_storage_failures
    max_blocks = capabilities.max_block_failures
    during: Dict[int, List[FailureEvent]] = {}
    ordered: List[FailureEvent] = []
    for ev in campaign.events:
        if ev.at_iteration is None:
            during.setdefault(ev.during_recovery_at, []).append(ev)
        else:
            ordered.append(ev)
    ordered.sort(key=lambda e: e.at_iteration)

    losses = 0
    fatal_loss: Optional[FailureEvent] = None  # the loss past the budget
    recoveries: List[PlannedRecovery] = []
    for ev in ordered:
        if ev.prd:
            losses += 1
            if losses > max_storage and fatal_loss is None:
                fatal_loss = ev
        if not ev.blocks:
            # Storage-only event: no compute state lost, no recovery
            # fetch here; the loss is latent until a later fetch.
            continue
        queue = list(during.pop(ev.at_iteration, ()))
        union: set = set()
        cur, restarts = ev, 0
        while True:
            union |= set(cur.blocks)
            if union and not capabilities.survives_node_loss:
                raise UnsurvivableCampaignError(
                    f"campaign rejected before iteration 0: {cur} fails "
                    f"compute blocks but the backend declares "
                    f"survives_node_loss=False")
            if max_blocks is not None and len(union) > max_blocks:
                raise UnsurvivableCampaignError(
                    f"campaign rejected before iteration 0: the recovery "
                    f"at iteration {ev.at_iteration} must fetch the "
                    f"{len(union)}-block union {tuple(sorted(union))}, "
                    f"beyond capabilities.max_block_failures={max_blocks}; "
                    f"violating event: {cur}")
            if losses > max_storage:
                raise UnsurvivableCampaignError(
                    f"campaign rejected before iteration 0: the recovery "
                    f"at iteration {ev.at_iteration} fetches after "
                    f"{losses} persistence-service (PRD) losses, beyond "
                    f"capabilities.max_storage_failures={max_storage}; "
                    f"violating event: {fatal_loss}")
            if not queue:
                break
            cur = queue.pop(0)
            restarts += 1
            if cur.prd:
                losses += 1
                if losses > max_storage and fatal_loss is None:
                    fatal_loss = cur
        recoveries.append(PlannedRecovery(
            at_iteration=ev.at_iteration, blocks=tuple(sorted(union)),
            storage_losses=losses, restarts=restarts))
    return CampaignPlan(tuple(recoveries), losses)


# ----------------------------------------------------------------------
# The cheapest-spec advisor (DESIGN.md §8): plan_campaign as a filter,
# declared footprint + modeled persist cost as the ranking.
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpecRanking:
    """One candidate's evaluation by :func:`advise_spec`.

    - ``spec`` — the candidate's spec string (registry-composable).
    - ``survivable`` — whether :func:`plan_campaign` accepted the
      campaign against the candidate's declared capabilities.
    - ``reason`` — the planner's rejection message ("" when survivable).
    - ``storage_values`` — declared redundancy footprint in values (RAM
      overhead + persistent-tier residency), the primary ranking key.
    - ``persist_cost_s`` — modeled cost of one full persist event
      through the candidate (the probe write), the tie-breaker; NaN
      when no probe size was given.
    """

    spec: str
    survivable: bool
    reason: str
    storage_values: int
    persist_cost_s: float


@dataclasses.dataclass(frozen=True)
class SpecAdvice:
    """The advisor's verdict: the cheapest survivable spec (``chosen``,
    None when nothing survives), every survivor cheapest-first
    (``ranked``), and the rejected candidates with the planner's reason
    (``rejected``)."""

    chosen: Optional[str]
    ranked: Tuple[SpecRanking, ...]
    rejected: Tuple[SpecRanking, ...]


def _probe_persist_cost(backend, nvalues: int) -> float:
    """Modeled per-event cost of persisting one full durable run
    (``schema.history`` synthetic zero events) through ``backend``.
    The probe fills slots ``k=0..history-1``, so callers hand the
    advisor disposable, freshly built candidates — it also settles
    residency-based footprint accounting (the in-memory backend counts
    *resident* values, which are zero before anything is persisted)."""
    schema = backend.schema
    session = backend.open_session(schema)
    scalars = {s: 0.0 for s in schema.scalars}
    vectors = {v: np.zeros(nvalues) for v in schema.vectors}
    costs = [session.persist(k, scalars, vectors)
             for k in range(schema.history)]
    return float(sum(costs) / len(costs))


def advise_spec(campaign, candidates,
                probe_values: Optional[int] = None,
                tracer=None) -> SpecAdvice:
    """Pick the cheapest candidate spec whose declared capabilities
    carry ``campaign``.

    ``candidates`` maps spec strings to *freshly built* backends (a
    mapping or a ``(spec, backend)`` sequence — build them with
    :func:`repro_torch.solvers.registry.make_backend`;
    ``repro_torch.api.advise`` does this from a
    :class:`~repro_torch.api.Problem`).  Each candidate is filtered
    through :func:`plan_campaign` against its
    :class:`~repro_torch.nvm.backend.BackendCapabilities`, then the
    survivors are ranked by declared storage footprint
    (``memory_overhead_values() + nvm_values()``, the paper's Fig. 2/8
    quantity) with the modeled per-event persist cost as tie-breaker —
    probed with one synthetic event of ``probe_values`` values when
    given (candidates are disposable: the probe writes their slot 0).

    Returns a :class:`SpecAdvice`; ``advice.chosen`` is None when no
    candidate survives (callers decide whether that is an error — the
    :meth:`repro_torch.api.ResilienceSpec.advise` surface raises
    :class:`UnsurvivableCampaignError`).  A ``tracer`` (repro_torch.obs)
    records one ``advise.candidate`` event per candidate and a final
    ``advise.chosen`` verdict.
    """
    trace = tracer or None
    items = (list(candidates.items()) if hasattr(candidates, "items")
             else list(candidates))
    ranked: List[SpecRanking] = []
    rejected: List[SpecRanking] = []
    for spec, backend in items:
        try:
            plan_campaign(campaign, backend.capabilities)
        except UnsurvivableCampaignError as e:
            storage = int(backend.memory_overhead_values()
                          + backend.nvm_values())
            rejected.append(SpecRanking(spec, False, str(e), storage,
                                        float("nan")))
            if trace is not None:
                trace.event("advise.candidate", spec=spec, survivable=False,
                            storage_values=storage)
            continue
        cost = (float("nan") if probe_values is None
                else _probe_persist_cost(backend, probe_values))
        # footprint measured after the probe, so residency-based
        # accounting (peer-RAM ESR) reflects a persisted run too
        storage = int(backend.memory_overhead_values() + backend.nvm_values())
        ranked.append(SpecRanking(spec, True, "", storage, cost))
        if trace is not None:
            trace.event("advise.candidate", spec=spec, survivable=True,
                        storage_values=storage, persist_cost_s=cost)
    ranked.sort(key=lambda r: (r.storage_values,
                               math.inf if math.isnan(r.persist_cost_s)
                               else r.persist_cost_s))
    chosen = ranked[0].spec if ranked else None
    if trace is not None:
        trace.event("advise.chosen", spec=chosen,
                    survivors=len(ranked), rejected=len(rejected))
    return SpecAdvice(chosen=chosen,
                      ranked=tuple(ranked), rejected=tuple(rejected))


@dataclasses.dataclass
class SolveReport:
    """Outcome and accounting of one driver run.

    Progress / outcome:

    - ``iterations`` — completed iterations at exit (``int(state.k)``).
    - ``wasted_iterations`` — iterations discarded by rollbacks: for each
      recovery, the distance from the failure iteration back to the
      durable recovery point (the ESRP trade-off, paper §2; also > 0 in
      overlap mode when the failure aborts a staged-but-uncommitted
      persist).
    - ``failures_recovered`` — failure *events* recovered, including
      overlapping events absorbed into a restarted recovery.
    - ``recovery_restarts`` — recoveries that had to discard an
      already-fetched payload and refetch because an overlapping failure
      enlarged the failed set mid-recovery.
    - ``storage_failures`` — persistence-service (PRD-node) crashes
      injected by ``FailureEvent(prd=True)`` campaign events; survived
      only by backends declaring ``survives_prd_loss``.
    - ``converged`` — relative residual reached ``SolveConfig.tol``.
    - ``final_relres`` — ``||b - A x|| / ||b||`` proxy at exit
      (``solver.residual_norm / ||b||``).
    - ``residual_history`` — the relative residual at the top of every
      main-loop pass (recovered iterations appear twice, by design).
    - ``solver`` — the solver's registry name.

    Persistence accounting (modeled seconds — see ``nvm/store.py`` for
    the simulation contract):

    - ``persist_events`` — committed persistence events (aborted staged
      events are not counted).
    - ``persist_cost_s`` — total commit cost: the tier/network write the
      backend models for a full persist of all blocks.
    - ``persist_stage_s`` — staging cost (the local DRAM copy of the slot
      payload) paid on the critical path in overlap mode; 0 in sync mode,
      where the whole persist is on the critical path.
    - ``persist_hidden_s`` — the part of ``persist_cost_s`` hidden behind
      the next iteration's compute (overlap mode; per event
      ``min(commit_cost, measured compute wall)``).
    - ``persist_exposed_s`` — ``persist_cost_s - persist_hidden_s``: what
      the solver actually waits for.  In sync mode this equals
      ``persist_cost_s``.
    - ``persist_drain_s`` — drain-barrier cost paid at recoveries and at
      exit (committing leftover staged payloads; for the PRD backend also
      joining the target-side exposure epoch).
    - ``persist_mode`` — the pipeline that produced these numbers.

    ``persist_hidden_fraction`` is the derived headline metric:
    ``persist_hidden_s / persist_cost_s`` (0.0 for a sync run or when
    nothing was persisted).

    Traffic accounting — logical slot-payload bytes at the
    driver/session boundary, metered by the session's
    :class:`~repro_torch.nvm.backend.SessionTraffic` and surfaced through
    the registry as ``persist.bytes`` / ``recovery.fetch_bytes`` counters
    labeled ``shard=N`` (shard 0 on a solo solve; a service tenant's
    declared logical layout labels its own):

    - ``nshards`` — shards of the solve (1 when unsharded).
    - ``persist_bytes`` / ``persist_bytes_by_shard`` — slot bytes each
      shard's blocks shipped to the persistence service.
    - ``recovery_fetch_bytes`` / ``recovery_fetch_bytes_by_shard`` —
      slot bytes recovery fetches moved back; proportional to the lost
      shard, not the problem (the paper's recovery-traffic claim).

    Observability (DESIGN.md §9):

    - ``persist_aborts`` — staged-but-uncommitted persist events dropped
      because the staging nodes died before the commit window.
    - ``metrics`` — the :class:`~repro_torch.obs.MetricsRegistry` the
      solve loop incremented; every numeric counter above is a *derived
      view* of it (read back out at exit).

    Service residency — set only when the solve ran as a tenant of
    :class:`repro_torch.serving.SolveService`; all three stay 0 on solo
    driver runs.  Measured in deterministic service steps, never
    wall-clock; the counters are derived views too
    (``SERVICE_REPORT_PAIRS``):

    - ``service_queue_wait_steps`` — steps spent queued before a lane
      seated the tenant.
    - ``service_lane_steps`` — steps resident in a lane (batched bucket
      steps the tenant rode).
    - ``service_batch_occupancy`` — mean live-lane fraction of the
      tenant's bucket over its residency.
    """

    iterations: int = 0
    wasted_iterations: int = 0
    failures_recovered: int = 0
    recovery_restarts: int = 0
    storage_failures: int = 0
    converged: bool = False
    final_relres: float = float("nan")
    persist_cost_s: float = 0.0
    persist_stage_s: float = 0.0
    persist_hidden_s: float = 0.0
    persist_exposed_s: float = 0.0
    persist_drain_s: float = 0.0
    persist_events: int = 0
    persist_aborts: int = 0
    persist_mode: str = "sync"
    nshards: int = 1
    persist_bytes: int = 0
    recovery_fetch_bytes: int = 0
    persist_bytes_by_shard: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    recovery_fetch_bytes_by_shard: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    residual_history: List[float] = dataclasses.field(default_factory=list)
    solver: str = ""
    metrics: Optional[MetricsRegistry] = None
    service_queue_wait_steps: int = 0
    service_lane_steps: int = 0
    service_batch_occupancy: float = 0.0

    @property
    def persist_hidden_fraction(self) -> float:
        if self.persist_cost_s <= 0.0:
            return 0.0
        return self.persist_hidden_s / self.persist_cost_s

    @property
    def persist_exposed_per_iteration(self) -> float:
        """Exposed persist seconds per completed iteration — the
        paper's time-overhead quantity normalized to solver progress
        (0.0 before any iteration completes)."""
        if self.iterations <= 0:
            return 0.0
        return self.persist_exposed_s / self.iterations


def should_persist(k: int, period: int, history: int = 2) -> bool:
    """Persistence schedule: classic ESR persists every iteration; ESRP
    persists bursts of ``history`` successive iterations every ``period``
    (the burst must complete a full recovery run, so its length is the
    schema's history)."""
    if period <= 1:
        return True
    return k % period < history


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a tensor dtype (slot sizing and payloads)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _synchronize(device: torch.device) -> None:
    """Wait for the queued device work (the overlap window's end)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_campaign(failures) -> FailureCampaign:
    """Normalize the ``failures`` argument: a campaign passes through; a
    sequence of plans/events becomes an iteration-triggered campaign."""
    if isinstance(failures, FailureCampaign):
        return failures
    events = []
    for f in failures:
        if isinstance(f, FailureEvent):
            events.append(f)
        elif isinstance(f, FailurePlan):
            # FailureEvent.__post_init__ re-validates at_iteration >= 1
            events.append(FailureEvent(blocks=tuple(f.blocks),
                                       at_iteration=f.at_iteration))
        else:
            raise TypeError(
                f"failures must be FailurePlan/FailureEvent entries or a "
                f"FailureCampaign, got {type(f).__name__}")
    return FailureCampaign(tuple(events))


class PersistencePipeline:
    """The per-solve persistence + recovery engine.

    The pipeline owns everything that is *not* the iteration itself:
    the :class:`~repro_torch.nvm.backend.PersistSession` (opened, traced, and
    shard-bound here), campaign normalization
    (:func:`resolve_shard_events`) and pre-flight planning
    (:func:`plan_campaign`), the survivor-side snapshot at the last
    durable run, the sync/overlap persist pipeline
    (:meth:`persist_point` / :meth:`persist_commit` /
    :meth:`persist_abort`), failure injection (:meth:`pop_event` /
    :meth:`inject`), the recovery engine (:meth:`run_recovery`), and
    the derived-view report readback (:meth:`finalize`).  The caller
    owns the state, the step function, and the loop: :func:`solve` runs
    one pipeline for its solo loop, the multi-tenant service
    (:mod:`repro_torch.serving.solve_service`) one per admitted tenant.

    ``layout`` overrides the operator's
    :class:`~repro_torch.distributed.sharding.ShardLayout` — the service
    passes a tenant's *declared logical* layout so ``shard=`` failure
    events resolve to block sets and per-shard bytes carry its labels.
    """

    def __init__(self, solver, op, precond, b, config: SolveConfig,
                 backend, failures=(), *, layout=None, metrics=None):
        if config.persist_mode not in PERSIST_MODES:
            raise ValueError(
                f"persist_mode must be one of {PERSIST_MODES}, "
                f"got {config.persist_mode!r}")
        self.solver = solver
        self.op = op
        self.precond = precond
        self.b = b
        self.config = config
        self.overlap = config.persist_mode == "overlap"
        # Normalize the tracer ONCE: a falsy tracer (None, NULL_TRACER)
        # becomes None here, and every instrumentation site below guards
        # with an identity check — so with tracing disabled the loop
        # executes zero tracer callables per iteration (the obs guard
        # test).
        self.trace = config.tracer or None
        # A sharded solve? The operator carries the block -> shard layout
        # and the data mesh; the service passes a tenant's declared
        # logical layout instead.
        self.layout = getattr(op, "layout", None) if layout is None else layout
        self.mesh = getattr(op, "mesh", None)
        self.history = solver.schema.history
        self.metrics = (MetricsRegistry(solver=solver.name,
                                        mode=config.persist_mode)
                        if metrics is None else metrics)
        part = getattr(op, "partition", None)
        self.session = None
        if backend is not None:
            self.session = open_persist_session(backend, solver.schema, part)
            if self.trace is not None:
                self.session.set_tracer(self.trace)
            binder = getattr(self.session, "bind_shards", None)
            if part is not None and binder is not None:
                # The session meters persist/fetch bytes per shard, each
                # block's bytes against its owning shard; an unsharded
                # solve puts every block on shard 0.
                shard_map = (self.layout.shard_of_block_map()
                             if self.layout is not None
                             else {blk: 0 for blk in range(part.nblocks)})
                binder(shard_of_block=shard_map,
                       slot_nbytes=solver.schema.slot_nbytes(
                           part.block_size, _numpy_dtype(b.dtype)))

        # Fused persist path (DESIGN.md §13): stripe sessions encode on
        # the device.  The stripe is handed the device recovery set, and
        # in overlap mode its geometry decides ONCE whether the deferred
        # staging rides the next step in kernel K4 (stage_geometry =
        # (K, P)) or is cut and encoded at the flush by K3.
        self.fused = bool(config.fused_persist) and self.session is not None
        self.device_vectors = False
        self.stage_geometry = None
        if self.fused:
            self.device_vectors = isinstance(self.session, ErasureSession)
            # K4 fuses a diagonal preconditioner (inv_diag) into the
            # update; any other (block Jacobi) stages through K3 at the
            # flush, and so does a sharded solve, whose step reduces
            # shard by shard (the reference encodes with its kernel at
            # the persist point there too)
            if (self.overlap and self.device_vectors and self.mesh is None
                    and hasattr(solver, "make_persist_step")
                    and getattr(precond, "inv_diag", None) is not None):
                self.stage_geometry = self.session.fused_geometry(
                    _numpy_dtype(b.dtype))

        # shard=... events become block events before anything else sees
        # them
        campaign = resolve_shard_events(failures, self.layout)
        if config.plan_campaign and campaign.events and backend is not None:
            caps = getattr(backend, "capabilities", None)
            if isinstance(caps, BackendCapabilities):
                # Pre-flight: reject a campaign the backend provably
                # cannot survive before any iteration runs (duck-typed
                # backends declare nothing, so nothing is provable — they
                # run unplanned and fail at the fetch instead).
                plan_campaign(campaign, caps, tracer=self.trace)

        self.at_events: Dict[int, List[FailureEvent]] = {}
        self.during_events: Dict[int, List[FailureEvent]] = {}
        for ev in campaign.events:
            if ev.at_iteration is not None:
                self.at_events.setdefault(ev.at_iteration, []).append(ev)
            else:
                self.during_events.setdefault(ev.during_recovery_at,
                                              []).append(ev)

        # Survivor-side snapshot at the last *durable* persistence run:
        # the surviving processes' own state copy kept in their local RAM
        # (cheap, one shard each).  Needed to roll back to the recovery
        # point when persistence is periodic (ESRP trade-off, paper §2).
        # In overlap mode the snapshot only advances when the run's final
        # commit lands — a staged-but-uncommitted persist is not a
        # recovery point.
        self.snapshot = None
        self.last_persisted_k: Optional[int] = None
        self.consecutive = 0
        self.staged_state = None  # payload staged, pending commit
        # Fused overlap only: persist point reached but staging deferred
        # into the next iteration's timed window (flush_pending_stage).
        # At most one of staged_state / pending_state is set at a time.
        self.pending_state = None

    # ------------------------------------------------------------------
    def _note_committed(self, st, cost: float, window_s: float) -> None:
        metrics, trace = self.metrics, self.trace
        metrics.histogram("persist.commit_s", phase="persist").observe(cost)
        metrics.counter("persist.commit").inc()
        hidden = min(cost, window_s)
        metrics.histogram("persist.hidden_s", phase="persist").observe(hidden)
        metrics.histogram("persist.exposed_s",
                          phase="persist").observe(cost - hidden)
        if trace is not None:
            trace.event("persist.commit", k=int(st.k), cost_s=cost,
                        hidden_s=hidden, exposed_s=cost - hidden)
        k_c = int(st.k)
        self.consecutive = (self.consecutive + 1
                            if self.last_persisted_k == k_c - 1 else 1)
        self.last_persisted_k = k_c
        if self.consecutive >= self.history:
            # a full history-run is now durable -> new recovery point.
            # (The k=0 persist alone is NOT one for history >= 2; the
            # schedule persists iterations 0..history-1 consecutively, so
            # the first recovery point completes at k = history-1.  A
            # failure injected before that trips the snapshot assert in
            # run_recovery with a clear message.)
            self.snapshot = st

    def _recovery_set(self, st, staged=None):
        """``st``'s recovery set as the session takes it: host arrays, or
        on the fused path of a stripe the device tensors, with any vector
        K4 already staged (``staged``: name -> (chunks, parity)) handed
        in as a :class:`~repro_torch.nvm.backend.StagedStripe`."""
        rset = self.solver.recovery_set(st, on_device=self.device_vectors)
        if self.fused:
            # which kernel staged the event: the report's metrics and
            # (persist.begin's label) the trace record the route choice
            self.metrics.counter("persist.route", route=self._route(staged)
                                 ).inc()
        if not staged:
            return rset
        vectors = dict(rset.vectors)
        for name, (chunks, parity) in staged.items():
            vectors[name] = StagedStripe(chunks, parity)
        return rset._replace(vectors=vectors)

    def _route(self, staged) -> str:
        if staged:
            return "K4"
        return "K3" if self.device_vectors else "host"

    def persist_begin(self, st, staged=None) -> None:
        rset = self._recovery_set(st, staged)
        stage_cost = self.session.begin(rset.k, rset.scalars, rset.vectors)
        self.metrics.histogram("persist.stage_s",
                               phase="persist").observe(stage_cost)
        trace = self.trace
        if trace is not None:
            trace.event("persist.begin", k=rset.k, stage_s=stage_cost,
                        route=self._route(staged))
        self.staged_state = st

    def persist_commit(self, window_s: float = 0.0) -> None:
        if self.staged_state is None:
            return
        cost = self.session.commit()
        self._note_committed(self.staged_state, cost, window_s)
        self.staged_state = None

    def persist_abort(self) -> None:
        # The session side is aborted by session.fail() / fail_storage();
        # here we only drop the driver-side bookkeeping so the dead event
        # is never counted or committed (it does count as an abort).  A
        # fused-mode pending (deferred, never staged) event aborts the
        # same way, so persist_aborts agree between the two routes.
        st = (self.staged_state if self.staged_state is not None
              else self.pending_state)
        if st is not None:
            self.metrics.counter("persist.abort").inc()
            trace = self.trace
            if trace is not None:
                trace.event("persist.abort", k=int(st.k))
        self.staged_state = None
        self.pending_state = None

    def flush_pending_stage(self, staged=None) -> None:
        """Fused overlap only: run the deferred staging pass (no-op
        otherwise).  The solve loop calls this inside the timed window
        right after the next iteration's step, handing in the stripe K4
        staged during that step (``staged``), if it ran K4."""
        if self.pending_state is not None:
            st, self.pending_state = self.pending_state, None
            self.persist_begin(st, staged)

    def persist_point(self, st) -> None:
        """One scheduled persistence event.  Sync mode is the paper's
        fully synchronous host pull: write straight through, no staging
        copy, everything exposed.  Overlap mode stages now and commits
        behind the next iteration's compute; fused overlap defers even
        the staging into that window (same commit order: the event is
        still staged and committed before the following persist point)."""
        if self.overlap:
            if self.fused:
                self.pending_state = st
            else:
                self.persist_begin(st)
        else:
            rset = self._recovery_set(st)
            cost = self.session.persist(rset.k, rset.scalars, rset.vectors)
            self._note_committed(st, cost, 0.0)

    # ------------------------------------------------------------------
    def pop_event(self, k: int) -> Optional[FailureEvent]:
        """The next iteration-triggered event pending at ``k`` (one per
        loop pass — a second event at the same k fires on the repeated
        pass after the first one's rollback), or None."""
        pending = self.at_events.get(k)
        if not pending:
            return None
        ev = pending.pop(0)
        if not pending:
            del self.at_events[k]
        return ev

    def storage_kill(self, k: int) -> None:
        self.session.fail_storage()
        self.metrics.counter("storage.kill").inc()
        trace = self.trace
        if trace is not None:
            trace.event("storage.kill", k=k)

    def inject(self, ev: FailureEvent, state, k: int):
        """Apply one iteration-triggered event: a storage-only event
        kills the persistence service and returns the state unchanged
        (the solve continues); a block event runs the full recovery and
        returns the rolled-back, reconstructed state."""
        if self.session is None:
            raise RuntimeError(
                "failure injected but no recovery backend configured")
        trace = self.trace
        if trace is not None:
            trace.event("failure.inject", k=k, blocks=tuple(ev.blocks),
                        prd=ev.prd, overlapping=False)
        if not ev.blocks:
            # Storage-only event: the PRD node dies but no compute
            # state is lost, so the solve continues.  The loss
            # surfaces — loudly — at the next recovery fetch unless
            # the backend's capabilities cover it.
            self.storage_kill(k)
            return state
        return self.run_recovery(ev, state, k)

    def run_recovery(self, ev: FailureEvent, st, k: int):
        """The campaign recovery engine.  Handles ``ev`` plus any events
        triggered *during* this recovery: each overlapping event enlarges
        the failed union and forces a refetch (the already-fetched
        payloads are stale — their hosts may just have died).  A
        ``prd=True`` event additionally crashes the persistence-service
        node before its blocks are processed; the fetch then succeeds
        only if the backend's capabilities cover the loss (mirrors)."""
        solver, session = self.solver, self.session
        metrics, trace, history = self.metrics, self.trace, self.history
        self.persist_abort()  # an in-flight staged persist dies with the nodes
        overlap_queue = list(self.during_events.pop(ev.at_iteration, ()))
        failed: List[int] = []
        new = list(ev.blocks)
        prd_hit = ev.prd
        st_wiped = st
        while True:
            metrics.counter("recovery.absorbed").inc()
            if trace is not None:
                trace.event("recovery.absorbed", blocks=tuple(new),
                            prd=prd_hit)
            if prd_hit:
                session.fail_storage()
                metrics.counter("storage.kill").inc()
                if trace is not None:
                    trace.event("storage.kill", k=k)
                prd_hit = False
            failed = sorted(set(failed) | set(new))
            if new:
                st_wiped = solver.wipe(st_wiped, self.op.partition, new)
                session.fail(tuple(new))  # VM lost
            # Drain barrier: outstanding persistence settles (or is torn
            # away) before the durable recovery point is read.
            drain_cost = session.drain()
            metrics.histogram("persist.drain_s",
                              phase="recovery").observe(drain_cost)
            if trace is not None:
                trace.event("persist.drain", cost_s=drain_cost)
            assert self.snapshot is not None, \
                "no completed persistence run before failure"
            k_rec = int(self.snapshot.k)
            ks = tuple(range(k_rec - history + 1, k_rec + 1))
            if trace is None:
                sets = session.fetch(tuple(failed), ks)
            else:
                with trace.span("recovery.fetch", blocks=tuple(failed),
                                runs=ks):
                    sets = session.fetch(tuple(failed), ks)
            if overlap_queue:
                # A second failure lands while this recovery is in
                # flight: the fetch above is stale, restart with the
                # enlarged union.
                nxt = overlap_queue.pop(0)
                new = list(nxt.blocks)
                prd_hit = nxt.prd
                metrics.counter("recovery.restart").inc()
                if trace is not None:
                    trace.event("failure.inject", k=k,
                                blocks=tuple(nxt.blocks), prd=nxt.prd,
                                overlapping=True)
                    trace.event("recovery.restart", blocks=tuple(nxt.blocks))
                continue
            # Rollback-agreement cross-check (DESIGN.md §8): the backend
            # answers the rollback question from its own slots; it must
            # name the same durable run the driver's snapshot ends at.
            # (Sessions without slot knowledge answer None and are
            # exempt — there is nothing to cross-check against.)
            dr = session.durable_run()
            if dr is not None and dr != k_rec:
                raise RuntimeError(
                    f"rollback-point disagreement after recovery: the "
                    f"driver's durable snapshot ends at iteration {k_rec} "
                    f"but the backend's durable_run() reports {dr}; "
                    f"backend and driver must agree before reconstruction "
                    f"(DESIGN.md §8)")
            if trace is None:
                st_new = solver.reconstruct(
                    self.op, self.precond, self.b,
                    snapshot=self.snapshot,
                    failed_blocks=list(failed),
                    sets=sets,
                    local_method=self.config.local_solve,
                )
            else:
                with trace.span("recovery.reconstruct",
                                blocks=tuple(failed), k_rec=k_rec):
                    st_new = solver.reconstruct(
                        self.op, self.precond, self.b,
                        snapshot=self.snapshot,
                        failed_blocks=list(failed),
                        sets=sets,
                        local_method=self.config.local_solve,
                    )
            metrics.counter("solve.wasted_iterations").inc(k - k_rec)
            if trace is not None:
                trace.event("recovery.rollback", from_k=k, to_k=k_rec,
                            wasted=k - k_rec)
            if self.mesh is not None:
                # the replacement shard rejoins the mesh's placement
                st_new = place_state(st_new, self.mesh,
                                     solver.state_vector_fields)
            return st_new

    # ------------------------------------------------------------------
    def finalize(self, report: SolveReport, state, bnorm: float) -> None:
        """Exit drain + derived-view readback (DESIGN.md §9): a staged
        final event still commits (exposed — there is no further compute
        to hide behind), then every numeric report counter is read back
        OUT of the registry the loop incremented, so registry and report
        agree by construction (check_report_consistency re-verifies;
        check_trace_report closes the triangle to the trace)."""
        self.flush_pending_stage()  # a deferred final event still stages
        self.persist_commit(0.0)
        metrics = self.metrics
        report.iterations = int(state.k)
        report.final_relres = self.solver.residual_norm(state) / bnorm
        report.converged = (report.converged
                            or report.final_relres < self.config.tol)
        report.wasted_iterations = metrics.counter_value(
            "solve.wasted_iterations")
        report.failures_recovered = metrics.counter_value("recovery.absorbed")
        report.recovery_restarts = metrics.counter_value("recovery.restart")
        report.storage_failures = metrics.counter_value("storage.kill")
        report.persist_events = metrics.counter_value("persist.commit")
        report.persist_aborts = metrics.counter_value("persist.abort")
        report.persist_cost_s = metrics.histogram_total("persist.commit_s",
                                                        phase="persist")
        report.persist_stage_s = metrics.histogram_total("persist.stage_s",
                                                         phase="persist")
        report.persist_hidden_s = metrics.histogram_total("persist.hidden_s",
                                                          phase="persist")
        report.persist_exposed_s = metrics.histogram_total("persist.exposed_s",
                                                           phase="persist")
        report.persist_drain_s = metrics.histogram_total("persist.drain_s",
                                                         phase="recovery")
        # Traffic: fold the session's byte meter into the registry as
        # shard-labeled counters, then read the report fields back OUT of
        # the registry like every other counter above.
        report.nshards = 1 if self.layout is None else self.layout.nshards
        traffic = getattr(self.session, "traffic", None)
        if traffic is not None:
            for shard, nbytes in sorted(traffic.persist_bytes.items()):
                metrics.counter("persist.bytes", shard=shard).inc(nbytes)
            for shard, nbytes in sorted(traffic.fetch_bytes.items()):
                metrics.counter("recovery.fetch_bytes", shard=shard).inc(nbytes)
        d2h = getattr(self.session, "device_to_host_bytes", None)
        if d2h:
            # the stripe shards the fused path copied device -> host
            metrics.counter("persist.d2h_bytes").inc(d2h)
        report.persist_bytes = metrics.counter_total("persist.bytes")
        report.recovery_fetch_bytes = metrics.counter_total(
            "recovery.fetch_bytes")
        report.persist_bytes_by_shard = metrics.counter_by_label(
            "persist.bytes", "shard")
        report.recovery_fetch_bytes_by_shard = metrics.counter_by_label(
            "recovery.fetch_bytes", "shard")
        metrics.gauge("solve.iterations").set(report.iterations)
        metrics.gauge("solve.converged").set(1.0 if report.converged else 0.0)
        trace = self.trace
        if trace is not None:
            trace.event("solve.end", iterations=report.iterations,
                        converged=report.converged,
                        final_relres=report.final_relres)


def make_batched_step(solver_cls, make_lane_ops):
    """One driver step over a bucket of tenant lanes — the batched entry
    of the multi-tenant service, where the reference vmaps one lane's
    step (``jax.jit(jax.vmap(...))``).  The hand-written kernels have no
    batching rule, so the lane axis is explicit: the returned function
    maps ``(stacked_states, lanes) -> stacked_states`` over a stacked
    state of the solver's state class — vector fields ``(lanes, n)``,
    per-lane scalars ``(lanes,)``, ``k`` a ``(lanes,)`` host tensor — with
    one launch per kernel for the whole bucket.

    ``make_lane_ops(lanes)`` receives the bucket's stacked lane data and
    returns ``(op_apply, precond, dot, params)``; the solver class's
    :meth:`~repro_torch.solvers.base.RecoverableSolver.lane_step` consumes
    them.  The scalars travel into the step as ``(lanes, 1)`` columns, so
    the solo step body broadcasts over the lanes unchanged.  Every lane is
    independent — lane ``i``'s output depends only on lane ``i``'s
    inputs (the lane kernels reduce within a lane, never across), which
    is what makes cohabitant trajectories bitwise their solo runs
    through the same bucket shape.
    """
    if not getattr(solver_cls, "batchable", False):
        raise NotImplementedError(
            f"solver {solver_cls.name!r} is not batchable "
            f"(no lane_step)")

    def step(states, lanes):
        op_apply, precond, dot, params = make_lane_ops(lanes)
        scalars = [f for f, v in zip(states._fields, states)
                   if f != "k" and v.dim() == 1]
        columns = states._replace(**{f: getattr(states, f).unsqueeze(-1)
                                     for f in scalars})
        out = solver_cls.lane_step(op_apply, precond, dot, params)(columns)
        return out._replace(**{f: getattr(out, f).squeeze(-1)
                               for f in scalars})

    return step


def solve(
    solver,
    op,
    b,
    precond,
    config: SolveConfig = SolveConfig(),
    backend=None,
    failures: Union[FailureCampaign, Sequence[FailurePlan]] = (),
    x0=None,
    capture_states_at: Sequence[int] = (),
):
    """Run ``solver`` with optional ESR/NVM-ESR fault tolerance.

    ``backend`` is any recovery backend
    :func:`repro_torch.nvm.backend.open_persist_session` accepts — a
    :class:`~repro_torch.nvm.backend.PersistenceBackend` or a
    schema-duck-typed object — or None for an unprotected run.
    ``failures`` injects block crashes — either a sequence of
    :class:`FailurePlan` (the single-event form) or a
    :class:`FailureCampaign` with overlapping / mid-burst / repeated /
    PRD-loss events.  Returns the final state, a report, and any states
    captured for verification.

    The persistence/recovery machinery lives in
    :class:`PersistencePipeline`; this function owns the state, the
    step, and the loop.  Everything runs on ``b``'s device.
    """
    trace = config.tracer or None
    if trace is not config.tracer:
        # Normalize the falsy tracer away HERE so the pipeline's own
        # `config.tracer or None` sees None — one truthiness call total
        # on a disabled tracer (the obs zero-callable guard test).
        config = dataclasses.replace(config, tracer=trace)
    pipe = PersistencePipeline(solver, op, precond, b, config, backend,
                               failures)
    session = pipe.session

    state = solver.init_state(op, precond, b, x0)
    if pipe.mesh is not None:
        state = place_state(state, pipe.mesh, solver.state_vector_fields)
    step = solver.make_step(op, precond)
    persist_step = (None if pipe.stage_geometry is None else
                    solver.make_persist_step(op, precond,
                                             *pipe.stage_geometry))

    def advance(st):
        """One iteration; K4 in place of K2 when the pending persist
        event is this step's input (its stripe rides the update pass)."""
        if persist_step is not None and pipe.pending_state is st:
            return persist_step(st)
        return step(st), None

    bnorm = device_norm(b)
    report = SolveReport(solver=solver.name, persist_mode=config.persist_mode,
                         metrics=pipe.metrics)
    captured: Dict[int, object] = {}
    if trace is not None:
        trace.event("solve.begin", solver=solver.name,
                    mode=config.persist_mode, maxiter=config.maxiter)

    # Iteration 0 counts as persisted so the first run completes early.
    if session is not None:
        pipe.persist_point(state)

    while int(state.k) < config.maxiter:
        k = int(state.k)
        if k in capture_states_at:
            captured[k] = state

        relres = solver.residual_norm(state) / bnorm
        report.residual_history.append(relres)
        if relres < config.tol:
            report.converged = True
            break

        # ---- failure injection + recovery ----
        ev = pipe.pop_event(k)
        if ev is not None:
            state = pipe.inject(ev, state, k)
            if int(state.k) in capture_states_at:
                captured[int(state.k)] = state
            continue

        t0 = time.perf_counter()
        if trace is None:          # identity guard: the disabled hot path
            state, staged = advance(state)  # runs zero tracer callables
        else:
            with trace.span("iteration.step", k=k):
                state, staged = advance(state)
        if pipe.pending_state is not None:
            # Fused overlap (DESIGN.md §13): the deferred staging pass
            # (the stripe's device-to-host copy, and K3's encode unless
            # K4 staged it in the step) runs inside this window too.
            _synchronize(b.device)
            pipe.flush_pending_stage(staged)
        if pipe.staged_state is not None:
            # Overlap window: the commit of iteration k's payload rides
            # behind iteration k+1's compute.
            _synchronize(b.device)
            pipe.persist_commit(time.perf_counter() - t0)
        if session is not None and should_persist(
                int(state.k), config.persistence_period, pipe.history):
            pipe.persist_point(state)

    pipe.finalize(report, state, bnorm)
    return state, report, captured
