"""The port's multi-tenant ``SolveService`` against the reference's
``repro.api.serve``, and its own contracts, on the CPU.

- **Against the reference**: the same seeded request traces (the two
  generators draw the same sequence) replayed through both services give,
  tenant by tenant, the same admissions, iteration counts, convergence,
  service counters (queue wait, lane steps, occupancy), persist events
  and per-shard persist / fetch bytes; ``x`` and the residual history
  agree at rtol 1e-8.  The histories get an atol of 1e-13 beside it:
  a tenant that converges (PCG on a 4^3 grid reaches the exact solution)
  ends below 1e-15, where both packages read rounding noise.  The
  right-hand sides differ by an ulp (each package evaluates its own
  sines), and the two sum their dots in different orders, hence
  tolerances and not bits.
- **Tenant isolation** (the reference's ISOLATION_CASES sweep): a victim
  killed mid-batch (block, PRD and shard kills over three solver and
  three spec families) recovers onto its solo ``api.solve`` answer
  (rtol 1e-8, equal iterations), and every cohabitant's final ``x``,
  captured state and residual history are bitwise its solo run through
  the same bucket shape, inside the port.
- **Admission control, validation and tracing** as the reference's
  tests/test_solve_service.py checks them, and the span/event taxonomy
  equal to the reference service's on the same trace.
"""
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.obs import Tracer as RefTracer
from repro_torch import api
from repro_torch.obs import Tracer, check_report_consistency
from repro_torch.serving.solve_service import ServiceError
from repro_torch.solvers import FailureEvent, UnsurvivableCampaignError

CPU = "cpu"
CAPTURE_K = 5  # mid-trajectory capture: past iteration 0, before any
#                family converges on the sweep grids
REPORT_FIELDS = ("iterations", "converged", "service_queue_wait_steps",
                 "service_lane_steps", "service_batch_occupancy",
                 "persist_events", "persist_bytes_by_shard",
                 "recovery_fetch_bytes_by_shard", "failures_recovered",
                 "storage_failures", "nshards", "wasted_iterations")
#: (seed, failure_rate): between them block, PRD and shard kills, every
#: batchable solver family, every spec family and the advisor's choice
TRACES = ((0, 0.5), (1, 1.0), (6, 1.0), (4, 0.5))


def _service(lanes=4, max_queue=8, tracer=None):
    return api.SolveService(api.ServiceConfig(lanes=lanes,
                                              max_queue=max_queue,
                                              tracer=tracer, device=CPU))


def _poisson(*grid, nblocks, **kw):
    return api.Problem.poisson(*grid, nblocks=nblocks, device=CPU, **kw)


def _bitwise_state_equal(got, want):
    return all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(got, want))


@pytest.mark.parametrize("seed,failure_rate", TRACES,
                         ids=[f"seed{s}-rate{r}" for s, r in TRACES])
def test_replay_matches_reference_serve(seed, failure_rate):
    kw = dict(nrequests=6, failure_rate=failure_rate, survivable_only=True)
    ref_reqs = ref_api.generate_request_trace(seed, **kw)
    reqs = api.generate_request_trace(seed, **kw)
    assert [r.tenant for r in reqs] == [r.tenant for r in ref_reqs]
    want = ref_api.serve(ref_reqs)
    got = api.serve(reqs, device=CPU)
    assert sorted(got) == sorted(want)
    for name, ticket in got.items():
        ref = want[name]
        assert ticket.accepted == ref.accepted, name
        if not ref.accepted:
            continue
        rep, ref_rep = ticket.result.report, ref.result.report
        for field in REPORT_FIELDS:
            assert getattr(rep, field) == getattr(ref_rep, field), \
                f"{name}: {field}"
        np.testing.assert_allclose(ticket.result.x, np.asarray(ref.result.x),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(rep.residual_history,
                                   ref_rep.residual_history, rtol=1e-8,
                                   atol=1e-13, err_msg=name)
        check_report_consistency(rep)


def test_service_taxonomy_matches_reference():
    """The same trace through both services with a tracer: every span
    and event name, with its count, is the reference's."""
    kw = dict(nrequests=3, failure_rate=1.0, survivable_only=True)
    ref_tr, tr = RefTracer(), Tracer()
    ref_api.SolveService(ref_api.ServiceConfig(lanes=2, tracer=ref_tr)
                         ).replay(ref_api.generate_request_trace(2, **kw))
    tickets = api.SolveService(api.ServiceConfig(
        lanes=2, tracer=tr, device=CPU)).replay(
            api.generate_request_trace(2, **kw))
    assert tr.counts() == ref_tr.counts()
    counts = tr.counts()
    n_acc = sum(1 for t in tickets.values() if t.accepted)
    assert counts["service.submit"] == 3
    assert counts["service.admit"] == counts["service.complete"] == n_acc
    assert counts["solve.begin"] == counts["solve.end"] == n_acc
    total_recovered = sum(t.result.report.failures_recovered
                          for t in tickets.values() if t.accepted)
    assert counts.get("recovery.absorbed", 0) == total_recovered


# ---------------------------------------------------------------------------
# Tenant isolation, inside the port
# ---------------------------------------------------------------------------
ISOLATION_CASES = (
    # (solver, tol, spec, victim kill, victim nshards)
    ("pcg", 1e-9, "replicated(nvm-prd x2)",
     FailureEvent(blocks=(1,), at_iteration=4, prd=True), 1),
    ("bicgstab", 1e-9, "nvm-prd",
     FailureEvent(blocks=(0, 1), at_iteration=3), 1),
    ("chebyshev", 1e-8, "erasure(nvm-prd x4+p)",
     FailureEvent(shard=1, at_iteration=6), 3),
)


@pytest.mark.parametrize("solver,tol,spec,kill,nshards", ISOLATION_CASES,
                         ids=[c[0] for c in ISOLATION_CASES])
def test_tenant_isolation_kill_mid_batch(solver, tol, spec, kill, nshards):
    victim_p = _poisson(6, nblocks=6)
    cohab_ps = {
        "c1": _poisson(5, 8, 8, nblocks=5),   # bucket (8,8,8)
        "c2": _poisson(8, nblocks=8),          # exact-fit lane
    }
    sspec = api.SolverSpec(solver, tol=tol, maxiter=2000)

    svc = _service()
    tv = svc.submit(victim_p, sspec, spec, failures=(kill,), tenant="victim",
                    nshards=nshards, capture_states_at=(CAPTURE_K,))
    tc = {name: svc.submit(p, sspec, "nvm-prd", tenant=name,
                           capture_states_at=(CAPTURE_K,))
          for name, p in cohab_ps.items()}
    svc.drain()

    # the victim recovered mid-batch onto its solo trajectory (recovery
    # reconstructs in tenant space: exact to solver tolerance, not bits)
    vrep = tv.result.report
    assert vrep.converged and vrep.failures_recovered >= 1
    assert vrep.nshards == nshards
    solo = api.solve(victim_p, sspec)
    assert solo.iterations == vrep.iterations
    np.testing.assert_allclose(tv.result.x, solo.x, rtol=1e-8, atol=1e-10)
    check_report_consistency(vrep)

    # cohabitants: bitwise their solo no-failure runs through the same
    # bucket shape and lane width, whichever lane seated them
    for name, p in cohab_ps.items():
        ref_svc = _service()
        ref = ref_svc.submit(p, sspec, "nvm-prd", tenant=name,
                             capture_states_at=(CAPTURE_K,))
        ref_svc.drain()
        got, want = tc[name].result, ref.result
        assert torch.equal(got.state.x, want.state.x), f"{name}: x drifted"
        assert _bitwise_state_equal(got.captured[CAPTURE_K],
                                    want.captured[CAPTURE_K]), name
        assert (got.report.residual_history
                == want.report.residual_history), name
        assert got.report.failures_recovered == 0
        check_report_consistency(got.report)


def test_storage_only_kill_is_isolated_and_survivable():
    p1, p2 = _poisson(4, nblocks=4), _poisson(3, 4, 4, nblocks=3)
    svc = _service()
    t1 = svc.submit(p1, api.SolverSpec("pcg", tol=1e-9), "nvm-prd",
                    failures=(FailureEvent(blocks=(), at_iteration=2,
                                           prd=True),), tenant="t1")
    t2 = svc.submit(p2, api.SolverSpec("pcg", tol=1e-9), "nvm-prd",
                    tenant="t2")
    svc.drain()
    assert t1.result.report.converged
    assert t1.result.report.storage_failures == 1
    assert t1.result.report.failures_recovered == 0
    assert t2.result.report.converged
    assert t2.result.report.storage_failures == 0


@pytest.mark.parametrize("solver,tol", [("pcg", 1e-9), ("bicgstab", 1e-9),
                                        ("chebyshev", 1e-8),
                                        ("jacobi", 1e-6)])
def test_bucketed_solve_matches_solo_api_solve(solver, tol):
    problems = [_poisson(3, 4, 4, nblocks=3), _poisson(4, nblocks=4),
                _poisson(6, nblocks=6)]
    sspec = api.SolverSpec(solver, tol=tol, maxiter=3000)
    svc = _service()
    tickets = [svc.submit(p, sspec, "nvm-prd", tenant=f"t{i}")
               for i, p in enumerate(problems)]
    svc.drain()
    for p, tk in zip(problems, tickets):
        solo = api.solve(p, sspec)
        assert tk.result.report.converged and solo.converged
        assert tk.result.report.final_relres < tol
        np.testing.assert_allclose(tk.result.x, solo.x, rtol=1e-8,
                                   atol=1e-10)


def test_replay_is_deterministic():
    reqs = api.generate_request_trace(1, nrequests=4, failure_rate=0.5,
                                      survivable_only=True)
    a, b = _service(), _service()
    ta, tb = a.replay(reqs), b.replay(reqs)
    assert a.now == b.now and sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name].accepted == tb[name].accepted
        if ta[name].accepted:
            assert torch.equal(ta[name].result.state.x,
                               tb[name].result.state.x)
            assert (ta[name].result.report.residual_history
                    == tb[name].result.report.residual_history)


# ---------------------------------------------------------------------------
# Admission control: bounded queue, waits, occupancy
# ---------------------------------------------------------------------------
def test_bounded_queue_rejects_and_counts():
    p = _poisson(4, nblocks=4)
    sspec = api.SolverSpec("pcg", tol=1e-9)
    tr = Tracer()
    svc = _service(lanes=1, max_queue=2, tracer=tr)
    tickets = [svc.submit(p, sspec, "nvm-prd", tenant=f"t{i}")
               for i in range(4)]
    accepted = [t for t in tickets if t.accepted]
    rejected = [t for t in tickets if not t.accepted]
    assert len(accepted) == 2 and len(rejected) == 2
    assert all(t.reason == "queue full" for t in rejected)
    assert svc.metrics.counter_value("service.submitted") == 4
    assert svc.metrics.counter_value("service.rejected") == 2
    svc.drain()
    assert svc.metrics.counter_value("service.admitted") == 2
    assert svc.metrics.counter_value("service.completed") == 2
    assert tr.counts().get("service.reject", 0) == 2
    assert all(t.result is None for t in rejected)
    assert all(t.result.report.converged for t in accepted)


def test_queue_wait_and_occupancy_stats():
    p = _poisson(4, nblocks=4)
    sspec = api.SolverSpec("pcg", tol=1e-9)
    svc = _service(lanes=1, max_queue=4)
    t1 = svc.submit(p, sspec, "nvm-prd", tenant="first")
    t2 = svc.submit(p, sspec, "nvm-prd", tenant="second")
    svc.drain()
    r1, r2 = t1.result.report, t2.result.report
    assert r1.service_queue_wait_steps == 0
    # the lane frees mid-step, after that step's admission pass ran, so
    # the successor boards the step after
    assert r2.service_queue_wait_steps == r1.service_lane_steps + 1
    for rep in (r1, r2):
        assert rep.service_lane_steps > 0
        assert rep.service_batch_occupancy == 1.0
        assert (rep.metrics.counter_value("service.wait_steps")
                == rep.service_queue_wait_steps)
        assert (rep.metrics.counter_value("service.lane_steps")
                == rep.service_lane_steps)
    hist = svc.metrics.histogram("service.queue_wait_steps")
    assert hist.count == 2
    assert hist.percentile(99) == r2.service_queue_wait_steps


def test_occupancy_reflects_shared_bucket():
    sspec = api.SolverSpec("chebyshev", tol=1e-8, maxiter=2000)
    svc = _service(lanes=4)
    t1 = svc.submit(_poisson(6, nblocks=6), sspec, "nvm-prd", tenant="a")
    t2 = svc.submit(_poisson(6, nblocks=6), sspec, "nvm-prd", tenant="b")
    svc.drain()
    assert t1.result.report.service_batch_occupancy == pytest.approx(0.5)
    assert t2.result.report.service_batch_occupancy == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# Admission validation and advisor integration
# ---------------------------------------------------------------------------
def test_rejects_non_batchable_solver():
    with pytest.raises(ServiceError, match="no batched lane step"):
        _service().submit(_poisson(4, nblocks=4), api.SolverSpec("gmres"))


def test_rejects_non_diagonal_preconditioner():
    p = _poisson(4, nblocks=4, preconditioner="block_jacobi")
    with pytest.raises(ServiceError, match="diagonal"):
        _service().submit(p, api.SolverSpec("pcg"))


def test_rejects_non_stencil_operator():
    from repro_torch.core.poisson import DenseOperator

    n, nblocks = 16, 4
    a = np.random.default_rng(0).standard_normal((n, n))
    op = DenseOperator(a @ a.T + n * np.eye(n), nblocks=nblocks, device=CPU)
    p = api.Problem.from_parts(op, torch.ones(n, dtype=torch.float64))
    with pytest.raises(ServiceError, match="stencil"):
        _service().submit(p, api.SolverSpec("pcg"))


def test_rejects_a_tenant_on_another_device():
    svc = _service()
    svc.submit(_poisson(4, nblocks=4), api.SolverSpec("pcg"), "nvm-prd")
    other = _poisson(4, nblocks=4)
    moved = api.Problem.from_parts(other.op, other.b.to("meta"),
                                   other.precond)
    with pytest.raises(ServiceError, match="live on cpu"):
        svc.submit(moved, api.SolverSpec("pcg"), "nvm-prd")
    assert svc.queued == 1


def test_unsurvivable_campaign_raises_at_submission():
    svc = _service()
    with pytest.raises(UnsurvivableCampaignError, match="prd"):
        svc.submit(_poisson(4, nblocks=4), api.SolverSpec("pcg"), "nvm-prd",
                   failures=(FailureEvent(blocks=(1,), at_iteration=3,
                                          prd=True),))
    assert svc.active == 0 and svc.queued == 0


def test_advisor_picks_spec_when_unset():
    svc = _service()
    tk = svc.submit(_poisson(4, nblocks=4), api.SolverSpec("pcg", tol=1e-9),
                    None,
                    failures=(FailureEvent(blocks=(1,), at_iteration=3,
                                           prd=True),),
                    tenant="advised")
    svc.drain()
    rep = tk.result.report
    assert rep.converged
    assert rep.failures_recovered >= 1 and rep.storage_failures >= 1
    assert tk.result.backend.capabilities.survives_prd_loss


def test_shard_events_resolve_against_declared_layout():
    svc = _service()
    tk = svc.submit(_poisson(4, nblocks=4), api.SolverSpec("pcg", tol=1e-9),
                    "replicated(nvm-prd x2)",
                    failures=(FailureEvent(shard=1, at_iteration=3),),
                    tenant="sharded", nshards=2)
    svc.drain()
    rep = tk.result.report
    assert rep.converged and rep.failures_recovered == 1
    assert rep.nshards == 2
    assert set(rep.persist_bytes_by_shard) == {0, 1}
    # the shard kill lost shard 1's blocks (2, 3): only they were fetched
    assert set(rep.recovery_fetch_bytes_by_shard) == {1}


def test_requests_build_on_the_service_device():
    req = api.generate_request_trace(0, nrequests=1)[0]
    assert req.problem(device=CPU).b.device.type == "cpu"
    svc = _service()
    ticket = svc.submit_request(req)
    assert ticket.accepted
    svc.drain()
    assert ticket.result.state.x.device.type == "cpu"
