"""One failure campaign through both packages' ``api.solve``.

The campaign holds a block kill, an overlapping kill that lands during
that recovery (``during_recovery_at``) and a repeated kill of the same
block later.  It runs with ``nvm-prd`` and ``nvm-homogeneous`` in sync
and overlap modes.  The modelled report counters must be equal (wall
time fields are excluded) and ``x`` must agree at the reference's rtol
1e-8.
"""
import numpy as np
import pytest

from repro import api as ref_api
from repro_torch import api
from repro_torch.convert import problem_from_numpy

GRID, NBLOCKS = (8, 8, 8), 4
COUNTERS = ("iterations", "failures_recovered", "recovery_restarts",
            "wasted_iterations", "persist_events", "persist_aborts",
            "persist_bytes", "recovery_fetch_bytes", "converged",
            "storage_failures")


def _campaign(pkg):
    return pkg.FailureCampaign((
        pkg.FailureEvent(blocks=(1,), at_iteration=5),
        pkg.FailureEvent(blocks=(2,), during_recovery_at=5),
        pkg.FailureEvent(blocks=(1,), at_iteration=11),
    ))


@pytest.fixture(scope="module")
def problems():
    ref_problem = ref_api.Problem.poisson(*GRID, nblocks=NBLOCKS)
    port_problem = problem_from_numpy(GRID, NBLOCKS, np.asarray(ref_problem.b),
                                      device="cpu")
    return ref_problem, port_problem


@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("backend", ["nvm-prd", "nvm-homogeneous"])
def test_campaign_counters_and_solution_match(problems, backend, mode):
    ref_problem, port_problem = problems
    ref = ref_api.solve(ref_problem, ref_api.SolverSpec("pcg", tol=1e-10),
                        ref_api.ResilienceSpec(backend, persist_mode=mode),
                        failures=_campaign(ref_api))
    got = api.solve(port_problem, api.SolverSpec("pcg", tol=1e-10),
                    api.ResilienceSpec(backend, persist_mode=mode),
                    failures=_campaign(api))
    for name in COUNTERS:
        assert getattr(got.report, name) == getattr(ref.report, name), name
    assert got.report.failures_recovered == 3
    assert got.report.recovery_restarts == 1
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_campaign_trace_matches_reference(problems, mode):
    """Traced, the campaign records the same span/event names the same
    number of times in both packages, and the port's trace, registry
    and report agree (the reference's observability cross-check)."""
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer, check_trace_report

    ref_problem, port_problem = problems
    ref_tracer, tracer = RefTracer(), Tracer()
    ref_api.solve(ref_problem, "pcg",
                  ref_api.ResilienceSpec("nvm-prd", persist_mode=mode),
                  failures=_campaign(ref_api), tracer=ref_tracer)
    got = api.solve(port_problem, "pcg",
                    api.ResilienceSpec("nvm-prd", persist_mode=mode),
                    failures=_campaign(api), tracer=tracer)
    assert tracer.counts() == ref_tracer.counts()
    check_trace_report(tracer, got.report)


def test_recovered_run_matches_failure_free_port_run(problems):
    """Inside the port, recovery converges onto the port's own
    failure-free trajectory (iteration count equal, x within 1e-8)."""
    _, port_problem = problems
    free = api.solve(port_problem, "pcg", "nvm-prd")
    hit = api.solve(port_problem, "pcg", "nvm-prd",
                    failures=_campaign(api))
    assert hit.iterations == free.iterations
    np.testing.assert_allclose(hit.x, free.x, rtol=1e-8, atol=1e-10)


def test_unsurvivable_and_unported_requests_raise(problems):
    _, port_problem = problems
    with pytest.raises(api.UnsurvivableCampaignError):
        api.solve(port_problem, "pcg", "nvm-prd",
                  failures=[api.FailureEvent(blocks=(1,), at_iteration=3,
                                             prd=True)])
    # the erasure slice is ported: fused_persist no longer raises
    fused = api.solve(port_problem, "pcg",
                      api.ResilienceSpec("nvm-prd", fused_persist=True))
    assert fused.converged
    # the replicated composite is ported: it runs
    mirrored = api.solve(port_problem, "pcg", "replicated(nvm-prd x2)")
    assert mirrored.converged
    # still unported: solves sharded across cards, so a solo solve has
    # no layout for a shard= event (service tenants declare one)
    with pytest.raises(ValueError, match="sharded solve"):
        api.solve(port_problem, "pcg", "nvm-prd",
                  failures=[api.FailureEvent(shard=0, at_iteration=3)])
    # the multi-tenant service is ported
    assert callable(api.serve) and callable(api.SolveService)
