"""The port's ``esr`` backend, the replicated and tiered composites and
the spec advisor against the reference package.

Payloads are made with numpy from a seed and handed to both packages'
sessions; slot bytes must be equal child for child, capabilities and
spec parses equal, and the campaigns of ``tests/test_backend_api.py``
(mirror loss, tiered flush, a staged event dying with a failure) must
end the same way in both.  Solves compare counters exactly and ``x``
at rtol 1e-9 (the packages sum in different orders); the advisor's
ranking, storage values and modeled costs are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import port_problem, ref_problem, rng_normal
from repro import api as ref_api
from repro.core.state import PCG_SCHEMA as REF_PCG_SCHEMA
from repro.nvm import backend as ref_backend
from repro_torch import api
from repro_torch.core.state import PCG_SCHEMA
from repro_torch.nvm import backend

GRID, NBLOCKS = (8, 8, 8), 4
BS = 512 // NBLOCKS
SPECS = ("esr", "replicated(nvm-prd x2)",
         "replicated(nvm-prd,nvm-homogeneous)", "tiered(nvm-homogeneous)")
COUNTERS = ("iterations", "converged", "failures_recovered",
            "recovery_restarts", "wasted_iterations", "persist_events",
            "persist_aborts", "persist_bytes", "recovery_fetch_bytes",
            "storage_failures", "persist_cost_s")
# (fail_at, solver opts): gmres counts restart cycles, not iterations
SOLVER_CASES = {
    "pcg": (10, {}),
    "jacobi": (10, {}),
    "chebyshev": (10, {}),
    "bicgstab": (10, {}),
    "gmres": (3, {"m": 4}),
}


def _media(be):
    """Every storage medium's bytes under a backend, child for child."""
    if hasattr(be, "children"):                      # replicated
        return tuple(_media(c) for c in be.children)
    if hasattr(be, "child"):                         # tiered
        return _media(be.child)
    if hasattr(be, "ram"):                           # esr: peer RAM
        return tuple(tuple(sorted(host.items())) for host in be.ram)
    if hasattr(be, "prd"):                           # nvm-prd
        return bytes(be.prd.store._durable)
    return tuple(bytes(pool.store._durable) for pool in be.pools)


def _problems(seed=0, grid=GRID, nblocks=NBLOCKS):
    b = 0.5 + rng_normal(seed, int(np.prod(grid)))
    op, _, pre = ref_problem(grid, nblocks)
    return (ref_api.Problem.from_parts(op, jnp.asarray(b), pre),
            port_problem(grid, nblocks, b))


def _both(run):
    """``run(pkg, problem)`` through the reference and the port."""
    return [run(pkg, problem)
            for pkg, problem in zip((ref_api, api), _problems(seed=1))]


def _assert_solves_equal(ref, port):
    for name in COUNTERS:
        assert getattr(port.report, name) == getattr(ref.report, name), name
    np.testing.assert_allclose(port.x, ref.x, rtol=1e-9, atol=1e-12)


# ----------------------------------------------------------------------
# grammar, capabilities, slot bytes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS + ("replicated(nvm-prd×3)",
                                          "replicated(nvm-prd, nvm-homogeneous)",
                                          "tiered(nvm-prd)"))
def test_spec_grammar_and_capabilities_match_reference(spec):
    assert backend.parse_backend_spec(spec) == \
        ref_backend.parse_backend_spec(spec)
    port_be = backend.create_backend(spec, NBLOCKS, BS)
    ref_be = ref_backend.create_backend(spec, NBLOCKS, BS)
    assert dataclasses.asdict(port_be.capabilities) == \
        dataclasses.asdict(ref_be.capabilities)
    assert port_be.nvm_values() == ref_be.nvm_values()


def test_registry_names_and_errors_match_reference():
    assert backend.backend_names() == ref_backend.backend_names()
    for bad, exc in (("replicated(nvm-prd", ValueError),
                     ("esr(nvm-prd)", ValueError),
                     ("replicate(nvm-prd x2)", KeyError),
                     ("replicated(nvm-prd)", ValueError)):
        with pytest.raises(exc) as port_err:
            backend.create_backend(bad, NBLOCKS, BS)
        with pytest.raises(exc) as ref_err:
            ref_backend.create_backend(bad, NBLOCKS, BS)
        assert str(port_err.value) == str(ref_err.value)
    a = backend.create_backend("nvm-prd", NBLOCKS, BS)
    from repro_torch.solvers.bicgstab import BICGSTAB_SCHEMA

    b = backend.create_backend("nvm-prd", NBLOCKS, BS, schema=BICGSTAB_SCHEMA)
    with pytest.raises(ValueError, match="same schema"):
        backend.ReplicatedBackend([a, b])
    with pytest.raises(ValueError, match="DRAM front"):
        from repro_torch.nvm.store import Tier

        backend.TieredBackend(a, front_tier=Tier.NVM)


@pytest.mark.parametrize("pipeline", ["persist", "begin"])
@pytest.mark.parametrize("spec", SPECS)
def test_slot_bytes_match_reference(spec, pipeline):
    """Five events through both packages' sessions leave the same bytes
    on every medium, and each package fetches the same recovery sets."""
    port_be = backend.create_backend(spec, NBLOCKS, BS)
    ref_be = ref_backend.create_backend(spec, NBLOCKS, BS)
    port_s = port_be.open_session(PCG_SCHEMA)
    ref_s = ref_be.open_session(REF_PCG_SCHEMA)
    for k in range(5):
        p = rng_normal(30 + k, NBLOCKS * BS)
        for s in (port_s, ref_s):
            getattr(s, pipeline)(k, {"beta": 0.1 * k}, {"p": p})
            if pipeline == "begin":
                s.commit()
    for s in (port_s, ref_s):
        s.drain()
    assert _media(port_be) == _media(ref_be)
    assert port_s.durable_run() == ref_s.durable_run() == 4
    got, want = port_s.fetch((1, 3), (3, 4)), ref_s.fetch((1, 3), (3, 4))
    for g, w in zip(got, want):
        assert (g.k, g.scalars) == (w.k, w.scalars)
        assert g.vectors["p"].tobytes() == w.vectors["p"].tobytes()
    assert port_be.memory_overhead_values() == ref_be.memory_overhead_values()


# ----------------------------------------------------------------------
# the campaigns of tests/test_backend_api.py, through both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("name", ["esr", "nvm-homogeneous", "nvm-prd"])
def test_prd_loss_without_mirror_raises_in_both(name, planned):
    def run(pkg, problem):
        with pytest.raises(pkg.UnrecoverableFailure, match="PRD") as err:
            pkg.solve(problem, "pcg",
                      pkg.ResilienceSpec(name, plan_campaigns=planned),
                      failures=pkg.FailureCampaign((pkg.FailureEvent(
                          blocks=(1, 2), at_iteration=8, prd=True),)))
        return type(err.value).__name__

    ref, port = _both(run)
    assert port == ref


def test_all_mirrors_lost_raises_in_both():
    def run(pkg, problem):
        with pytest.raises(pkg.UnrecoverableFailure, match="no mirror"):
            pkg.solve(problem, "pcg",
                      pkg.ResilienceSpec("replicated(nvm-prd x2)",
                                         plan_campaigns=False),
                      failures=pkg.FailureCampaign((
                          pkg.FailureEvent(at_iteration=4, prd=True),
                          pkg.FailureEvent(blocks=(1,), at_iteration=8,
                                           prd=True))))

    _both(run)


@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("child", ["nvm-prd", "nvm-homogeneous"])
@pytest.mark.parametrize("solver", sorted(SOLVER_CASES))
def test_mirror_kill_with_block_failure_matches_reference(solver, child, mode):
    """A campaign event that crashes one mirror's storage node together
    with blocks (1, 2): both packages recover from the surviving mirror
    with equal counters (capped a few iterations past the failure)."""
    fail_at, opts = SOLVER_CASES[solver]

    def run(pkg, problem):
        return pkg.solve(
            problem, pkg.SolverSpec(solver, tol=1e-10, maxiter=fail_at + 4,
                                    options=opts),
            pkg.ResilienceSpec(f"replicated({child} x2)", persist_mode=mode),
            failures=pkg.FailureCampaign((pkg.FailureEvent(
                blocks=(1, 2), at_iteration=fail_at, prd=True),)))

    ref, port = _both(run)
    _assert_solves_equal(ref, port)
    assert port.report.storage_failures == 1
    assert port.report.wasted_iterations == (1 if mode == "overlap" else 0)


@pytest.mark.parametrize("spec", ["replicated(nvm-prd x2)", "tiered(nvm-prd)",
                                  "esr"])
def test_mirror_dies_during_inflight_recovery_matches_reference(spec):
    """An overlapping campaign (a storage loss while a recovery is in
    flight; for the tiered and peer-RAM backends a second block
    instead): both packages restart the fetch and end the same."""
    second = ({"prd": True} if spec.startswith("replicated")
              else {"blocks": (3,)})

    def run(pkg, problem):
        return pkg.solve(
            problem, pkg.SolverSpec("pcg", tol=1e-10),
            pkg.ResilienceSpec(spec, persist_mode="overlap",
                               options={"copies": 3} if spec == "esr" else {}),
            failures=pkg.FailureCampaign((
                pkg.FailureEvent(blocks=(1, 2), at_iteration=8),
                pkg.FailureEvent(during_recovery_at=8, **second))))

    ref, port = _both(run)
    _assert_solves_equal(ref, port)
    assert port.converged and port.report.recovery_restarts == 1


def test_mirroring_costs_sum_over_children():
    costs = {}
    for name in ("nvm-prd", "replicated(nvm-prd x2)"):
        ref, port = _both(lambda pkg, problem: pkg.solve(
            problem, "pcg", name))
        _assert_solves_equal(ref, port)
        costs[name] = (port.report.persist_cost_s, port.backend.nvm_values())
    np.testing.assert_allclose(costs["replicated(nvm-prd x2)"][0],
                               2 * costs["nvm-prd"][0], rtol=1e-9)
    assert costs["replicated(nvm-prd x2)"][1] == 2 * costs["nvm-prd"][1]


def _tiered_script(pkg_backend, schema, staged_dies: bool):
    """The tiered-flush / staged-event-dies walk of
    tests/test_backend_api.py; returns what it observed."""
    be = pkg_backend.create_backend("tiered(nvm-homogeneous)", NBLOCKS, BS)
    session = be.open_session(schema)
    n = NBLOCKS * BS
    seen = []
    if staged_dies:
        for k in range(2):
            session.persist(k, {"beta": 0.1 * k}, {"p": np.full(n, float(k))})
        session.begin(2, {"beta": 0.2}, {"p": np.full(n, 2.0)})
        session.fail((0,))                       # the RAM front is volatile
        seen.append([s.k for s in session.fetch((0,), (0, 1))])
        try:
            session.fetch((0,), (1, 2))
        except RuntimeError as e:
            seen.append(("raised", type(e).__name__, "2" in str(e)))
        return seen
    seen.append(session.begin(0, {"beta": 0.0}, {"p": np.zeros(n)}) > 0.0)
    seen.append(be.child.durable_run())          # still only in the front
    session.commit()
    session.begin(1, {"beta": 0.5}, {"p": np.ones(n)})
    session.drain()
    seen.append(be.child.durable_run())          # flushed through the child
    sets = session.fetch((2,), (0, 1))
    seen.append([(s.k, s.vectors["p"].tobytes()) for s in sets])
    seen.append(session.durable_run())
    return seen


@pytest.mark.parametrize("staged_dies", [False, True])
def test_tiered_walk_matches_reference(staged_dies):
    port = _tiered_script(backend, PCG_SCHEMA, staged_dies)
    ref = _tiered_script(ref_backend, REF_PCG_SCHEMA, staged_dies)
    assert port == ref
    if staged_dies:
        assert port[1] == ("raised", "UnrecoverableFailure", True)
    else:
        assert port[1] is None and port[2] == 1


# ----------------------------------------------------------------------
# the advisor
# ----------------------------------------------------------------------
def _campaigns(pkg):
    return {
        "single block": [pkg.FailureEvent(blocks=(1,), at_iteration=6)],
        "double PRD loss": pkg.FailureCampaign((
            pkg.FailureEvent(blocks=(1,), at_iteration=6, prd=True),
            pkg.FailureEvent(blocks=(2,), at_iteration=10, prd=True))),
        "triple PRD loss": pkg.FailureCampaign(tuple(
            pkg.FailureEvent(blocks=(1,), at_iteration=k, prd=True)
            for k in (4, 6, 8))),
    }


@pytest.mark.parametrize("campaign", ["single block", "double PRD loss",
                                      "triple PRD loss"])
@pytest.mark.parametrize("solver", ["pcg", "bicgstab"])
def test_advise_matches_reference(campaign, solver):
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer

    tracers = (RefTracer(), Tracer())
    ref, port = [pkg.advise(problem, _campaigns(pkg)[campaign],
                            solver=solver, tracer=tracer)
                 for pkg, problem, tracer in zip((ref_api, api),
                                                 _problems(seed=2), tracers)]
    assert api.default_candidate_specs() == ref_api.default_candidate_specs()
    assert port.chosen == ref.chosen
    assert [dataclasses.astuple(r) for r in port.ranked] == \
        [dataclasses.astuple(r) for r in ref.ranked]
    assert [dataclasses.astuple(r)[:4] for r in port.rejected] == \
        [dataclasses.astuple(r)[:4] for r in ref.rejected]
    assert tracers[1].counts() == tracers[0].counts()
    if campaign == "double PRD loss":
        assert port.chosen == "erasure(nvm-prd x6+2p)"
    if campaign == "triple PRD loss":
        assert port.chosen is None and port.ranked == ()
        with pytest.raises(api.UnsurvivableCampaignError,
                           match="no candidate"):
            api.ResilienceSpec.advise(_problems(seed=2)[1],
                                      _campaigns(api)[campaign])


def test_advised_spec_carries_the_campaign():
    _, problem = _problems(seed=3)
    campaign = _campaigns(api)["double PRD loss"]
    spec = api.ResilienceSpec.advise(problem, campaign,
                                     persist_mode="overlap")
    assert spec.backend == "erasure(nvm-prd x6+2p)"
    assert spec.persist_mode == "overlap"
    result = api.solve(problem, "pcg", spec, failures=campaign)
    assert result.converged and result.report.storage_failures == 2
