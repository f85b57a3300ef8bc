"""The campaign-fuzz harness (``tests/test_campaign_fuzz.py``) run on both
packages: planner == runtime, and port == reference.

The same seeded campaigns and configs (``random_campaign`` /
``random_config``, the reference harness's generators, checked here to
draw the same events) go through both packages for every registered
spec family.  Per case:

- the planner's verdict is the same: the same planned recoveries and
  storage losses, or the same rejection message;
- the planned solve raises the same exception type, or both recover:
  every integer and byte field of the report equal, ``x`` within rtol
  1e-8 of the reference's (the packages sum in different orders), and
  the port's trace, report and registry consistent;
- a rejected campaign, run unplanned, dies with the same runtime
  exception type in both.

The service leg replays the reference harness's seeded traces through
both packages' ``SolveService``: the same admissions, the same refusals
(each an unsurvivable request by the reference leg's oracle), equal
per-tenant counters and ``x`` at rtol 1e-8.  The sharded leg draws the
reference harness's sharded configurations (1-8 shards, ``shard=`` and
block kills): the port's sharded solve is bitwise its unsharded solve of
the shard-resolved campaign and agrees with the reference's unsharded
solve in-process (rtol 1e-8, equal counters).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_campaign_fuzz as ref_fuzz
from _torch_port import port_problem, ref_problem
from repro import api as ref_api
from repro.distributed.sharding import ShardLayout as RefShardLayout
from repro.nvm.backend import UnrecoverableFailure as RefUnrecoverable
from repro.solvers import driver as ref_driver
from repro.solvers.registry import make_backend as ref_make_backend
from repro.solvers.registry import make_solver as ref_make_solver
from repro_torch import api
from repro_torch.nvm.backend import UnrecoverableFailure, backend_names
from repro_torch.obs import Tracer, check_trace_report
from repro_torch.solvers import driver
from repro_torch.solvers.registry import make_backend, make_solver

SPECS = ref_fuzz.SPECS
SEEDS = ref_fuzz.SEEDS
NBLOCKS = ref_fuzz.NBLOCKS
#: the report's integer and byte fields
FIELDS = ("iterations", "converged", "wasted_iterations",
          "failures_recovered", "recovery_restarts", "storage_failures",
          "persist_events", "persist_aborts", "nshards", "persist_bytes",
          "recovery_fetch_bytes", "persist_bytes_by_shard",
          "recovery_fetch_bytes_by_shard")


def _events(campaign):
    return [(e.blocks, e.at_iteration, e.during_recovery_at, e.prd, e.shard)
            for e in campaign.events]


def random_campaign(mod, seed: int):
    """``ref_fuzz.random_campaign`` drawing ``mod``'s events."""
    return mod.FailureCampaign(tuple(
        mod.FailureEvent(blocks=b, at_iteration=at, during_recovery_at=dr,
                         prd=prd, shard=shard)
        for b, at, dr, prd, shard in _events(ref_fuzz.random_campaign(seed))))


def random_config(mod, seed: int):
    cfg = ref_fuzz.random_config(seed)
    return mod.SolveConfig(tol=cfg.tol, maxiter=cfg.maxiter,
                           persist_mode=cfg.persist_mode,
                           persistence_period=cfg.persistence_period)


def test_specs_cover_every_registered_family():
    assert {spec.split("(")[0] for spec in SPECS} == set(backend_names())


def _plan(mod, campaign, caps, layout=None):
    try:
        plan = mod.plan_campaign(campaign, caps, layout=layout)
    except mod.UnsurvivableCampaignError as e:
        return "rejected", str(e)
    return "accepted", ([dataclasses.astuple(r) for r in plan.recoveries],
                        plan.storage_losses)


def _outcome(mod, solver, op, b, pre, backend, config, campaign):
    """``("raised", exception type)`` or ``("ok", state, report)``."""
    try:
        st, rep, _ = mod.solve(solver, op, b, pre, config, backend=backend,
                               failures=campaign)
    except Exception as e:  # the two packages' exceptions, compared
        return ("raised", type(e).__name__)
    return ("ok", st, rep)


def _assert_same(got, want, ctx):
    assert got[0] == want[0], (ctx, got, want)
    if got[0] == "raised":
        assert got[1] == want[1], ctx
        return
    for field in FIELDS:
        assert getattr(got[2], field) == getattr(want[2], field), (ctx, field)
    np.testing.assert_allclose(got[1].x.numpy(), np.asarray(want[1].x),
                               rtol=1e-8, atol=1e-12, err_msg=str(ctx))


def _fuzz_case(spec: str, seed: int) -> str:
    ref_op, ref_b, ref_pre = ref_problem((8, 8, 8), NBLOCKS)
    problem = port_problem((8, 8, 8), NBLOCKS, np.asarray(ref_b))
    sides = []
    for mod, mk_solver, mk_backend, op, b, pre in (
            (ref_driver, ref_make_solver, ref_make_backend, ref_op, ref_b,
             ref_pre),
            (driver, make_solver, make_backend, problem.op, problem.b,
             problem.precond)):
        campaign, config = random_campaign(mod, seed), random_config(mod, seed)
        solver = mk_solver("pcg", op, pre)
        backend = mk_backend(spec, op, solver=solver)
        verdict = _plan(mod, campaign, backend.capabilities)
        tracer = Tracer() if mod is driver else None
        planned = _outcome(mod, solver, op, b, pre, backend,
                           dataclasses.replace(config, tracer=tracer),
                           campaign)
        unplanned = None
        if verdict[0] == "rejected":
            unplanned = _outcome(
                mod, solver, op, b, pre, mk_backend(spec, op, solver=solver),
                dataclasses.replace(config, plan_campaign=False), campaign)
        sides.append((verdict, planned, unplanned, tracer))
    (ref_verdict, ref_planned, ref_unplanned, _), \
        (verdict, planned, unplanned, tracer) = sides
    ctx = (spec, seed)
    assert verdict == ref_verdict, ctx
    _assert_same(planned, ref_planned, ctx)
    if verdict[0] == "rejected":
        assert planned == ("raised", "UnsurvivableCampaignError"), ctx
        _assert_same(unplanned, ref_unplanned, ctx)
        assert unplanned[1] == UnrecoverableFailure.__name__ \
            == RefUnrecoverable.__name__, ctx
    else:
        assert planned[2].converged, ctx
        check_trace_report(tracer, planned[2])
    return verdict[0]


def test_generators_draw_the_reference_harness_events():
    for seed in SEEDS:
        assert _events(random_campaign(driver, seed)) == _events(
            ref_fuzz.random_campaign(seed))


@pytest.mark.parametrize("spec", SPECS)
def test_campaign_fuzz_matches_reference(spec):
    verdicts = {_fuzz_case(spec, seed) for seed in SEEDS}
    assert "accepted" in verdicts, spec


# ------------------------------------------------ the service leg
@pytest.mark.parametrize("seed", ref_fuzz.SERVICE_TRACE_SEEDS)
def test_campaign_fuzz_service_leg_matches_reference(seed):
    kw = dict(nrequests=5, failure_rate=0.6)
    outcomes = []
    for pkg, reqs in ((ref_api, ref_api.generate_request_trace(seed, **kw)),
                      (api, api.generate_request_trace(seed, **kw))):
        cfg = dict(lanes=4, max_queue=16)
        if pkg is api:
            cfg["device"] = "cpu"
        svc = pkg.SolveService(pkg.ServiceConfig(**cfg))
        tickets, refused = {}, {}
        for req in sorted(reqs, key=lambda r: (r.at_step, r.tenant)):
            try:
                tickets[req.tenant] = svc.submit_request(req)
            except pkg.UnsurvivableCampaignError as e:
                refused[req.tenant] = str(e)
        svc.drain()
        outcomes.append((reqs, tickets, refused))
    (ref_reqs, ref_tickets, ref_refused), (reqs, tickets, refused) = outcomes
    assert [r.tenant for r in reqs] == [r.tenant for r in ref_reqs]
    assert refused == ref_refused
    for req in reqs:
        if req.tenant in refused:
            assert ref_fuzz._expect_unsurvivable(req), (seed, req.tenant)
            continue
        ctx = (seed, req.tenant, req.solver, req.backend)
        got, want = tickets[req.tenant], ref_tickets[req.tenant]
        assert got.accepted and want.accepted, ctx
        for field in ("iterations", "converged", "failures_recovered",
                      "storage_failures", "nshards", "persist_events"):
            assert getattr(got.result.report, field) == getattr(
                want.result.report, field), (ctx, field)
        np.testing.assert_allclose(got.result.x, np.asarray(want.result.x),
                                   rtol=1e-8, atol=1e-10, err_msg=str(ctx))


# ------------------------------------------------ the sharded leg
SHARDED_NBLOCKS = 8
_SHARDED_REF = {}


def random_sharded_campaign(mod, seed: int, nshards: int):
    """The reference harness's sharded campaign generator, drawing
    ``mod``'s events (its ``_SHARDED_SUB`` payload, in-process)."""
    rng = np.random.default_rng(seed)
    events = []
    n_at = int(rng.integers(1, 3))
    ats = sorted(rng.choice(np.arange(3, 13), size=n_at, replace=False))
    for at in ats:
        prd = bool(rng.random() < 0.45)
        if rng.random() < 0.5:   # shard-addressed kill
            ev = mod.FailureEvent(shard=int(rng.integers(nshards)),
                                  at_iteration=int(at), prd=prd)
        else:                    # block-addressed kill
            nb = int(rng.integers(1, 3))
            blocks = tuple(sorted(int(x) for x in rng.choice(
                SHARDED_NBLOCKS, nb, replace=False)))
            ev = mod.FailureEvent(blocks=blocks, at_iteration=int(at),
                                  prd=prd)
        events.append(ev)
    return mod.FailureCampaign(tuple(events))


def _sharded_nshards(seed: int) -> int:
    return int(np.random.default_rng(20_000 + seed).choice([1, 2, 4, 8]))


@pytest.mark.parametrize("seed", SEEDS)
def test_campaign_fuzz_sharded_leg(seed):
    from repro_torch.distributed import shard_problem
    from repro_torch.distributed.sharding import gather

    nshards = _sharded_nshards(seed)
    ref_op, ref_b, ref_pre = ref_problem((8, 8, 8), SHARDED_NBLOCKS)
    problem = port_problem((8, 8, 8), SHARDED_NBLOCKS, np.asarray(ref_b))
    sop, sb = shard_problem(problem.op, problem.b, nshards)
    campaign = random_sharded_campaign(driver, seed, nshards)
    ref_campaign = ref_driver.resolve_shard_events(
        random_sharded_campaign(ref_driver, seed, nshards),
        RefShardLayout(SHARDED_NBLOCKS, nshards))
    resolved = driver.resolve_shard_events(campaign, sop.layout)
    assert _events(resolved) == _events(ref_campaign)
    config = random_config(driver, seed)
    verdicts = set()
    for spec in SPECS:
        ctx = (spec, seed, nshards)
        solver = make_solver("pcg", sop, problem.precond)
        backend = make_backend(spec, problem.op, solver=solver)
        verdict = _plan(driver, campaign, backend.capabilities,
                        layout=sop.layout)
        ref_solver = ref_make_solver("pcg", ref_op, ref_pre)
        ref_backend = ref_make_backend(spec, ref_op, solver=ref_solver)
        assert verdict == _plan(ref_driver, ref_campaign,
                                ref_backend.capabilities), ctx
        verdicts.add(verdict[0])
        if verdict[0] == "rejected":
            assert any(repr(ev) in verdict[1] for ev in resolved.events), ctx
            continue
        st, rep, _ = driver.solve(solver, sop, sb, problem.precond, config,
                                  backend=backend, failures=campaign)
        s0 = make_solver("pcg", problem.op, problem.precond)
        st0, rep0, _ = driver.solve(
            s0, problem.op, problem.b, problem.precond, config,
            backend=make_backend(spec, problem.op, solver=s0),
            failures=resolved)
        assert torch.equal(gather(st.x), st0.x), ctx
        ref_config = random_config(ref_driver, seed)
        ref_st, ref_rep, _ = ref_driver.solve(
            ref_solver, ref_op, jnp.asarray(ref_b), ref_pre, ref_config,
            backend=ref_backend, failures=ref_campaign)
        assert rep.converged and rep.nshards == nshards, ctx
        for field in FIELDS[:-3]:
            if field != "nshards":
                assert getattr(rep, field) == getattr(ref_rep, field), \
                    (ctx, field)
        assert rep.recovery_fetch_bytes == ref_rep.recovery_fetch_bytes, ctx
        np.testing.assert_allclose(gather(st.x).numpy(), np.asarray(ref_st.x),
                                   rtol=1e-8, atol=1e-12, err_msg=str(ctx))
    assert "accepted" in verdicts
