"""A campaign the planner accepts on ``esr`` and the runtime cannot
always survive (ROADMAP Queue 3, N7), pinned in both packages.

Eight blocks of the 8^3 Poisson problem (Jacobi preconditioning), on the
``esr`` backend: blocks (0, 1, 2, 3) fail at iteration 4, then blocks
(4, 5, 6, 7) at 5.  ``plan_campaign`` checks each fetch's failed union
against ``max_block_failures`` and accepts it; but the peer copies the
first event's blocks held die with them and are not rewritten before
the second fetch, so some runs raise ``UnrecoverableFailure`` ("no
surviving copy").  Which ones depends on the solver, the persist mode
and the persistence period.  Over the five solvers x {sync, overlap} x
period {1, 3} both packages give the same verdict (accepted) and the
same outcome: the same exception type, or both recover with equal
iteration and recovery counts and ``x`` within rtol 1e-8.  GMRES runs
with ``m=4`` (as ``tests/test_torch_zoo.py`` does): at its default
``m=20`` it converges in one cycle, before the first kill.  A change to
either side's recovery path that moves an outcome fails here.
"""
import itertools

import numpy as np
import pytest

from _torch_port import port_problem, ref_problem
from repro.solvers import driver as ref_driver
from repro.solvers.registry import make_backend as ref_make_backend
from repro.solvers.registry import make_solver as ref_make_solver
from repro_torch.solvers import driver
from repro_torch.solvers.registry import make_backend, make_solver

SOLVERS = {"pcg": {}, "jacobi": {}, "chebyshev": {}, "bicgstab": {},
           "gmres": {"m": 4}}
CASES = list(itertools.product(SOLVERS, ("sync", "overlap"), (1, 3)))
#: the combinations that raise ``UnrecoverableFailure``; the others
#: recover both failures
RAISES = {("pcg", "sync", 1), ("pcg", "sync", 3), ("pcg", "overlap", 1),
          ("jacobi", "sync", 3), ("jacobi", "overlap", 3),
          ("chebyshev", "sync", 1), ("chebyshev", "sync", 3),
          ("chebyshev", "overlap", 1),
          ("bicgstab", "sync", 3), ("bicgstab", "overlap", 3),
          ("gmres", "sync", 3), ("gmres", "overlap", 3)}


def _campaign(mod):
    return mod.FailureCampaign((
        mod.FailureEvent(blocks=(0, 1, 2, 3), at_iteration=4),
        mod.FailureEvent(blocks=(4, 5, 6, 7), at_iteration=5)))


def _run(mod, mk_solver, mk_backend, op, b, pre, solver, mode, period):
    s = mk_solver(solver, op, pre, **SOLVERS[solver])
    backend = mk_backend("esr", op, solver=s)
    campaign = _campaign(mod)
    mod.plan_campaign(campaign, backend.capabilities)   # accepted: no raise
    config = mod.SolveConfig(tol=1e-10, maxiter=5000, persist_mode=mode,
                             persistence_period=period)
    try:
        st, rep, _ = mod.solve(s, op, b, pre, config, backend=backend,
                               failures=campaign)
    except Exception as e:  # the two packages' exceptions, compared
        return ("raised", type(e).__name__)
    return ("ok", np.asarray(st.x), rep.iterations, rep.failures_recovered)


def test_the_pinned_outcomes_count_twelve_of_twenty():
    assert len(CASES) == 20 and RAISES <= set(CASES) and len(RAISES) == 12


@pytest.mark.parametrize("solver,mode,period", CASES)
def test_n7_campaign_outcome_is_the_reference(solver, mode, period):
    ref_op, ref_b, ref_pre = ref_problem((8, 8, 8), 8)
    problem = port_problem((8, 8, 8), 8, np.asarray(ref_b))
    want = _run(ref_driver, ref_make_solver, ref_make_backend, ref_op,
                ref_b, ref_pre, solver, mode, period)
    got = _run(driver, make_solver, make_backend, problem.op, problem.b,
               problem.precond, solver, mode, period)
    expected = ("raised" if (solver, mode, period) in RAISES else "ok")
    assert got[0] == want[0] == expected
    if expected == "raised":
        assert got[1] == want[1] == "UnrecoverableFailure"
        return
    assert got[2:] == want[2:] and got[3] == 2
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8, atol=1e-12)
