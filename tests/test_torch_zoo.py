"""The port's solver zoo, block-Jacobi PCG, spectral bounds and
``solve_jit`` against the reference package.

Right-hand sides are made with numpy from a seed and handed to both
packages.  Tolerances: solutions and per-iteration states rtol 1e-9
(the two packages sum stencil rows, block dots and the GMRES
least-squares solve in different orders, on the same values); spectral
bounds rtol 1e-12 where both routes compute the same numbers (closed
form, dense eigenvalues), 1e-8 for power iteration (the port normalizes
with the block dot, the reference with ``jnp.linalg.norm``);
``solve_jit`` rtol 1e-8 with ``k`` within 1 (the reference's stopping
dot is ``jnp.vdot``, see ``tests/test_pcg.py``).  Counters are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_problem, ref_problem, rng_normal
from repro import api as ref_api
from repro.core import pcg as ref_pcg
from repro.core.poisson import DenseOperator as RefDense
from repro.core.poisson import IdentityPreconditioner as RefIdentity
from repro.core.spmv import make_det_dot as ref_det_dot
from repro.solvers.chebyshev import spectral_bounds as ref_spectral_bounds
from repro_torch import api
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import solve_jit
from repro_torch.core.poisson import DenseOperator, IdentityPreconditioner
from repro_torch.core.poisson import random_spd
from repro_torch.kernels import ops
from repro_torch.solvers import SOLVERS, spectral_bounds

GRID, NBLOCKS = (8, 8, 8), 4
COUNTERS = ("iterations", "converged", "failures_recovered",
            "recovery_restarts", "wasted_iterations", "persist_events",
            "persist_aborts", "persist_bytes", "recovery_fetch_bytes",
            "storage_failures")
# (fail_at, solver opts): gmres counts restart cycles, not iterations
ZOO = {
    "jacobi": (10, {}),
    "chebyshev": (10, {}),
    "bicgstab": (10, {}),
    "gmres": (3, {"m": 4}),
}


def _problems(grid=GRID, nblocks=NBLOCKS, seed=0, precond="jacobi"):
    """The same seeded right-hand side as a reference and a port problem."""
    b = 0.5 + rng_normal(seed, int(np.prod(grid)))
    op, _, pre = ref_problem(grid, nblocks, precond)
    return (ref_api.Problem.from_parts(op, jnp.asarray(b), pre),
            port_problem(grid, nblocks, b, precond))


def _assert_state_close(port, ref, rtol=1e-9, what=""):
    got = state_to_numpy(port)
    assert set(got) == set(ref._fields), what
    assert got["k"] == int(ref.k), what
    for f in ref._fields:
        if f == "k":
            continue
        want = np.asarray(getattr(ref, f))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got[f], want, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {f}")


def _assert_reports_equal(port, ref):
    for name in COUNTERS:
        assert getattr(port.report, name) == getattr(ref.report, name), name


def test_registry_matches_reference():
    from repro.solvers import SOLVERS as REF_SOLVERS

    assert sorted(SOLVERS) == sorted(REF_SOLVERS) == api.solver_names()


@pytest.mark.parametrize("backend", ["nvm-prd", "nvm-homogeneous"])
@pytest.mark.parametrize("solver", sorted(ZOO))
def test_multi_block_failure_matches_reference(solver, backend):
    """A mid-solve failure of blocks (1, 2) through both packages'
    ``api.solve``: equal counters, and the states around the failure
    and the solution within rtol 1e-9 of the reference's."""
    fail_at, opts = ZOO[solver]
    at = [fail_at - 1, fail_at, fail_at + 2]
    results = []
    for pkg, problem in zip((ref_api, api), _problems(seed=1)):
        results.append(pkg.solve(
            problem, pkg.SolverSpec(solver, tol=1e-10, maxiter=5000,
                                    options=opts),
            pkg.ResilienceSpec(backend),
            failures=[pkg.FailureEvent(blocks=(1, 2), at_iteration=fail_at)],
            capture_states_at=at))
    ref, port = results
    _assert_reports_equal(port, ref)
    assert port.converged and port.report.failures_recovered == 1
    assert port.report.wasted_iterations == 0
    for k in at:
        _assert_state_close(port.captured[k], ref.captured[k], what=f"k={k}")
    np.testing.assert_allclose(port.x, ref.x, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("solver", sorted(ZOO))
def test_recovered_run_equals_failure_free_port_run(solver):
    """Inside the port, a recovered run lands on the port's own
    failure-free trajectory, as chip_smoke.py checks on the card."""
    fail_at, opts = ZOO[solver]
    _, problem = _problems(seed=2)
    spec = api.SolverSpec(solver, tol=1e-10, maxiter=5000, options=opts)
    free = api.solve(problem, spec, "nvm-prd")
    hit = api.solve(problem, spec, "nvm-prd",
                    failures=[api.FailureEvent(blocks=(0, 3),
                                               at_iteration=fail_at)])
    assert hit.iterations == free.iterations
    np.testing.assert_allclose(hit.x, free.x, rtol=1e-8, atol=1e-8)


def test_zoo_state_carried_across_steps_like_the_reference():
    """A reference Chebyshev / BiCGStab / GMRES state carried across by
    ``convert`` steps to what the reference's next state is."""
    from repro.solvers.registry import make_solver as ref_make_solver
    from repro_torch.solvers.registry import make_solver

    ref_problem_, problem = _problems(seed=3)
    for name, opts in (("chebyshev", {}), ("bicgstab", {}), ("gmres", {"m": 3}),
                       ("jacobi", {})):
        ref_solver = ref_make_solver(name, ref_problem_.op,
                                     ref_problem_.precond, **opts)
        ref_st = ref_solver.init_state(ref_problem_.op, ref_problem_.precond,
                                       ref_problem_.b)
        ref_step = ref_solver.make_step(ref_problem_.op, ref_problem_.precond)
        for _ in range(3):
            ref_st = ref_step(ref_st)
        solver = make_solver(name, problem.op, problem.precond, **opts)
        solver.init_state(problem.op, problem.precond, problem.b)
        fields = {f: np.asarray(getattr(ref_st, f)) for f in ref_st._fields}
        st = state_from_numpy(fields | {"k": int(ref_st.k)}, "cpu",
                              solver=name)
        _assert_state_close(st, ref_st, rtol=0.0, what=name)
        step = solver.make_step(problem.op, problem.precond)
        _assert_state_close(step(st), ref_step(ref_st), what=name)


def test_state_class_from_the_field_set():
    fields = {f: np.zeros(4) for f in ("x", "r", "z", "p")}
    scalars = {"alpha": 0.5, "rho": 0.25, "beta_prev": 0.0, "k": 3}
    st = state_from_numpy(fields | scalars, "cpu")
    assert type(st).__name__ == "ChebyshevState" and st.alpha.dim() == 0
    with pytest.raises(ValueError, match="name the solver"):
        state_from_numpy({"x": np.zeros(4), "r": np.zeros(4), "k": 0}, "cpu")


# ----------------------------------------------------------------------
# spectral bounds: the three routes
# ----------------------------------------------------------------------
def _dense_pair(n, seed):
    a = random_spd(n, seed=seed)
    ref_op = RefDense(a, nblocks=4)
    op = DenseOperator(a, nblocks=4, device="cpu")
    return (ref_op, RefIdentity(ref_op)), (op, IdentityPreconditioner(op))


@pytest.mark.parametrize("route,case,rtol", [
    ("closed", ((8, 8, 8), "identity"), 1e-12),
    ("closed", ((16, 6, 10), "jacobi"), 1e-12),
    ("dense", ((8, 8, 8), "block_jacobi"), 1e-12),
    ("dense", "spd64", 1e-12),
    ("power", ((16, 16, 9), "block_jacobi"), 1e-8),
])
def test_spectral_bounds_match_reference(route, case, rtol):
    if case == "spd64":
        (ref_op, ref_pre), (op, pre) = _dense_pair(64, seed=5)
    else:
        grid, precond = case
        ref_op, _, ref_pre = ref_problem(grid, 8, precond)
        problem = port_problem(grid, 8, np.ones(int(np.prod(grid))), precond)
        op, pre = problem.op, problem.precond
    assert (op.n <= 2048) == (route != "power")
    want = ref_spectral_bounds(ref_op, ref_pre)
    got = spectral_bounds(op, pre)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    assert 0 < got[0] < got[1]


# ----------------------------------------------------------------------
# block-Jacobi PCG (the unfused step)
# ----------------------------------------------------------------------
def test_block_jacobi_pcg_states_match_reference():
    ref_p, problem = _problems(seed=4, precond="block_jacobi")
    dot = ref_det_dot(NBLOCKS)
    ref_st = ref_pcg.init_state(ref_p.op, ref_p.precond, ref_p.b, dot=dot)
    ref_step = ref_pcg.make_step(ref_p.op.apply, ref_p.precond.apply, dot=dot)
    solver = SOLVERS["pcg"]()
    st = solver.init_state(problem.op, problem.precond, problem.b)
    step = solver.make_step(problem.op, problem.precond)
    _assert_state_close(st, ref_st, what="k=0")
    for k in range(1, 13):
        ref_st, st = ref_step(ref_st), step(st)
        _assert_state_close(st, ref_st, what=f"k={k}")
    np.testing.assert_allclose(
        problem.precond.apply(problem.b).numpy(),
        np.asarray(ref_p.precond.apply(ref_p.b)), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("mode,fused", [("sync", False), ("overlap", True)])
def test_block_jacobi_recovery_matches_reference(mode, fused):
    """Block-Jacobi PCG recovers blocks (1, 2) like the reference; on
    the fused overlap stripe it stages through K3 at the flush (K4 needs
    a diagonal preconditioner) and does not raise."""
    fail_at = 6
    results = []
    spec = "erasure(nvm-prd x4+p)" if fused else "nvm-prd"
    for pkg, problem in zip((ref_api, api),
                            _problems(seed=5, precond="block_jacobi")):
        results.append(pkg.solve(
            problem, pkg.SolverSpec("pcg", tol=1e-10),
            pkg.ResilienceSpec(spec, persist_mode=mode, fused_persist=fused),
            failures=[pkg.FailureEvent(blocks=(1, 2), at_iteration=fail_at)],
            capture_states_at=[fail_at, fail_at + 1]))
    ref, port = results
    _assert_reports_equal(port, ref)
    for k in (fail_at, fail_at + 1):
        _assert_state_close(port.captured[k], ref.captured[k], what=f"k={k}")
    np.testing.assert_allclose(port.x, ref.x, rtol=1e-9, atol=1e-12)
    if fused:
        routes = port.report.metrics.counter_by_label("persist.route",
                                                      "route")
        assert set(routes) == {"K3"}


# ----------------------------------------------------------------------
# solve_jit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_solve_jit_matches_reference(precond):
    ref_p, problem = _problems(seed=6, precond=precond)
    x_ref, k_ref = ref_pcg.solve_jit(ref_p.op.apply, ref_p.precond.apply,
                                     ref_p.b, tol=1e-10)
    x, k = solve_jit(problem.op, problem.precond, problem.b, tol=1e-10)
    assert abs(k - int(k_ref)) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("chunk,maxiter", [(32, 10_000), (5, 10_000),
                                           (1, 10_000), (8, 20), (64, 13)])
def test_solve_jit_is_the_driver_loop_bitwise(chunk, maxiter):
    """At any chunk size, and whether the stop falls inside a chunk,
    at its end or at ``maxiter``, the eager chunk loop's ``x`` is bitwise
    the driver's unprotected loop's at the same ``k``; one host read per
    chunk, no kernel launch on the CPU."""
    _, problem = _problems(seed=7)
    ops.reset_launch_counts()
    info = {}
    x, k = solve_jit(problem.op, problem.precond, problem.b, tol=1e-10,
                     maxiter=maxiter, chunk=chunk, info=info)
    assert set(ops.launch_counts().values()) == {0}
    free = api.solve(problem, api.SolverSpec("pcg", tol=1e-10))
    assert k == min(maxiter, free.iterations)
    driver = api.solve(problem, api.SolverSpec("pcg", tol=0.0, maxiter=k))
    assert driver.iterations == k
    assert torch.equal(x, driver.state.x)
    size = min(chunk, maxiter)
    assert info["graph"] is False and info["chunk"] == size
    assert info["chunks"] == -(-k // size)
    assert info["eager_iterations"] == (k % size)


def test_solve_jit_edge_cases():
    _, problem = _problems(seed=8)
    x, k = solve_jit(problem.op, problem.precond, problem.b, maxiter=0)
    assert k == 0 and not bool(x.any())
    x, k = solve_jit(problem.op, problem.precond, problem.b, tol=2.0)
    assert k == 0
    bj = _problems(seed=8, precond="block_jacobi")[1]
    with pytest.raises(ValueError, match="inv_diag"):
        solve_jit(bj.op, bj.precond, bj.b)


@pytest.mark.parametrize("solver,mode", [("gmres", "sync"),
                                         ("jacobi", "overlap"),
                                         ("bicgstab", "sync")])
def test_zoo_sets_reach_the_fused_stripe_on_device(solver, mode, monkeypatch):
    """On the fused stripe a zoo solver's recovery set is handed over as
    device tensors (``recovery_set(on_device=True)``) and encoded by the
    K3 seam, never through the numpy route, and the solve is bitwise the
    numpy route's."""
    from repro_torch.nvm import backend

    _, problem = _problems(seed=9)
    fail_at, opts = ZOO[solver]
    spec = api.SolverSpec(solver, tol=1e-10, maxiter=fail_at + 3,
                          options=opts)
    failures = [api.FailureEvent(blocks=(1, 2), at_iteration=fail_at)]
    numpy_route = api.solve(problem, spec,
                            api.ResilienceSpec("erasure(nvm-prd x4+p)",
                                               persist_mode=mode),
                            failures=failures)
    seen = []
    encode = backend.ops.rs_encode
    monkeypatch.setattr(backend.ops, "rs_encode", lambda data, nparity: (
        seen.append(data.device.type) or encode(data, nparity)))
    fused = api.solve(problem, spec,
                      api.ResilienceSpec("erasure(nvm-prd x4+p)",
                                         persist_mode=mode,
                                         fused_persist=True),
                      failures=failures)
    routes = fused.report.metrics.counter_by_label("persist.route", "route")
    assert set(routes) == {"K3"} and seen and set(seen) == {"cpu"}
    assert len(seen) == routes["K3"] * len(SOLVERS[solver].schema.vectors)
    assert torch.equal(fused.state.x, numpy_route.state.x)
