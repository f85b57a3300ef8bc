"""The port's PCG iteration against the reference package's.

Both packages start from the same problem (the reference's right-hand
side carried across by ``convert``) and the same state.  The two sum in
different orders, so float64 states agree to rtol 1e-10 rather than
bitwise; the iteration count to tol 1e-10 must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_problem, ref_problem, ref_state_numpy
from repro.core import pcg as ref_pcg
from repro.core.poisson import DenseOperator as RefDense
from repro.core.spmv import make_det_dot
from repro_torch import api
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import pcg as port_pcg
from repro_torch.core.poisson import (
    BlockPartition,
    DenseOperator,
    JacobiPreconditioner,
    random_spd,
)
from repro_torch.solvers.pcg import PCGSolver

GRIDS = [((8, 8, 8), 4), ((16, 8, 8), 4)]


def _assert_states_close(port, ref, rtol=1e-10):
    got = state_to_numpy(port)
    want = ref_state_numpy(ref)
    assert got["k"] == want["k"]
    for f in ("x", "r", "z", "p", "rz", "beta_prev"):
        scale = max(1.0, float(np.abs(want[f]).max()))
        np.testing.assert_allclose(got[f], want[f], rtol=rtol,
                                   atol=rtol * scale, err_msg=f)


@pytest.mark.parametrize("grid,nblocks", GRIDS)
@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_per_iteration_states_match_reference(grid, nblocks, precond):
    op, b, pre = ref_problem(grid, nblocks, precond)
    dot = make_det_dot(nblocks)
    ref_st = ref_pcg.init_state(op, pre, b, dot=dot)
    ref_step = ref_pcg.make_step(op.apply, pre.apply, dot=dot)

    problem = port_problem(grid, nblocks, b, precond)
    solver = PCGSolver()
    st = solver.init_state(problem.op, problem.precond, problem.b)
    step = solver.make_step(problem.op, problem.precond)
    _assert_states_close(st, ref_st)
    for _ in range(12):
        ref_st, st = ref_step(ref_st), step(st)
        _assert_states_close(st, ref_st)


def test_step_from_a_carried_state():
    """A reference state carried across by ``convert`` steps to what the
    reference's next state is."""
    grid, nblocks = (8, 8, 8), 4
    op, b, pre = ref_problem(grid, nblocks)
    dot = make_det_dot(nblocks)
    ref_st = ref_pcg.init_state(op, pre, b, dot=dot)
    ref_step = ref_pcg.make_step(op.apply, pre.apply, dot=dot)
    for _ in range(5):
        ref_st = ref_step(ref_st)
    problem = port_problem(grid, nblocks, b)
    st = state_from_numpy(ref_state_numpy(ref_st), "cpu")
    _assert_states_close(st, ref_st, rtol=0.0)
    step = port_pcg.make_step(problem.op.apply, problem.precond.inv_diag,
                              nblocks)
    _assert_states_close(step(st), ref_step(ref_st))


@pytest.mark.parametrize("grid,nblocks", GRIDS)
@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_iterations_to_tolerance_equal(grid, nblocks, precond):
    from repro import api as ref_api

    ref = ref_api.solve(
        ref_api.Problem.poisson(*grid, nblocks=nblocks,
                                preconditioner=precond),
        ref_api.SolverSpec("pcg", tol=1e-10))
    port = api.solve(
        api.Problem.poisson(*grid, nblocks=nblocks, preconditioner=precond,
                            device="cpu"),
        api.SolverSpec("pcg", tol=1e-10))
    assert ref.converged and port.converged
    assert port.iterations == ref.iterations
    np.testing.assert_allclose(port.x, ref.x, rtol=1e-8, atol=1e-10)


def test_poisson_rhs_matches_reference():
    _, b_ref, _ = ref_problem((8, 6, 5), 2)
    problem = api.Problem.poisson(8, 6, 5, nblocks=2, device="cpu")
    np.testing.assert_allclose(problem.b.numpy(), np.asarray(b_ref),
                               rtol=1e-15, atol=1e-15)


def test_to_dense_matches_reference():
    from repro.core.poisson import StencilOperator as RefStencil

    want = RefStencil(4, 3, 5, nblocks=2).to_dense()
    got = api.Problem.poisson(4, 3, 5, nblocks=2, device="cpu").op.to_dense()
    np.testing.assert_array_equal(got, want)


def test_dense_operator_pcg_matches_numpy_direct():
    a = random_spd(64, seed=3)
    b = np.random.default_rng(0).standard_normal(64)
    op = DenseOperator(a, nblocks=4, device="cpu")
    problem = api.Problem.from_parts(op, torch.from_numpy(b),
                                     JacobiPreconditioner(op))
    res = api.solve(problem, api.SolverSpec("pcg", tol=1e-12))
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)
    ref_op = RefDense(a, nblocks=4)
    np.testing.assert_allclose(op.apply(torch.from_numpy(b)).numpy(),
                               np.asarray(ref_op.apply(jnp.asarray(b))),
                               rtol=1e-14, atol=1e-14)


def test_block_partition_round_trip():
    part = BlockPartition(32, 4)
    x = torch.arange(32, dtype=torch.float64)
    v = part.restrict(x, [1, 3])
    assert torch.equal(part.restrict(part.embed(v, [1, 3]), [1, 3]), v)
    assert float(part.restrict(part.zero_blocks(x, [0, 2]), [0, 2]).abs().sum()) == 0
    assert torch.equal(part.scatter(x, torch.zeros(16, dtype=torch.float64),
                                    [1, 3]), part.zero_blocks(x, [1, 3]))
