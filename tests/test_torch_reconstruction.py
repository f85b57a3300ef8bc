"""Exact reconstruction (Algorithm 3): one wiped state, rebuilt by both
packages.

The reference solve provides the state at iteration k and the persisted
pair ``p^(k-1), p^(k)``; the same wiped state goes through the reference
``reconstruct`` and, carried across by ``convert``, through the port's.

Tolerances: the dense local solve (Cholesky of A[F,F]) agrees between
the packages to rounding, rtol 1e-10; the local CG stops at relative
residual 1e-14, so its x_F agrees to about cond(A[F,F]) * 1e-14, and
1e-9 covers the 8^3 problem's blocks.  Both must also land on the
unfailed state at the reference's own rtol 1e-8
(tests/test_esr_reconstruction.py:178-183).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_problem, ref_problem, ref_state_numpy
from repro.core import reconstruction as ref_rec
from repro.core.spmv import make_det_dot
from repro.core.state import wipe_blocks
from repro.solvers import driver as ref_driver
from repro.solvers.pcg import PCGSolver as RefPCG
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import reconstruction as port_rec
from repro_torch.core.state import wipe_vectors

GRID, NBLOCKS, K = (8, 8, 8), 4, 6
TOL = {"dense": 1e-10, "cg": 1e-9}


@pytest.fixture(scope="module")
def reference_run():
    op, b, pre = ref_problem(GRID, NBLOCKS)
    _, _, cap = ref_driver.solve(RefPCG(), op, b, pre,
                                 ref_driver.SolveConfig(tol=1e-12),
                                 capture_states_at=[K - 1, K])
    return op, b, pre, cap


def _close(got, want, rtol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("failed", [(1,), (0, 2)])
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_reconstruction_matches_reference(reference_run, failed, method):
    op, b, pre, cap = reference_run
    truth, prev = cap[K], cap[K - 1]
    part = op.partition
    wiped = wipe_blocks(truth, part, failed)
    p_prev_f = part.restrict(prev.p, failed)
    p_cur_f = part.restrict(truth.p, failed)
    beta = float(truth.beta_prev)
    want = ref_rec.reconstruct(op, pre, b, wiped, failed, p_prev_f, p_cur_f,
                               beta, local_method=method,
                               dot=make_det_dot(NBLOCKS))

    problem = port_problem(GRID, NBLOCKS, b)
    st = state_from_numpy(ref_state_numpy(truth), "cpu")
    st = wipe_vectors(st, problem.op.partition, failed, ("x", "r", "z", "p"),
                      ("rz",))
    got = port_rec.reconstruct(
        problem.op, problem.precond, problem.b, st, failed,
        torch.from_numpy(np.array(p_prev_f)),
        torch.from_numpy(np.array(p_cur_f)), beta, local_method=method)

    got_np, want_np = state_to_numpy(got), ref_state_numpy(want)
    true_np = ref_state_numpy(truth)
    assert got_np["k"] == want_np["k"] == K
    for f in ("x", "r", "z", "p", "rz", "beta_prev"):
        _close(got_np[f], want_np[f], TOL[method], f"{f} vs reference")
        _close(got_np[f], true_np[f], 1e-8, f"{f} vs unfailed state")


def test_residual_on_failed_matches_reference(reference_run):
    op, b, _, cap = reference_run
    x = cap[K].x
    want = ref_rec.residual_on_failed(op, b, x, [1, 3])
    problem = port_problem(GRID, NBLOCKS, b)
    got = port_rec.residual_on_failed(problem.op, problem.b,
                                      torch.from_numpy(np.array(x)), [1, 3])
    _close(got.numpy(), np.asarray(want), 1e-13, "r_F")


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_solve_local_matches_reference(reference_run, method):
    op, b, _, _ = reference_run
    failed = [2]
    rhs = np.random.default_rng(4).standard_normal(op.partition.block_size)
    want = ref_rec.solve_local(lambda u: op.inblock_apply(u, failed),
                               jnp.asarray(rhs), method)
    problem = port_problem(GRID, NBLOCKS, b)
    got = port_rec.solve_local(lambda u: problem.op.inblock_apply(u, failed),
                               torch.from_numpy(rhs), method)
    _close(got.numpy(), np.asarray(want), TOL[method], "x_F")


def test_iterate_only_recovery_matches_reference(reference_run):
    """The ``{x}``-schema recovery (weighted Jacobi, restarted GMRES in
    the reference): scatter the persisted shard, recompute r_F."""
    from typing import NamedTuple

    from repro.core.state import wipe_vectors as ref_wipe
    from repro.solvers.base import IterateOnlyRecovery as RefIterateOnly
    from repro_torch.solvers.base import IterateOnlyRecovery, RecoverableSolver

    class XState(NamedTuple):
        x: object
        r: object
        k: object

    class Ref(RefIterateOnly):
        state_cls = XState

        def host_shard(self, arr):
            return np.asarray(arr)

    class Port(IterateOnlyRecovery):
        state_cls = XState
        host_shard = RecoverableSolver.host_shard

    op, b, _, cap = reference_run
    problem = port_problem(GRID, NBLOCKS, b)
    x_np = np.array(cap[K].x)
    ref, port = Ref(), Port()
    ref_st = ref.init_state(op, None, b, jnp.asarray(x_np))
    st = port.init_state(problem.op, None, problem.b, torch.from_numpy(x_np))
    _close(st.r.numpy(), np.asarray(ref_st.r), 1e-13, "r0")
    failed = [0, 3]
    full = port.recovery_set(st)
    assert full.vectors["x"].tobytes() == x_np.tobytes()
    shard = full._replace(vectors={"x": problem.op.partition.restrict(
        st.x, failed).numpy()})
    got = port.reconstruct(
        problem.op, None, problem.b,
        wipe_vectors(st, problem.op.partition, failed, ("x", "r")),
        failed, [shard])
    want = ref.reconstruct(
        op, None, b, ref_wipe(ref_st, op.partition, failed, ("x", "r")),
        failed, [ref.recovery_set(ref_st)._replace(vectors={
            "x": np.asarray(op.partition.restrict(ref_st.x, failed))})])
    _close(got.x.numpy(), np.asarray(want.x), 0.0, "x")
    _close(got.r.numpy(), np.asarray(want.r), 1e-13, "r")


# ----------------------------------------------------------------------
# the local CG in chunks (the form the card captures as a CUDA graph)
# ----------------------------------------------------------------------
def _local_system(reference_run, failed=(1, 2)):
    op, b, _, _ = reference_run
    problem = port_problem(GRID, NBLOCKS, b)
    rhs = np.random.default_rng(5).standard_normal(
        len(failed) * op.partition.block_size)
    failed = list(failed)
    return (op, failed, lambda u: problem.op.inblock_apply(u, failed),
            torch.from_numpy(rhs))


def test_plain_local_cg_counts_its_iterations(reference_run):
    _, _, apply_fn, rhs = _local_system(reference_run)
    info = {}
    x = port_rec._local_cg_plain(apply_fn, rhs, info=info)
    assert info["iterations"] > 8
    assert torch.equal(port_rec._local_cg(apply_fn, rhs), x)  # CPU: plain


@pytest.mark.parametrize("where", ["inside a chunk", "on a chunk boundary",
                                   "maxiter inside a chunk",
                                   "maxiter on a boundary", "one chunk"])
def test_chunked_local_cg_is_the_plain_loop_bitwise(reference_run, where):
    """The chunked loop run eagerly on the CPU, with its rerun of the
    chunk the stop falls in: the plain loop's ``x`` bit for bit, at the
    same iteration, wherever the stop (the residual test or
    ``maxiter``) falls; and within the reference's rtol 1e-8 of the
    reference's ``while_loop``."""
    op, failed, apply_fn, rhs = _local_system(reference_run)
    info = {}
    port_rec._local_cg_plain(apply_fn, rhs, info=info)
    k = info["iterations"]
    divisor = next(d for d in range(2, k + 1) if k % d == 0)
    chunk, maxiter = {
        "inside a chunk": (5 if k % 5 else 6, 10_000),
        "on a chunk boundary": (divisor, 10_000),
        "maxiter inside a chunk": (6, k - 3 if (k - 3) % 6 else k - 4),
        "maxiter on a boundary": (4, 8),
        "one chunk": (2 * k, 10_000),
    }[where]
    assert (min(k, maxiter) % chunk == 0) == ("boundary" in where)
    want_info, got_info = {}, {}
    want = port_rec._local_cg_plain(apply_fn, rhs, maxiter=maxiter,
                                    info=want_info)
    got = port_rec._local_cg_chunked(apply_fn, rhs, maxiter=maxiter,
                                     chunk=chunk, info=got_info)
    assert got_info["iterations"] == want_info["iterations"] == min(k, maxiter)
    assert torch.equal(got, want)
    assert not got_info["graph"] and got_info["launches_per_chunk"] is None
    stops_inside = min(k, maxiter) % chunk != 0
    assert (got_info["eager_iterations"] > 0) == stops_inside
    assert got_info["chunks"] == -(-min(k, maxiter) // chunk)
    if maxiter == 10_000:
        ref = ref_rec._local_cg(lambda u: op.inblock_apply(u, failed),
                                jnp.asarray(rhs.numpy()))
        _close(got.numpy(), np.asarray(ref), 1e-8, "x_F vs reference")


def test_chunked_local_cg_of_a_zero_rhs_is_zero(reference_run):
    _, _, apply_fn, rhs = _local_system(reference_run)
    info = {}
    x = port_rec._local_cg_chunked(apply_fn, torch.zeros_like(rhs), info=info)
    assert info["iterations"] == 0 and not x.any()
