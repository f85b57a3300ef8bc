"""The port's legacy PCG entry (``repro_torch.core.solve``, ``PCGConfig``,
``FailurePlan``) and the leftovers of the main path against the
reference package.

- The paper's example (``examples/solve_poisson_recovery.py``) at test
  scale: plain PCG, in-RAM ESR, NVM-ESR homogeneous and NVM-ESR/PRD hit
  by the same 3-block failure, through both packages' ``core.solve``:
  equal iteration counts and counters, ``x`` within rtol 1e-8 of the
  reference's (the packages sum in different orders), every recovered
  ``x`` within 1e-8 of the plain run's (the example's own assertion),
  and equal RAM and NVM footprints.
- The PCG slot codec (``encode_payload`` / ``decode_payload``): payload
  bytes equal byte for byte, and each package decodes the other's.
- ``should_persist``, ``minimal_recovery_state``, ``wipe_blocks``,
  ``payload_nbytes``, ``NVMESRHomogeneous.latest_pair`` and the package
  re-exports (``repro_torch.core``, ``obs``, ``nvm``) give the
  reference's answers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from _torch_port import port_problem, ref_problem, ref_state_numpy, rng_normal
from repro.core import state as ref_state
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import state

GRID, NBLOCKS = (16, 8, 8), 8
FAIL = dict(at_iteration=12, blocks=(1, 2, 6))
#: the example's variants: backend class name (None for plain PCG)
VARIANTS = (None, "InMemoryESR", "NVMESRHomogeneous", "NVMESRPRD")
COUNTERS = ("iterations", "converged", "wasted_iterations",
            "failures_recovered", "persist_events", "persist_bytes",
            "recovery_fetch_bytes")

_RUNS = {}


def _runs():
    """Each variant through both packages' ``core.solve``, once."""
    if not _RUNS:
        rop, rb, rpre = ref_problem(GRID, NBLOCKS)
        problem = port_problem(GRID, NBLOCKS, np.asarray(rb))
        bs = problem.op.partition.block_size
        for variant in VARIANTS:
            out = {}
            for pkg, op, b, pre in ((ref_core, rop, rb, rpre),
                                    (core, problem.op, problem.b,
                                     problem.precond)):
                backend = (None if variant is None else
                           getattr(pkg, variant)(NBLOCKS, bs, np.float64))
                fails = [] if variant is None else [pkg.FailurePlan(**FAIL)]
                st, rep, _ = pkg.solve(op, b, pre, pkg.PCGConfig(tol=1e-10),
                                       backend=backend, failures=fails)
                out[pkg.__name__] = (st, rep, backend)
            _RUNS[variant] = out
    return _RUNS


@pytest.mark.parametrize("variant", VARIANTS)
def test_example_runs_match_reference(variant):
    runs = _runs()
    (ref_st, ref_rep, ref_be) = runs[variant]["repro.core"]
    (st, rep, be) = runs[variant]["repro_torch.core"]
    for field in COUNTERS:
        assert getattr(rep, field) == getattr(ref_rep, field), field
    assert rep.converged and rep.final_relres < 1e-10
    x = st.x.numpy()
    np.testing.assert_allclose(x, np.asarray(ref_st.x), rtol=1e-8, atol=1e-12)
    plain = runs[None]["repro_torch.core"][0].x.numpy()
    assert float(np.max(np.abs(x - plain))) < 1e-8
    if variant is not None:
        assert rep.failures_recovered == 1
        assert be.memory_overhead_values() == ref_be.memory_overhead_values()
        assert be.nvm_values() == ref_be.nvm_values()


def test_latest_pair_matches_reference():
    runs = _runs()["NVMESRHomogeneous"]
    ref_be, be = runs["repro.core"][2], runs["repro_torch.core"][2]
    for block in range(NBLOCKS):
        assert be.latest_pair(block) == ref_be.latest_pair(block) \
            == be.latest_run(block)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_payload_bytes_equal_and_cross_decode(dtype):
    p = rng_normal(5, 96).astype(dtype)
    ours = state.encode_payload(7, -0.125, p)
    theirs = ref_state.encode_payload(7, -0.125, p)
    assert ours == theirs
    assert state.payload_nbytes(96, dtype) == ref_state.payload_nbytes(
        96, dtype) == len(ours)
    for decoded in (state.decode_payload(theirs, dtype),
                    ref_state.decode_payload(ours, dtype)):
        assert decoded.k == 7 and decoded.beta == -0.125
        assert np.array_equal(decoded.p, p) and decoded.p.dtype == dtype
    assert type(state.decode_payload(theirs, dtype)).__name__ \
        == "RecoveryPayload"


def test_should_persist_matches_reference():
    from repro.core.pcg import should_persist as ref_should_persist
    from repro_torch.core.pcg import should_persist

    for period in (1, 2, 3, 5):
        assert [should_persist(k, period) for k in range(20)] == [
            ref_should_persist(k, period) for k in range(20)]


def test_minimal_state_and_wipe_blocks_match_reference():
    rop, rb, rpre = ref_problem(GRID, NBLOCKS)
    ref_st = ref_core.init_state(rop, rpre, rb)
    for _ in range(3):
        ref_st = ref_core.make_step(rop.apply, rpre.apply)(ref_st)
    st = state_from_numpy(ref_state_numpy(ref_st), "cpu", solver="pcg")
    k, beta, p = state.minimal_recovery_state(st)
    rk, rbeta, rp = ref_state.minimal_recovery_state(ref_st)
    assert (k, beta) == (rk, rbeta) and p is st.p
    assert np.array_equal(p.numpy(), np.asarray(rp))
    part = port_problem(GRID, NBLOCKS, np.asarray(rb)).op.partition
    got = state_to_numpy(state.wipe_blocks(st, part, (0, 5)))
    want = ref_state.wipe_blocks(ref_st, rop.partition, (0, 5))
    for f in ("x", "r", "z", "p", "rz"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert np.isnan(got["rz"]) and np.isnan(got["p"][:part.block_size]).all()


def test_reexports_match_reference():
    import repro.nvm as ref_nvm
    import repro.obs as ref_obs
    import repro_torch.nvm as nvm
    import repro_torch.obs as obs
    from repro_torch.solvers import driver

    public = sorted(n for n in dir(ref_core) if not n.startswith("_"))
    assert [n for n in public if not hasattr(core, n)] == []
    assert core.PCGConfig is driver.SolveConfig
    assert core.FailurePlan is driver.FailurePlan
    assert core.pcg.SolveReport is driver.SolveReport
    with pytest.raises(AttributeError):
        core.pcg.NoSuchName  # noqa: B018
    for name in ("TRACE_REPORT_PAIRS", "SHARD_BYTE_PAIRS",
                 "SERVICE_REPORT_PAIRS"):
        assert getattr(obs, name) == getattr(ref_obs, name), name
    assert {t.value: dataclasses.asdict(spec)
            for t, spec in nvm.TIER_SPECS.items()} == {
        t.value: dataclasses.asdict(spec)
        for t, spec in ref_nvm.TIER_SPECS.items()}


def test_legacy_solve_runs_on_a_sharded_problem():
    """``core.solve`` takes a sharded operator too: bitwise the unsharded
    legacy solve, with a 2-block failure."""
    from repro_torch import api

    problem = api.Problem.poisson(8, nblocks=4, device="cpu")
    sharded = problem.with_shards(2)
    bs = problem.op.partition.block_size
    out = []
    for p in (problem, sharded):
        st, rep, _ = core.solve(
            p.op, p.b, p.precond, core.PCGConfig(tol=1e-10),
            backend=core.NVMESRPRD(4, bs, np.float64),
            failures=[core.FailurePlan(at_iteration=5, blocks=(2, 3))])
        out.append((st, rep))
    assert torch.equal(out[0][0].x, out[1][0].x)
    assert out[0][1].iterations == out[1][1].iterations
    assert out[1][1].nshards == 2 and out[1][1].failures_recovered == 1
    assert out[1][1].converged
