"""Sharded solves of the port on a one-device data mesh, against the port's
own unsharded solves and the reference package.

- K1's halo mode (plain version on the CPU): the slabs' outputs side by
  side are bitwise the full stencil, for any shard count dividing ``nz``
  (``nz_s = 1`` included) and every supported dtype.
- The mesh reductions (``make_det_dot`` / ``make_det_rowdots`` with a
  mesh): bitwise the unsharded ones, also where a CPU sum over the rows
  of a matrix would split its work by the row count.
- The reference's sharded sweep run in the port: five solvers x two
  persist modes x four specs at 8^3 (``nblocks=4``, ``nshards=4``,
  ``maxiter=8``; GMRES restarts every 4 steps) with a ``shard=1`` kill.
  The sharded ``x`` and ``r`` are bitwise the port's unsharded run with
  block 1 killed; against the reference's unsharded run ``x`` agrees at
  rtol 1e-8 (the packages sum in different orders) with equal iteration
  counts and counters.
- One ``multi_device`` subprocess runs the reference's sharded solves
  under faked host devices; the port's counters must equal its counters
  exactly and its ``x`` agree at rtol 1e-8 (never bitwise: XLA sums in
  another order, ROADMAP N3).
- The sharded PCG grid steps against the reference's on an in-process
  1-device mesh at float32 tolerance (rtol 1e-4: five float32
  iterations summed in different orders).
- The API's and the mesh's errors raise the reference's exception types.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro import api as ref_api
from repro.core import spmv as ref_spmv
from repro.distributed import sharding as ref_sharding
from repro_torch import api
from repro_torch.core import spmv
from repro_torch.core.poisson import StencilOperator
from repro_torch.distributed import sharding
from repro_torch.kernels import stencil7

SOLVERS = ("pcg", "bicgstab", "gmres", "chebyshev", "jacobi")
MODES = ("sync", "overlap")
SPECS = ("nvm-homogeneous", "nvm-prd", "replicated(nvm-prd x2)",
         "erasure(nvm-prd x4+p)")
#: solver options of the sweep: a short GMRES cycle keeps it quick
OPTIONS = {"gmres": {"m": 4}}
COUNTERS = ("iterations", "converged", "failures_recovered",
            "recovery_restarts", "wasted_iterations", "storage_failures",
            "persist_events", "persist_aborts", "persist_bytes",
            "recovery_fetch_bytes")


# ----------------------------------------------------------------------
# K1's halo mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("grid,nshards", [
    ((8, 8, 8), 2), ((8, 8, 8), 4), ((8, 8, 8), 8),
    ((12, 5, 7), 3), ((12, 5, 7), 12)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_halo_stencil_bitwise_full_stencil(grid, nshards, dtype):
    u = torch.from_numpy(rng_normal(3, *grid)).to(dtype)
    full = stencil7.stencil7_plain(u)
    assert torch.equal(spmv.sharded_stencil7(u, nshards), full)
    # one slab by hand: its halo planes are the neighbours' edge planes
    slab = grid[0] // nshards
    z = slice(slab, 2 * slab)
    hi = u[2 * slab] if nshards > 2 else None
    assert torch.equal(stencil7.stencil7_halo_plain(u[z], u[slab - 1], hi),
                       full[z])


def test_halo_stencil_zero_planes_and_out():
    u = torch.from_numpy(rng_normal(4, 1, 6, 9))
    out = torch.empty_like(u)
    got = stencil7.stencil7_halo_plain(u, None, None, out=out)
    assert got is out and torch.equal(out, stencil7.stencil7_plain(u))
    with pytest.raises(ValueError, match="not divisible"):
        spmv.sharded_stencil7(torch.zeros(6, 2, 2), 4)


def test_sharded_apply_counts_halo_bytes():
    op = StencilOperator(8, 6, 5, nblocks=4, device="cpu")
    sop = sharding.ShardedOperator(op, sharding.ShardLayout(4, 4),
                                   sharding.make_data_mesh(4, "cpu"))
    x = torch.from_numpy(rng_normal(5, op.n))
    assert torch.equal(sop.apply(x), op.apply(x))
    assert sop.halo_bytes == 2 * 3 * 6 * 5 * 8
    # batched input (recovery's dense local solve) is the base's apply
    eye = torch.eye(op.n, dtype=torch.float64)[:3]
    assert torch.equal(sop.apply(eye), op.apply(eye))
    assert sop.halo_bytes == 2 * 3 * 6 * 5 * 8


# ----------------------------------------------------------------------
# The mesh reductions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mesh_dots_bitwise_unsharded(nshards, dtype):
    # 40,000 values a block: a CPU sum over the rows of an (8, 40000)
    # matrix splits its work by the row count, so block sums taken that
    # way would differ between shard counts
    nblocks, n = 8, 8 * 40_000
    a, b = (torch.from_numpy(rng_normal(s, n)).to(dtype) for s in (1, 2))
    mesh = sharding.make_data_mesh(nshards, "cpu")
    want = spmv.make_det_dot(nblocks)(a, b)
    assert torch.equal(spmv.make_det_dot(nblocks, mesh)(a, b), want)
    rows = torch.from_numpy(rng_normal(3, 5, n)).to(dtype)
    want_rows = spmv.make_det_rowdots(nblocks)(rows, b)
    assert torch.equal(spmv.make_det_rowdots(nblocks, mesh)(rows, b),
                       want_rows)
    for i in range(5):
        assert torch.equal(want_rows[i], spmv.make_det_dot(nblocks)(rows[i], b))
    np.testing.assert_allclose(
        float(want), float(ref_spmv.make_det_dot(nblocks)(
            jnp.asarray(a.double().numpy()), jnp.asarray(b.double().numpy()))),
        rtol=1e-12 if dtype == torch.float64 else 1e-4)


# ----------------------------------------------------------------------
# The reference's sharded sweep, in the port
# ----------------------------------------------------------------------
_REF_RUNS = {}


def _ref_unsharded(name, mode, spec):
    key = (name, mode, spec)
    if key not in _REF_RUNS:
        problem = ref_api.Problem.poisson(8, nblocks=4)
        _REF_RUNS[key] = ref_api.solve(
            problem, ref_api.SolverSpec(name, tol=0.0, maxiter=8,
                                        options=OPTIONS.get(name, {})),
            ref_api.ResilienceSpec(spec, persist_mode=mode, period=2),
            failures=[ref_api.FailureEvent(blocks=(1,), at_iteration=4)])
    return _REF_RUNS[key]


def _port_run(problem, name, mode, spec, event, **spec_kw):
    return api.solve(problem, api.SolverSpec(name, tol=0.0, maxiter=8,
                                             options=OPTIONS.get(name, {})),
                     api.ResilienceSpec(spec, persist_mode=mode, period=2,
                                        **spec_kw),
                     failures=[api.FailureEvent(at_iteration=4, **event)])


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SOLVERS)
def test_sharded_sweep_bitwise_unsharded_and_close_to_reference(name, mode,
                                                                spec):
    sharded = api.Problem.poisson(8, nblocks=4, device="cpu", nshards=4)
    assert sharded.nshards == 4 and isinstance(sharded.op,
                                               sharding.ShardedOperator)
    got = _port_run(sharded, name, mode, spec, dict(shard=1), nshards=4)
    plain = _port_run(api.Problem.poisson(8, nblocks=4, device="cpu"),
                      name, mode, spec, dict(blocks=(1,)))
    assert torch.equal(got.state.x, plain.state.x)
    assert torch.equal(got.state.r, plain.state.r)
    rep = got.report
    assert rep.nshards == 4 and rep.failures_recovered == 1
    slot = rep.recovery_fetch_bytes
    assert rep.recovery_fetch_bytes_by_shard == {1: slot}
    assert sum(rep.persist_bytes_by_shard.values()) == rep.persist_bytes
    ref = _ref_unsharded(name, mode, spec)
    for field in COUNTERS:
        assert getattr(rep, field) == getattr(ref.report, field), field
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_fused_erasure_solve_bitwise_unsharded(mode):
    """The fused persist path on a sharded stripe solve: K3 encodes at the
    persist point (as the reference's kernel does there), and the solve
    and its slot bytes are the unsharded fused solve's."""
    spec = "erasure(nvm-prd x4+2p)"
    kw = dict(fused_persist=True)
    got = _port_run(api.Problem.poisson(8, nblocks=4, device="cpu",
                                        nshards=2),
                    "pcg", mode, spec, dict(shard=1), **kw)
    plain = _port_run(api.Problem.poisson(8, nblocks=4, device="cpu"),
                      "pcg", mode, spec, dict(blocks=(2, 3)), **kw)
    assert torch.equal(got.state.x, plain.state.x)
    for field in COUNTERS:
        assert getattr(got.report, field) == getattr(plain.report, field)
    assert got.report.recovery_fetch_bytes_by_shard == {
        1: plain.report.recovery_fetch_bytes}


def test_place_state_pins_contiguous_fields():
    mesh = sharding.make_data_mesh(2, "cpu")
    problem = api.Problem.poisson(8, nblocks=4, device="cpu", nshards=2)
    from repro_torch.solvers.pcg import PCGSolver

    solver = PCGSolver()
    st = solver.init_state(problem.op, problem.precond, problem.b)
    st = st._replace(x=st.x.reshape(2, -1).t().reshape(-1))
    placed = sharding.place_state(st, mesh, solver.state_vector_fields)
    assert placed.k == st.k and torch.equal(placed.x, st.x)
    assert all(getattr(placed, f).is_contiguous()
               for f in placed._fields if f != "k")


# ----------------------------------------------------------------------
# The reference's sharded runs, under faked host devices
# ----------------------------------------------------------------------
_SHARDED_REF = r"""
import json
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro import api

SPECS = ("nvm-homogeneous", "nvm-prd", "replicated(nvm-prd x2)",
         "erasure(nvm-prd x4+p)")
out = {"specs": {}, "scaling": {}}
for spec in SPECS:
    res = api.solve(api.Problem.poisson(8, nblocks=4, nshards=4),
                    api.SolverSpec("pcg", tol=0.0, maxiter=8),
                    api.ResilienceSpec(spec, period=2, nshards=4),
                    failures=[api.FailureEvent(shard=1, at_iteration=4)])
    rep = res.report
    out["specs"][spec] = {
        "nshards": rep.nshards, "failures_recovered": rep.failures_recovered,
        "fetch": rep.metrics.counter_total("recovery.fetch_bytes"),
        "persist_by_shard": rep.persist_bytes_by_shard,
        "fetch_by_shard": rep.recovery_fetch_bytes_by_shard,
        "x": np.asarray(res.x).tolist()}
for nshards in (2, 4, 8):
    res = api.solve(api.Problem.poisson(8, nblocks=8, nshards=nshards),
                    api.SolverSpec("pcg", tol=0.0, maxiter=8),
                    "nvm-homogeneous",
                    failures=[api.FailureEvent(shard=0, at_iteration=4)])
    out["scaling"][nshards] = res.report.metrics.counter_total(
        "recovery.fetch_bytes")
print(json.dumps(out))
"""


@pytest.mark.multi_device
def test_sharded_counters_equal_reference_sharded_runs(multi_device):
    want = multi_device.run(_SHARDED_REF, ndevices=8, timeout=900)
    for spec, ref in want["specs"].items():
        res = api.solve(api.Problem.poisson(8, nblocks=4, device="cpu",
                                            nshards=4),
                        api.SolverSpec("pcg", tol=0.0, maxiter=8),
                        api.ResilienceSpec(spec, period=2, nshards=4),
                        failures=[api.FailureEvent(shard=1, at_iteration=4)])
        rep = res.report
        assert rep.nshards == ref["nshards"] == 4, spec
        assert rep.failures_recovered == ref["failures_recovered"], spec
        assert rep.metrics.counter_total("recovery.fetch_bytes") \
            == ref["fetch"], spec
        assert {str(k): v for k, v in rep.persist_bytes_by_shard.items()} \
            == ref["persist_by_shard"], spec
        assert {str(k): v for k, v in
                rep.recovery_fetch_bytes_by_shard.items()} \
            == ref["fetch_by_shard"], spec
        np.testing.assert_allclose(res.x, np.asarray(ref["x"]), rtol=1e-8,
                                   atol=1e-12, err_msg=spec)
    got = {}
    for nshards in (2, 4, 8):
        res = api.solve(api.Problem.poisson(8, nblocks=8, device="cpu",
                                            nshards=nshards),
                        api.SolverSpec("pcg", tol=0.0, maxiter=8),
                        "nvm-homogeneous",
                        failures=[api.FailureEvent(shard=0, at_iteration=4)])
        got[str(nshards)] = res.report.metrics.counter_total(
            "recovery.fetch_bytes")
    assert got == want["scaling"]
    # halving the shard count doubles the bytes a recovery must move
    assert got["2"] == 2 * got["4"] == 4 * got["8"]


# ----------------------------------------------------------------------
# The sharded PCG grid steps
# ----------------------------------------------------------------------
def _grid_state(nz, ny, nx, seed, esr_mode):
    b = rng_normal(seed, nz, ny, nx, dtype=np.float32)
    z = b * np.float32(1.0 / 6.0)
    state = dict(x=np.zeros_like(b), r=b, z=z, p=z,
                 rz=np.asarray(np.sum(b.astype(np.float64) * z), np.float32))
    if esr_mode == "inmemory":
        state["esr_red_cur"] = z
    return state


@pytest.mark.parametrize("nshards", [1, 4])
@pytest.mark.parametrize("esr_mode", ["nvm", "inmemory"])
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
def test_grid_steps_match_reference(variant, esr_mode, nshards):
    make = {"auto": (spmv.make_sharded_pcg_step,
                     ref_spmv.make_sharded_pcg_step),
            "shardmap": (spmv.make_shardmap_pcg_step,
                         ref_spmv.make_shardmap_pcg_step)}[variant]
    grid = (8, 6, 5)
    step, spec = make[0](sharding.make_data_mesh(nshards, "cpu"),
                         esr_mode=esr_mode)
    ref_step, ref_spec = make[1](ref_sharding.make_data_mesh(1),
                                 esr_mode=esr_mode)
    shardings, structs = spec(*grid)
    ref_shardings, ref_structs = ref_spec(*grid)
    assert set(structs) == set(ref_structs) == set(shardings)
    for f, s in structs.items():
        assert tuple(s.shape) == ref_structs[f].shape, f
        assert str(s.dtype).split(".")[-1] == str(ref_structs[f].dtype), f
    init = _grid_state(*grid, seed=7, esr_mode=esr_mode)
    st = {f: torch.from_numpy(v.copy()) for f, v in init.items()}
    ref_st = {f: jnp.asarray(v) for f, v in init.items()}
    ref_step = jax.jit(ref_step)
    for _ in range(5):
        st = {f: v for f, v in step(st).items() if f in init}
        ref_st = {f: v for f, v in ref_step(ref_st).items() if f in init}
    for f in init:
        want = np.asarray(ref_st[f])
        assert st[f].dtype == torch.float32, f
        np.testing.assert_allclose(st[f].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f)
    host = spmv.nvm_persist_host(st)
    assert host.shape == (int(np.prod(grid)),)
    assert np.array_equal(host, st["p"].reshape(-1).numpy())


# ----------------------------------------------------------------------
# Errors: the reference's types (and messages where both are the port's
# own text)
# ----------------------------------------------------------------------
def _error(fn):
    try:
        fn()
    except Exception as e:  # the two packages' exceptions, compared
        return type(e).__name__, str(e)
    return None


def test_api_errors_match_reference():
    cases = {
        "with_shards twice": (
            lambda: api.Problem.poisson(8, nblocks=4, device="cpu")
            .with_shards(1).with_shards(1),
            lambda: ref_api.Problem.poisson(8, nblocks=4)
            .with_shards(1).with_shards(1)),
        "nshards mismatch": (
            lambda: api.solve(api.Problem.poisson(8, nblocks=4, device="cpu"),
                              "pcg", api.ResilienceSpec("nvm-prd", nshards=2)),
            lambda: ref_api.solve(ref_api.Problem.poisson(8, nblocks=4),
                                  "pcg",
                                  ref_api.ResilienceSpec("nvm-prd",
                                                         nshards=2))),
        "shard kill unsharded": (
            lambda: api.solve(api.Problem.poisson(8, nblocks=4, device="cpu"),
                              "pcg", "nvm-prd",
                              failures=[api.FailureEvent(shard=1,
                                                         at_iteration=3)]),
            lambda: ref_api.solve(ref_api.Problem.poisson(8, nblocks=4),
                                  "pcg", "nvm-prd",
                                  failures=[ref_api.FailureEvent(
                                      shard=1, at_iteration=3)])),
    }
    for what, (port_fn, ref_fn) in cases.items():
        got, want = _error(port_fn), _error(ref_fn)
        assert got is not None and want is not None, what
        assert got[0] == want[0], (what, got, want)
        if what != "shard kill unsharded":
            assert got[1] == want[1], what
    assert "Problem.with_shards" in _error(cases["shard kill unsharded"][0])[1]


def test_sharded_operator_errors_match_reference():
    op = StencilOperator(8, 8, 8, nblocks=4, device="cpu")
    from repro.core.poisson import StencilOperator as RefStencil

    ref_op = RefStencil(8, 8, 8, nblocks=4)
    mesh, ref_mesh = sharding.make_data_mesh(1, "cpu"), \
        ref_sharding.make_data_mesh(1)
    for layout in ((4, 2), (2, 1)):
        got = _error(lambda: sharding.ShardedOperator(
            op, sharding.ShardLayout(*layout), mesh))
        want = _error(lambda: ref_sharding.ShardedOperator(
            ref_op, ref_sharding.ShardLayout(*layout), ref_mesh))
        assert got is not None and got == want, layout
    # shards on distinct cards wait for a machine with more than one
    with pytest.raises(NotImplementedError, match="more than one card"):
        sharding.DataMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError):
        sharding.make_data_mesh(0, "cpu")
    # a sharded problem is refused by the service, as in the reference
    from repro_torch.serving import ServiceConfig, ServiceError, SolveService

    svc = SolveService(ServiceConfig(lanes=2, device="cpu"))
    with pytest.raises(ServiceError, match="unsharded problem"):
        svc.submit(api.Problem.poisson(8, nblocks=4, device="cpu",
                                       nshards=2), "pcg")
