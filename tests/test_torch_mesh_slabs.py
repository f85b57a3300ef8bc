"""Sharded vectors of the port's data mesh on the CPU: one slab a shard,
each a tensor of its own on its shard's device (``cpu`` repeated, where
the same moves, streams-that-are-none and gathers run as on the card).

- Every vector of a sharded solve's state is a ``ShardedVector`` whose
  slabs are separate tensors on their shards' devices, after the first
  step and after a recovery.
- An op the type does not list raises ``NotImplementedError`` naming
  it; an index range inside one shard is that slab's piece; a move is a
  copy, never an alias.
- The five solvers' sharded solves with a ``shard=1`` kill under the
  reference's sweep are bitwise the unsharded runs (``x``, ``r`` and
  the residual history), and their counters equal the reference's own
  sharded runs (one ``multi_device`` subprocess).
- The stencil's ``inblock_apply`` (K1's halo mode, zero halo planes, on
  each run of failed blocks) and ``offblock_apply`` (a zero slab with the
  true neighbour planes) are bitwise the versions that embed into the
  whole grid: a run at either end of the domain, two non-adjacent runs,
  blocks out of order, float64 and float32; on sharded vectors too.
- Block Jacobi on a mesh (its factors placed on their shards) is bitwise
  the unsharded preconditioner.
"""
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro_torch import api
from repro_torch.core import reconstruction as rec
from repro_torch.core.poisson import (
    BlockJacobiPreconditioner,
    StencilOperator,
)
from repro_torch.distributed import sharding

SOLVERS = ("pcg", "bicgstab", "gmres", "chebyshev", "jacobi")
MODES = ("sync", "overlap")
#: the reference's sweep (tests/test_torch_mesh.py), one spec of each
#: kind of session
SPECS = ("nvm-prd", "erasure(nvm-prd x4+p)")
OPTIONS = {"gmres": {"m": 4}}
COUNTERS = ("iterations", "converged", "failures_recovered",
            "recovery_restarts", "wasted_iterations", "storage_failures",
            "persist_events", "persist_aborts", "persist_bytes",
            "recovery_fetch_bytes", "nshards")


def _solve(problem, name, mode, spec, event):
    return api.solve(problem, api.SolverSpec(name, tol=0.0, maxiter=8,
                                             options=OPTIONS.get(name, {})),
                     api.ResilienceSpec(spec, persist_mode=mode, period=2),
                     failures=[api.FailureEvent(at_iteration=4, **event)],
                     capture_states_at=(1, 4))


def _sharded(nshards=4, **kw):
    return api.Problem.poisson(8, nblocks=4, device="cpu", nshards=nshards,
                               **kw)


# ----------------------------------------------------------------------
# Slabs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", SOLVERS)
def test_every_slab_is_its_own_tensor_on_its_shard(name):
    res = _solve(_sharded(), name, "sync", "nvm-prd", dict(shard=1))
    solver = api.SolverSpec(name).build(_sharded())
    mesh = res.state.x.mesh
    assert mesh.devices == (torch.device("cpu"),) * 4
    storages = set()
    # the state after the first step, at the failure (recovered) and at
    # the end
    for st in (res.captured[1], res.captured[4], res.state):
        for f in solver.state_vector_fields:
            v = getattr(st, f)
            assert isinstance(v, sharding.ShardedVector), f
            assert len(v.slabs) == 4
            for s, slab in enumerate(v.slabs):
                assert slab.device == mesh.devices[s] and slab.dim() == 1
                assert slab.numel() == v.shape[0] // 4
            storages.update(slab.untyped_storage().data_ptr()
                            for slab in v.slabs)
            assert len({slab.untyped_storage().data_ptr()
                        for slab in v.slabs}) == 4, f
    assert len(storages) >= 4 * len(solver.state_vector_fields)


_UNLISTED = {
    "torch.equal": lambda v: torch.equal(v, v),
    "sum": lambda v: v.sum(),
    "torch.dot": lambda v: torch.dot(v, v),
    "reshape to a matrix": lambda v: v.reshape(4, -1),
    "an element": lambda v: v[3],
    "a range across shards": lambda v: v[100:300],
    "torch.cat": lambda v: torch.cat([v, v]),
    "in-place add": lambda v: v.add_(1.0),
    "a full-length plain operand": lambda v: v * torch.ones(v.shape[0],
                                                            dtype=v.dtype),
    "a comparison": lambda v: v > 0,
}


@pytest.mark.parametrize("what", sorted(_UNLISTED))
def test_an_unlisted_op_raises(what):
    v = _sharded().b
    with pytest.raises(NotImplementedError):
        _UNLISTED[what](v)


def test_listed_ops_run_slab_by_slab():
    problem = _sharded()
    v = problem.b
    full = sharding.gather(v)
    alpha = torch.tensor(0.25, dtype=torch.float64)
    cases = {
        "axpy": (v + alpha * v - 0.5 * v / alpha,
                 full + alpha * full - 0.5 * full / alpha),
        "neg": (-v, -full),
        "zeros_like": (torch.zeros_like(v), torch.zeros_like(full)),
        "to float32": (v.to(torch.float32), full.to(torch.float32)),
        "clone": (v.clone(), full.clone()),
    }
    for what, (got, want) in cases.items():
        assert isinstance(got, sharding.ShardedVector), what
        assert torch.equal(sharding.gather(got), want), what
    into = torch.empty_like(v)
    assert into.copy_(v) is into and torch.equal(sharding.gather(into), full)
    assert torch.equal(sharding.gather(v.reshape(-1)), full)
    # a block range inside one shard is that slab's piece
    bs = problem.op.partition.block_size
    piece = v[2 * bs + 3:3 * bs]
    assert not isinstance(piece, sharding.ShardedVector)
    assert piece.data_ptr() == v.slabs[2][3:].data_ptr()
    assert torch.equal(piece, full[2 * bs + 3:3 * bs])
    assert "ShardedVector(n=512" in repr(v)


def test_move_is_a_copy_and_gather_the_one_gather():
    mesh = sharding.make_data_mesh(2, "cpu")
    t = torch.arange(6, dtype=torch.float64)
    moved = mesh.move(t, 1)
    assert torch.equal(moved, t) and moved.data_ptr() != t.data_ptr()
    out = torch.empty(6, dtype=torch.float64)
    assert mesh.move(t, None, src=0, out=out) is out
    v = mesh.place(t)
    assert [s.tolist() for s in v.slabs] == [[0, 1, 2], [3, 4, 5]]
    assert torch.equal(sharding.gather(v), t)
    assert sharding.gather(t) is t
    assert np.array_equal(sharding.to_host(v), t.numpy())
    assert mesh.stream(0) is None and not mesh.distinct
    with pytest.raises(ValueError, match="split"):
        mesh.place(torch.zeros(5))
    other = sharding.make_data_mesh(3, "cpu").place(torch.zeros(6))
    with pytest.raises(ValueError, match="different meshes"):
        v + other


# ----------------------------------------------------------------------
# Sharded solves: bitwise the unsharded ones, the reference's counters
# ----------------------------------------------------------------------
_PORT_RUNS = {}


def _port_runs(name, mode, spec):
    key = (name, mode, spec)
    if key not in _PORT_RUNS:
        _PORT_RUNS[key] = (
            _solve(_sharded(), name, mode, spec, dict(shard=1)),
            _solve(api.Problem.poisson(8, nblocks=4, device="cpu"), name,
                   mode, spec, dict(blocks=(1,))))
    return _PORT_RUNS[key]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SOLVERS)
def test_sharded_solve_and_recovery_bitwise_unsharded(name, mode, spec):
    got, plain = _port_runs(name, mode, spec)
    assert torch.equal(sharding.gather(got.state.x), plain.state.x)
    assert torch.equal(sharding.gather(got.state.r), plain.state.r)
    assert got.report.residual_history == plain.report.residual_history
    assert got.report.final_relres == plain.report.final_relres
    assert np.array_equal(got.x, plain.x)
    assert got.report.recovery_fetch_bytes_by_shard == {
        1: plain.report.recovery_fetch_bytes}


_REF_SHARDED = r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
from repro import api

SOLVERS = ("pcg", "bicgstab", "gmres", "chebyshev", "jacobi")
COUNTERS = ("iterations", "converged", "failures_recovered",
            "recovery_restarts", "wasted_iterations", "storage_failures",
            "persist_events", "persist_aborts", "persist_bytes",
            "recovery_fetch_bytes", "nshards")
out = []
for name in SOLVERS:
    for mode in ("sync", "overlap"):
        for spec in ("nvm-prd", "erasure(nvm-prd x4+p)"):
            res = api.solve(
                api.Problem.poisson(8, nblocks=4, nshards=4),
                api.SolverSpec(name, tol=0.0, maxiter=8,
                               options={"m": 4} if name == "gmres" else {}),
                api.ResilienceSpec(spec, persist_mode=mode, period=2),
                failures=[api.FailureEvent(shard=1, at_iteration=4)])
            rep = res.report
            row = {f: getattr(rep, f) for f in COUNTERS}
            row["persist_by_shard"] = {
                str(k): v for k, v in rep.persist_bytes_by_shard.items()}
            row["fetch_by_shard"] = {
                str(k): v for k, v in rep.recovery_fetch_bytes_by_shard.items()}
            out.append([name, mode, spec, row])
print(json.dumps(out))
"""


@pytest.mark.multi_device
def test_sharded_counters_equal_the_reference_sharded_runs(multi_device):
    want = multi_device.run(_REF_SHARDED, ndevices=4, timeout=900)
    assert len(want) == len(SOLVERS) * len(MODES) * len(SPECS)
    for name, mode, spec, ref in want:
        rep = _port_runs(name, mode, spec)[0].report
        for field in COUNTERS:
            assert getattr(rep, field) == ref[field], (name, mode, spec, field)
        assert {str(k): v for k, v in rep.persist_bytes_by_shard.items()} \
            == ref["persist_by_shard"], (name, mode, spec)
        assert {str(k): v for k, v in
                rep.recovery_fetch_bytes_by_shard.items()} \
            == ref["fetch_by_shard"], (name, mode, spec)


# ----------------------------------------------------------------------
# Recovery on the failed slabs alone
# ----------------------------------------------------------------------
BLOCK_CASES = {"run at the low end": (0, 1), "run at the high end": (6, 7),
               "two runs": (1, 2, 5), "out of order": (5, 1, 2),
               "every block": tuple(range(8))}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_failed_slab_restrictions_bitwise_embed(case, dtype):
    blocks = BLOCK_CASES[case]
    op = StencilOperator(32, 6, 5, nblocks=8, dtype=dtype, device="cpu")
    part = op.partition
    x = torch.from_numpy(rng_normal(1, op.n)).to(dtype)
    v = torch.from_numpy(rng_normal(2, len(blocks) * part.block_size)).to(
        dtype)
    want_in = part.restrict(op.apply(part.embed(v, blocks)), blocks)
    want_off = part.restrict(op.apply(part.zero_blocks(x, blocks)), blocks)
    assert torch.equal(op.inblock_apply(v, blocks), want_in)
    assert torch.equal(op.offblock_apply(x, blocks), want_off)
    # a batch of vectors (the dense local solve's identity columns)
    eye = torch.eye(v.shape[0], dtype=dtype)[:7]
    assert torch.equal(op.inblock_apply(eye, blocks),
                       part.restrict(op.apply(part.embed(eye, blocks)),
                                     blocks))
    # a sharded x: the neighbour planes move from their shards
    sop = sharding.ShardedOperator(op, sharding.ShardLayout(8, 4),
                                   sharding.make_data_mesh(4, "cpu"))
    xs = sop.device_put(x)
    assert torch.equal(sop.offblock_apply(xs, blocks), want_off)
    assert torch.equal(sop.partition.restrict(xs, blocks),
                       part.restrict(x, blocks))
    assert torch.equal(
        sharding.gather(sop.partition.scatter(xs, v, blocks)),
        part.scatter(x, v, blocks))
    assert torch.equal(
        sharding.gather(sop.partition.fill_blocks(xs, blocks, 0.0)),
        part.zero_blocks(x, blocks))


def test_local_cg_on_the_failed_slabs_is_the_embed_loop():
    op = StencilOperator(16, 6, 5, nblocks=8, device="cpu")
    part, failed = op.partition, [1, 2, 5]
    rhs = torch.from_numpy(rng_normal(3, 3 * part.block_size))
    info, embed_info = {}, {}
    got = rec._local_cg_plain(lambda u: op.inblock_apply(u, failed), rhs,
                              info=info)
    want = rec._local_cg_plain(lambda u: part.restrict(
        op.apply(part.embed(u, failed)), failed), rhs, info=embed_info)
    assert info["iterations"] == embed_info["iterations"] > 0
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one vector"):
        op.offblock_apply(torch.zeros(2, op.n), failed)


def test_block_jacobi_on_a_mesh_bitwise_unsharded():
    plain = api.Problem.poisson(8, nblocks=4, device="cpu",
                                preconditioner="block_jacobi")
    sharded = plain.with_shards(2)
    pre = sharded.precond
    assert isinstance(pre, BlockJacobiPreconditioner)
    assert sharding.base_preconditioner(pre) is plain.precond
    r = torch.from_numpy(rng_normal(4, plain.op.n))
    got = pre.apply(sharded.op.device_put(r))
    assert torch.equal(sharding.gather(got), plain.precond.apply(r))
    # plain vectors still take the placed preconditioner
    assert torch.equal(pre.apply(r), plain.precond.apply(r))
    runs = [api.solve(p, api.SolverSpec("pcg", tol=0.0, maxiter=6),
                      api.ResilienceSpec("nvm-prd", period=2),
                      failures=[api.FailureEvent(at_iteration=3, **ev)])
            for p, ev in ((sharded, dict(shard=1)),
                          (plain, dict(blocks=(2, 3))))]
    assert torch.equal(sharding.gather(runs[0].state.x), runs[1].state.x)
