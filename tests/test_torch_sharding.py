"""The port's logical shard layout against the reference's.

``ShardLayout`` (block ownership, its errors), ``resolve_shard_events``
(the block sets a ``shard=`` event resolves to, and the refusals),
``plan_campaign(..., layout=...)`` and a ``PersistencePipeline`` bound to
a declared layout (per-shard persist and fetch bytes under the layout's
labels) give the reference's answers exactly: all of it is integer
bookkeeping.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import port_problem, ref_problem
from repro.distributed.sharding import ShardLayout as RefShardLayout
from repro.nvm.backend import BackendCapabilities as RefCapabilities
from repro.solvers import driver as ref_driver
from repro_torch.distributed import ShardLayout
from repro_torch.nvm.backend import BackendCapabilities
from repro_torch.solvers import driver
from repro_torch.solvers.pcg import PCGSolver
from repro_torch.solvers.registry import make_backend

LAYOUTS = ((8, 1), (8, 2), (8, 4), (8, 8), (6, 3), (5, 5))


@pytest.mark.parametrize("nblocks,nshards", LAYOUTS)
def test_layout_matches_reference(nblocks, nshards):
    got, want = ShardLayout(nblocks, nshards), RefShardLayout(nblocks, nshards)
    assert got.blocks_per_shard == want.blocks_per_shard
    assert got.shard_of_block_map() == want.shard_of_block_map()
    for s in range(nshards):
        assert got.blocks_of(s) == want.blocks_of(s)


def _error(fn):
    try:
        fn()
    except Exception as e:  # the two packages' exceptions, compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("make", [
    lambda L: L(8, 0), lambda L: L(4, 8), lambda L: L(8, 3),
    lambda L: L(8, 2).blocks_of(2), lambda L: L(8, 2).blocks_of(-1),
    lambda L: L(8, 2).shard_of_block(8),
], ids=["no shards", "more shards than blocks", "not divisible",
        "shard past the end", "negative shard", "block past the end"])
def test_layout_errors_match_reference(make):
    got = _error(lambda: make(ShardLayout))
    assert got is not None and got == _error(lambda: make(RefShardLayout))


def _campaigns(mod, nshards):
    ev = mod.FailureEvent
    return [
        [ev(shard=1, at_iteration=5)],
        [ev(blocks=(0,), shard=nshards - 1, at_iteration=4, prd=True)],
        mod.FailureCampaign((ev(shard=0, at_iteration=6),
                             ev(shard=nshards - 1, during_recovery_at=6),
                             ev(blocks=(7,), at_iteration=9))),
        [ev(blocks=(2, 3), at_iteration=3)],
    ]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("nshards", [2, 4])
def test_resolve_shard_events_matches_reference(case, nshards):
    got = driver.resolve_shard_events(_campaigns(driver, nshards)[case],
                                      ShardLayout(8, nshards))
    want = ref_driver.resolve_shard_events(
        _campaigns(ref_driver, nshards)[case], RefShardLayout(8, nshards))
    assert [(e.blocks, e.at_iteration, e.during_recovery_at, e.prd, e.shard)
            for e in got.events] == [
        (e.blocks, e.at_iteration, e.during_recovery_at, e.prd, e.shard)
        for e in want.events]


def test_resolve_shard_events_refusals_match_reference():
    for mod, layout in ((driver, ShardLayout), (ref_driver, RefShardLayout)):
        ev = mod.FailureEvent(shard=1, at_iteration=3)
        with pytest.raises(ValueError, match="needs a sharded solve"):
            mod.resolve_shard_events([ev], None)
        with pytest.raises(ValueError, match="out of range for nshards=1"):
            mod.resolve_shard_events([ev], layout(4, 1))
    # block-only campaigns pass through untouched without a layout
    plain = [driver.FailureEvent(blocks=(1,), at_iteration=2)]
    assert driver.resolve_shard_events(plain).events == tuple(plain)


@pytest.mark.parametrize("max_blocks,max_storage", [(None, 1), (2, 1),
                                                  (3, 1), (None, 0)])
def test_plan_with_layout_matches_reference(max_blocks, max_storage):
    """The same shard campaign planned against the same capabilities:
    the same recoveries, or the same rejection message."""
    kw = dict(durability="nvm", survives_node_loss=True,
              survives_prd_loss=max_storage > 0, overlap="native",
              max_block_failures=max_blocks,
              max_storage_failures=max_storage)
    campaign = lambda mod: mod.FailureCampaign((  # noqa: E731
        mod.FailureEvent(shard=1, at_iteration=5, prd=True),
        mod.FailureEvent(blocks=(0,), at_iteration=8)))
    layouts = (ShardLayout(8, 4), RefShardLayout(8, 4))
    results = []
    for mod, caps, layout in ((driver, BackendCapabilities(**kw), layouts[0]),
                              (ref_driver, RefCapabilities(**kw),
                               layouts[1])):
        try:
            results.append(mod.plan_campaign(campaign(mod), caps,
                                             layout=layout))
        except mod.UnsurvivableCampaignError as e:
            results.append(str(e))
    got, want = results
    if isinstance(want, str):
        assert got == want
    else:
        assert got.recoveries == tuple(
            driver.PlannedRecovery(r.at_iteration, r.blocks,
                                   r.storage_losses, r.restarts)
            for r in want.recoveries)
        assert got.storage_losses == want.storage_losses


@pytest.mark.parametrize("nshards", [1, 2, 4])
def test_pipeline_meters_bytes_under_the_declared_layout(nshards):
    """A pipeline bound to a declared layout persists twice, loses shard
    1's blocks (or block 1) and recovers; its per-shard bytes equal the
    reference pipeline's on the same inputs."""
    grid, nblocks = (8, 8, 8), 4
    rop, rb, rpre = ref_problem(grid, nblocks)
    problem = port_problem(grid, nblocks, np.asarray(rb))
    event = dict(shard=1) if nshards > 1 else dict(blocks=(1,))
    reports = []
    for mod, op, b, pre, layout in (
            (driver, problem.op, problem.b, problem.precond,
             ShardLayout(nblocks, nshards)),
            (ref_driver, rop, jnp.asarray(rb), rpre,
             RefShardLayout(nblocks, nshards))):
        if mod is driver:
            solver = PCGSolver()
            backend = make_backend("nvm-prd", op, solver=solver)
        else:
            from repro.solvers.pcg import PCGSolver as RefPCG
            from repro.solvers.registry import make_backend as ref_make

            solver = RefPCG()
            backend = ref_make("nvm-prd", op, solver=solver)
        pipe = mod.PersistencePipeline(
            solver, op, pre, b, mod.SolveConfig(), backend,
            [mod.FailureEvent(at_iteration=2, **event)], layout=layout)
        st = solver.init_state(op, pre, b)
        step = solver.make_step(op, pre)
        pipe.persist_point(st)
        for _ in range(2):
            st = step(st)
            pipe.persist_point(st)
        st = pipe.inject(pipe.pop_event(2), st, 2)
        report = mod.SolveReport(metrics=pipe.metrics)
        pipe.finalize(report, st, 1.0)
        reports.append(report)
    got, want = reports
    assert got.nshards == want.nshards == nshards
    assert got.persist_bytes_by_shard == want.persist_bytes_by_shard
    assert (got.recovery_fetch_bytes_by_shard
            == want.recovery_fetch_bytes_by_shard)
    assert set(got.persist_bytes_by_shard) == set(range(nshards))
    assert got.failures_recovered == want.failures_recovered == 1
