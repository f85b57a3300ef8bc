"""The port's deprecated pre-zoo shims, against the reference's
(tests/test_deprecation_shims.py's contracts, on ``repro_torch``).

1. the PCG-only ``backend.persist(k, beta, p_full)`` /
   ``backend.recover(blocks, k)`` methods of the three core backends warn
   and route through the schema codec — and a slot written through them
   is the reference's slot byte for byte, so each package decodes the
   other's;
2. ``BACKENDS[name](...)`` construction warns, while sweeping the names
   stays silent;
3. an external pre-zoo duck-typed backend routes through
   :class:`~repro_torch.nvm.backend.LegacyBackendSession` (overlap from
   the RAM front, the stale-pair refusal, dark after storage loss, PCG
   payloads only), and the driver solves through it like the reference.
"""
import warnings

import numpy as np
import pytest

from repro.core import nvm_esr as ref_nvm_esr
from repro.core.state import PCG_SCHEMA as REF_PCG_SCHEMA
from repro.core.state import decode_payload as ref_decode_payload
from repro_torch.core import nvm_esr
from repro_torch.core.state import PCG_SCHEMA, RecoveryPayload
from repro_torch.nvm.backend import LegacyBackendSession, open_persist_session
from repro_torch.solvers import BACKENDS, FailurePlan, SolveConfig, make_solver
from repro_torch.solvers import solve
from repro_torch.solvers.gmres import GMRES_SCHEMA

NBLOCKS, BLOCK = 4, 8


class _OldStyle:
    """Minimal pre-zoo external backend: full-vector slots keyed by
    iteration, PCG payloads only."""

    def __init__(self, block_size=BLOCK):
        self.block_size = block_size
        self.slots = {}
        self.failed = []

    def persist(self, k, beta, p_full):
        self.slots[k] = (beta, np.asarray(p_full).copy())
        return 0.125

    def fail(self, blocks):
        self.failed.append(tuple(blocks))

    def recover(self, blocks, k):
        def payload(kk):
            beta, p = self.slots[kk]
            shards = [p[b * self.block_size:(b + 1) * self.block_size]
                      for b in blocks]
            return RecoveryPayload(kk, beta, np.concatenate(shards))
        return payload(k - 1), payload(k)


def _raw_slots(be):
    """Every slot payload a core backend holds, in a fixed order."""
    if hasattr(be, "pools"):                      # nvm-homogeneous
        return [pool.read(f"slot{s}") for pool in be.pools
                for s in range(be.slots)]
    if hasattr(be, "ram"):                        # esr
        return [payload for host in be.ram
                for _, payload in sorted(host.items())]
    return [payload for rank in range(be.nblocks * be.vranks)   # nvm-prd
            for _, payload in be.prd.scan_rank(rank)]


# ---------------------------------------------------------------- shim 1
def test_legacy_persist_recover_warn_and_stay_wire_compatible():
    be = nvm_esr.NVMESRHomogeneous(NBLOCKS, BLOCK, np.float64)
    p0 = np.arange(32, dtype=np.float64)
    p1 = p0 + 1.0
    with pytest.warns(DeprecationWarning, match="deprecated PCG-only"):
        be.persist(0, 0.0, p0)
    be.persist_set(1, {"beta": 0.25}, {"p": p1})  # modern path, no warning
    with pytest.warns(DeprecationWarning, match="deprecated PCG-only"):
        prev, cur = be.recover([1, 2], 1)
    assert prev.k == 0 and cur.k == 1 and cur.beta == 0.25
    np.testing.assert_array_equal(prev.p, p0[8:24])
    np.testing.assert_array_equal(cur.p, p1[8:24])
    # the same slots serve the modern protocol: one ring, one format
    sets = be.recover_set([1, 2], (0, 1))
    assert [s.k for s in sets] == [0, 1]
    np.testing.assert_array_equal(sets[-1].vectors["p"], p1[8:24])


@pytest.mark.parametrize("name", ["esr", "nvm-homogeneous", "nvm-prd"])
def test_legacy_slots_are_the_reference_bytes_both_ways(name):
    """The same legacy persists through both packages' backends leave the
    same slot bytes; each package decodes the other's slots, and the
    legacy recover answers alike."""
    rng = np.random.default_rng(3)
    events = [(k, float(rng.standard_normal()),
               rng.standard_normal(NBLOCKS * BLOCK)) for k in range(4)]
    backends = []
    for table in (nvm_esr.BACKENDS, ref_nvm_esr.BACKENDS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            be = table[name](NBLOCKS, BLOCK, np.float64)
            for k, beta, p in events:
                be.persist(k, beta, p)
        backends.append(be)
    port, ref = backends
    port_raw, ref_raw = _raw_slots(port), _raw_slots(ref)
    assert port_raw and port_raw == ref_raw
    for raw in port_raw:
        got = ref_decode_payload(raw, np.float64)
        want = PCG_SCHEMA.decode(raw, np.float64)
        assert got.k == want.k and got.beta == want.scalars["beta"]
        np.testing.assert_array_equal(got.p, want.vectors["p"])
    for raw in ref_raw:
        got = PCG_SCHEMA.decode(raw, np.float64)
        want = REF_PCG_SCHEMA.decode(raw, np.float64)
        assert (got.k, got.scalars) == (want.k, want.scalars)
        np.testing.assert_array_equal(got.vectors["p"], want.vectors["p"])
    with pytest.warns(DeprecationWarning, match="deprecated PCG-only"):
        got = port.recover([1, 3], 3)
    with pytest.warns(DeprecationWarning):
        want = ref.recover([1, 3], 3)
    for g, w in zip(got, want):
        assert (g.k, g.beta) == (w.k, w.beta)
        np.testing.assert_array_equal(g.p, w.p)


@pytest.mark.parametrize("api_name,call", [
    ("persist", lambda be: be.persist(0, 0.0, np.zeros(NBLOCKS * BLOCK))),
    ("recover", lambda be: be.recover([0], 1)),
])
def test_legacy_api_refuses_non_pcg_schemas(api_name, call):
    from repro_torch.solvers.jacobi import JACOBI_SCHEMA

    be = nvm_esr.NVMESRPRD(NBLOCKS, BLOCK, np.float64, schema=JACOBI_SCHEMA)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(TypeError, match=f"legacy {api_name}\\(\\) API "
                                            f"carries PCG payloads only"):
            call(be)


# ---------------------------------------------------------------- shim 2
def test_backends_table_construction_warns_and_routes():
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # sweeping must NOT warn
        names = sorted(BACKENDS)
        assert names == ["esr", "nvm-homogeneous", "nvm-prd"]
        assert names == sorted(ref_nvm_esr.BACKENDS)
        assert "nvm-prd" in BACKENDS and len(BACKENDS) == 3
        ctor = BACKENDS["nvm-homogeneous"]  # lookup alone must not warn

    with pytest.warns(DeprecationWarning,
                      match="BACKENDS\\['nvm-homogeneous'\\]"):
        be = ctor(NBLOCKS, BLOCK, np.float64)
    assert isinstance(be, nvm_esr.NVMESRHomogeneous)
    assert be.capabilities.durability == "nvm"
    be.persist_set(0, {"beta": 0.0}, {"p": np.zeros(32)})
    be.persist_set(1, {"beta": 0.5}, {"p": np.ones(32)})
    (got,) = be.recover_set([0], (1,))
    np.testing.assert_array_equal(got.vectors["p"], np.ones(8))


# ------------------------------------------------- external duck-typed
def test_external_legacy_backend_round_trip_through_session():
    be = _OldStyle()
    with pytest.warns(DeprecationWarning, match="duck-typed legacy"):
        session = open_persist_session(be, PCG_SCHEMA)
    assert isinstance(session, LegacyBackendSession)

    p0 = np.arange(32, dtype=np.float64)
    p1 = p0 + 100.0
    assert session.persist(0, {"beta": 0.0}, {"p": p0}) == 0.125
    assert session.persist(1, {"beta": 0.25}, {"p": p1}) == 0.125

    sets = session.fetch([1, 2], (0, 1))
    assert [s.k for s in sets] == [0, 1]
    assert sets[-1].scalars["beta"] == 0.25
    np.testing.assert_array_equal(sets[0].vectors["p"], p0[8:24])
    np.testing.assert_array_equal(sets[-1].vectors["p"], p1[8:24])

    session.fail((1, 2))
    assert be.failed == [(1, 2)]


def test_external_legacy_backend_overlap_via_ram_front():
    be = _OldStyle()
    with pytest.warns(DeprecationWarning):
        session = open_persist_session(be, PCG_SCHEMA)
    c = session.begin(0, {"beta": 0.5}, {"p": np.arange(32.0)})
    assert c > 0.0 and 0 not in be.slots      # staged, not yet durable
    assert session.commit() == 0.125 and 0 in be.slots
    session.begin(1, {"beta": 0.25}, {"p": np.arange(32.0) + 1})
    session.abort()
    assert session.drain() == 0.0 and 1 not in be.slots  # aborted event died


def test_legacy_session_goes_dark_after_storage_loss():
    be = _OldStyle()
    with pytest.warns(DeprecationWarning):
        session = open_persist_session(be, PCG_SCHEMA)
    session.persist(0, {"beta": 0.0}, {"p": np.zeros(32)})
    session.fail_storage()
    assert session.persist(1, {"beta": 0.1}, {"p": np.ones(32)}) == 0.0
    assert session.begin(2, {"beta": 0.2}, {"p": np.ones(32)}) == 0.0
    assert session.commit() == 0.0 and session.drain() == 0.0
    assert set(be.slots) == {0}  # nothing reached the dead backend
    with pytest.raises(Exception, match="PRD"):
        session.fetch([1], (0, 1))


def test_stale_pair_refused():
    class StaleBackend(_OldStyle):
        def recover(self, blocks, k):
            prev, cur = super().recover(blocks, k)
            return prev._replace(k=prev.k - 1), cur  # off-by-one pair

    with pytest.warns(DeprecationWarning):
        session = open_persist_session(StaleBackend(), PCG_SCHEMA)
    session.persist(4, {"beta": 0.0}, {"p": np.zeros(32)})
    session.persist(5, {"beta": 0.5}, {"p": np.ones(32)})
    with pytest.raises(RuntimeError, match="legacy backend .* returned"):
        session.fetch([0], (4, 5))


def test_non_pcg_schema_rejected():
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="legacy"):
            open_persist_session(_OldStyle(), GMRES_SCHEMA)


def test_driver_routes_legacy_backend_like_the_reference():
    """solve() normalizes external legacy backends through the session
    shim with exactly the deprecation warning; the recovered run equals
    the reference's through its own shim (rtol 1e-9: the two sum their
    stencil rows and dots in different orders)."""
    import jax.numpy as jnp

    from _torch_port import port_problem, ref_problem
    from repro.solvers import FailurePlan as RefFailurePlan
    from repro.solvers import SolveConfig as RefSolveConfig
    from repro.solvers import make_solver as ref_make_solver
    from repro.solvers import solve as ref_solve

    grid, nblocks = (8, 8, 8), 4
    rop, rb, rpre = ref_problem(grid, nblocks)
    problem = port_problem(grid, nblocks, np.asarray(rb))
    op, b, pre = problem.op, problem.b, problem.precond
    be = _OldStyle(op.partition.block_size)
    with pytest.warns(DeprecationWarning, match="duck-typed legacy"):
        state, rep, _ = solve(make_solver("pcg", op, pre), op, b, pre,
                              SolveConfig(tol=1e-10), backend=be,
                              failures=[FailurePlan(10, (1, 2))])
    assert rep.converged and rep.failures_recovered == 1
    assert be.slots  # persisted through the shim
    ref_be = _OldStyle(rop.partition.block_size)
    with pytest.warns(DeprecationWarning):
        ref_state, ref_rep, _ = ref_solve(
            ref_make_solver("pcg", rop, rpre), rop, jnp.asarray(rb), rpre,
            RefSolveConfig(tol=1e-10), backend=ref_be,
            failures=[RefFailurePlan(10, (1, 2))])
    assert (rep.iterations, rep.failures_recovered, rep.wasted_iterations) \
        == (ref_rep.iterations, ref_rep.failures_recovered,
            ref_rep.wasted_iterations)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(ref_state.x),
                               rtol=1e-9, atol=1e-12)
