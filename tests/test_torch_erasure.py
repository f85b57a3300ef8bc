"""The erasure slice of the port against the JAX package: GF(2^8)
arithmetic, the plain versions of kernels K3 (parity encode) and K4
(fused update + stripe staging), the stripe's slot bytes, and whole
erasure-coded solves.

Inputs are made with numpy from a seed and handed to both packages.
The reference's Pallas kernels run as its own tests run them on the CPU
(``interpret=True``).  Byte outputs (chunks, parity, slots) must be
identical; float outputs keep the tolerances ``test_torch_kernels.py``
uses for K2, and ``rz'`` holds to rtol 1e-6 in float64 because the
reference kernel sums it in float32 (ROADMAP N1).
"""
import dataclasses
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro import api as ref_api
from repro.kernels.fused_cg import (
    fused_cg_update_persist_pallas,
    fused_pass_traffic as ref_fused_pass_traffic,
)
from repro.kernels.gf256_encode import gf256_rs_encode_pallas
from repro.nvm import backend as ref_backend
from repro.nvm import gf256 as ref_gf256
from repro_torch import api
from repro_torch.convert import problem_from_numpy
from repro_torch.kernels import fused_cg, gf256_encode, ops
from repro_torch.nvm import backend, gf256

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
#: K2's tolerances in test_torch_kernels.py (float64: the reference
#: lines; float32: the reference kernel's own)
UPDATE_TOL = {np.float64: 1e-15, np.float32: 2e-5}
RZ_RTOL = {np.float64: 1e-6, np.float32: 1e-4}


def _shards(seed, k_data, length):
    return np.random.default_rng(seed).integers(
        0, 256, size=(k_data, length), dtype=np.uint8)


# ----------------------------------------------------------------------
# GF(2^8) arithmetic (nvm/gf256.py) and the CUDA tables
# ----------------------------------------------------------------------
def test_gf256_tables_match_reference():
    assert np.array_equal(gf256.EXP, ref_gf256.EXP)
    assert np.array_equal(gf256.LOG, ref_gf256.LOG)
    assert (gf256.PRIMITIVE_POLY, gf256.GENERATOR, gf256.MAX_PARITY) == (
        ref_gf256.PRIMITIVE_POLY, ref_gf256.GENERATOR, ref_gf256.MAX_PARITY)


def test_cuda_tables_match_python_tables():
    """The literal tables the kernels read (csrc/gf256.cuh)."""
    text = (CSRC / "gf256.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[\w+\] = \{([^}]*)\}", text).group(1)
        return np.array([int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)])

    assert np.array_equal(table("GF_EXP"), gf256.EXP)
    want_log = gf256.LOG.copy()
    want_log[0] = 0  # unused entry
    assert np.array_equal(table("GF_LOG"), want_log)


def test_gf256_arithmetic_matches_reference():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8))
    assert np.array_equal(gf256.gf_mul(a, b), ref_gf256.gf_mul(a, b))
    nz = b[b != 0]
    assert np.array_equal(gf256.gf_div(a[b != 0], nz),
                          ref_gf256.gf_div(a[b != 0], nz))
    for x in range(256):
        assert [gf256.gf_pow(x, n) for n in range(0, 300, 7)] == \
            [ref_gf256.gf_pow(x, n) for n in range(0, 300, 7)]
        if x:
            assert gf256.gf_inv(x) == ref_gf256.gf_inv(x)
    with pytest.raises(ZeroDivisionError):
        gf256.gf_inv(0)


@pytest.mark.parametrize("nparity", [1, 2])
def test_vandermonde_matches_reference(nparity):
    for k_data in range(1, 256):
        assert np.array_equal(gf256.vandermonde(nparity, k_data),
                              ref_gf256.vandermonde(nparity, k_data))


@pytest.mark.parametrize("args", [(3, 4), (0, 4), (1, 0), (2, 256)])
def test_vandermonde_errors_match_reference(args):
    with pytest.raises(ValueError) as ref_err:
        ref_gf256.vandermonde(*args)
    with pytest.raises(ValueError, match=re.escape(str(ref_err.value))):
        gf256.vandermonde(*args)


_PATTERNS = [c for r in (1, 2) for c in itertools.combinations(range(6), r)]


@pytest.mark.parametrize("erased", _PATTERNS, ids=str)
def test_rs_reconstruct_every_erasure_pattern(erased):
    """K=4, P=2: every 1- and 2-erasure pattern rebuilds the data, in
    both packages, from the same parity."""
    data = list(_shards(sum(erased) + 11, 4, 257))
    parity = gf256.rs_encode(data, 2)
    ref_parity = ref_gf256.rs_encode(data, 2)
    assert all(np.array_equal(p, q) for p, q in zip(parity, ref_parity))
    stripe = [None if j in erased else s
              for j, s in enumerate(data + parity)]
    got = gf256.rs_reconstruct(stripe, 4)
    want = ref_gf256.rs_reconstruct(stripe, 4)
    for g, w, d in zip(got, want, data):
        assert np.array_equal(g, w) and np.array_equal(g, d)


def test_rs_reconstruct_beyond_distance_raises_like_reference():
    data = list(_shards(3, 4, 16))
    stripe = data + gf256.rs_encode(data, 1)
    stripe[0] = stripe[1] = None
    with pytest.raises(ValueError) as ref_err:
        ref_gf256.rs_reconstruct(stripe, 4)
    with pytest.raises(ValueError, match=re.escape(str(ref_err.value))):
        gf256.rs_reconstruct(stripe, 4)


# ----------------------------------------------------------------------
# K3's plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k_data", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("nparity", [1, 2])
@pytest.mark.parametrize("length", [1, 100, 8192, 8205])
def test_plain_encode_matches_pallas_kernel_and_numpy(k_data, nparity, length):
    data = _shards(k_data * 1000 + nparity * 10 + length, k_data, length)
    want = ref_gf256.rs_encode(list(data), nparity)
    pallas = gf256_rs_encode_pallas(list(data), nparity, interpret=True)
    got = gf256_encode.gf256_rs_encode_plain(torch.from_numpy(data), nparity)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (nparity, length)
    for g, w, p in zip(got.numpy(), want, pallas):
        assert np.array_equal(g, w) and np.array_equal(g, p)


def test_plain_encode_zero_and_saturated_bytes():
    data = np.stack([np.zeros(512, np.uint8), np.full(512, 0xFF, np.uint8),
                     np.zeros(512, np.uint8), np.full(512, 0x1D, np.uint8)])
    for nparity in (1, 2):
        want = ref_gf256.rs_encode(list(data), nparity)
        got = ops.rs_encode(torch.from_numpy(data), nparity).numpy()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_plain_encode_validation_matches_reference():
    data = _shards(0, 4, 64)
    with pytest.raises(ValueError) as ref_err:
        gf256_rs_encode_pallas(list(data), nparity=3, interpret=True)
    with pytest.raises(ValueError, match=re.escape(str(ref_err.value))):
        gf256_encode.gf256_rs_encode_plain(torch.from_numpy(data), 3)
    with pytest.raises(ValueError, match="k_data must be in"):
        gf256_encode.gf256_rs_encode_plain(
            torch.zeros(256, 4, dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="uint8"):
        gf256_encode.gf256_rs_encode_plain(torch.zeros(4, 8), 1)


def test_cpu_encode_launches_no_kernel():
    ops.reset_launch_counts()
    ops.rs_encode(torch.from_numpy(_shards(1, 4, 33)), 2)
    v = torch.zeros(64, dtype=torch.float64)
    ops.fused_cg_update_persist(v, v, v, v, torch.tensor(0.5, dtype=v.dtype),
                                v, 4, 4, 2)
    assert set(ops.launch_counts().values()) == {0}


# ----------------------------------------------------------------------
# K4's plain version and fused_pass_traffic
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nblocks,k_data,nparity",
                         [(8, 4, 1), (8, 6, 2), (4, 2, 2)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_persist_plain_matches_pallas_kernel(nblocks, k_data, nparity,
                                                   dtype):
    n = nblocks * 128 * 6  # block_size 768: the reference's 128 rule holds
    vals = [rng_normal(nblocks + k_data + s, n, dtype=dtype) for s in range(5)]
    want = fused_cg_update_persist_pallas(
        *(jnp.asarray(v) for v in vals[:4]), jnp.asarray(0.37, dtype),
        jnp.asarray(vals[4]), nblocks=nblocks, k_data=k_data,
        nparity=nparity, interpret=True)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    got = ops.fused_cg_update_persist(
        *(torch.from_numpy(v) for v in vals[:4]), torch.tensor(0.37, dtype=tdt),
        torch.from_numpy(vals[4]), nblocks, k_data, nparity)
    # chunks and parity: byte-identical
    assert tuple(got[4].shape) == tuple(want[4].shape)
    assert got[4].numpy().tobytes() == np.asarray(want[4]).tobytes()
    assert tuple(got[5].shape) == tuple(want[5].shape)
    assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
    tol = UPDATE_TOL[dtype]
    for g, w, field in zip(got[:3], want[:3], "xrz"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=field)
    np.testing.assert_allclose(float(got[3]), float(want[3]),
                               rtol=RZ_RTOL[dtype])
    # the update half is K2's plain version, bit for bit
    k2 = ops.fused_cg_update(*(torch.from_numpy(v) for v in vals[:4]),
                             torch.tensor(0.37, dtype=tdt),
                             torch.from_numpy(vals[4]), nblocks)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], k2))


def test_fused_persist_validation():
    v = torch.zeros(4 * 30, dtype=torch.float64)
    a = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="not divisible by nblocks"):
        ops.fused_cg_update_persist(v, v, v, v, a, v, 7, 2, 1)
    with pytest.raises(ValueError, match="not divisible by k_data"):
        ops.fused_cg_update_persist(v, v, v, v, a, v, 4, 4, 1)
    with pytest.raises(ValueError, match="nparity must be in"):
        ops.fused_cg_update_persist(v, v, v, v, a, v, 4, 2, 3)
    # block_size 30 breaks the reference's TPU 128 rule, not the port's
    out = ops.fused_cg_update_persist(v, v, v, v, a, v, 4, 5, 2)
    assert tuple(out[4].shape) == (4, 5, 6) and tuple(out[5].shape) == (4, 2, 48)


@pytest.mark.parametrize("n,itemsize,k_data,nparity",
                         [(1 << 20, 8, 6, 2), (1 << 24, 8, 4, 2),
                          (4096, 4, 4, 1), (999, 2, 3, 2)])
def test_fused_pass_traffic_matches_reference(n, itemsize, k_data, nparity):
    assert fused_cg.fused_pass_traffic(n, itemsize, k_data, nparity) == \
        ref_fused_pass_traffic(n, itemsize, k_data, nparity)


# ----------------------------------------------------------------------
# The stripe: grammar, capabilities, slot bytes, degraded fetch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["erasure(nvm-prd x4+p)",
                                  "erasure(nvm-prd x4+2p)",
                                  "erasure(nvm-prd x6+2p)",
                                  "erasure(nvm-homogeneous x3+1p)"])
def test_spec_grammar_and_capabilities_match_reference(spec):
    assert backend.parse_backend_spec(spec) == \
        ref_backend.parse_backend_spec(spec)
    port_be = backend.create_backend(spec, 4, 96)
    ref_be = ref_backend.create_backend(spec, 4, 96)
    assert dataclasses.asdict(port_be.capabilities) == \
        dataclasses.asdict(ref_be.capabilities)
    assert (port_be.k_data, port_be.nparity, port_be.chunk) == \
        (ref_be.k_data, ref_be.nparity, ref_be.chunk)
    assert port_be.nvm_values() == ref_be.nvm_values()


def test_malformed_and_unported_specs_raise():
    with pytest.raises(ValueError, match="malformed erasure spec"):
        backend.create_backend("erasure(nvm-prd x4)", 4, 64)
    with pytest.raises(ValueError, match="1 \\(xK\\+p\\) or 2"):
        backend.create_backend("erasure(nvm-prd x4+3p)", 4, 64)
    with pytest.raises(KeyError, match="unknown backend"):
        backend.create_backend("replicated(nvm-prd x2)", 4, 64)


def test_set_encode_mode_validates():
    be = backend.create_backend("erasure(nvm-prd x4+p)", 4, 128)
    session = be.open_session()
    for mode in sorted(backend.ENCODE_MODES):
        session.set_encode_mode(mode)
    with pytest.raises(ValueError, match="unknown parity encode mode"):
        session.set_encode_mode("simd")
    with pytest.raises(ValueError, match="unknown parity encode mode"):
        backend.create_backend("erasure(nvm-prd x4+p)", 4, 128, encode="simd")


NB = 4


def _k_data(spec):
    return int(re.search(r"x(\d+)", spec).group(1))


def _events(route, spec, bs, nevents=5):
    """(k, beta, p-as-handed) for ``nevents`` events of the given route:
    numpy vectors, torch tensors, or K4-staged stripes."""
    k_data = _k_data(spec)
    nparity = 2 if "+2p" in spec else 1
    out = []
    for k in range(nevents):
        p = rng_normal(40 + k, NB * bs)
        if route == "numpy":
            v = p
        elif route == "tensor":
            v = torch.from_numpy(p)
        else:
            z = torch.zeros(NB * bs, dtype=torch.float64)
            *_, chunks, parity = fused_cg.fused_cg_update_persist_plain(
                z, z, torch.from_numpy(p), z, torch.tensor(0.0, dtype=z.dtype),
                z, NB, k_data, nparity)
            v = backend.StagedStripe(chunks, parity)
        out.append((k, 0.1 * k, p, v))
    return out


def _durable(session, child):
    return bytes(session._children[child]._backend.prd.store._durable)


@pytest.mark.parametrize("route", ["numpy", "tensor", "staged"])
@pytest.mark.parametrize("spec", ["erasure(nvm-prd x4+2p)",
                                  "erasure(nvm-prd x6+2p)"])
@pytest.mark.parametrize("pipeline", ["persist", "begin"])
def test_stripe_slot_bytes_and_degraded_fetch_match_reference(route, spec,
                                                              pipeline):
    """Every child's durable slot bytes equal the reference session's
    after five events; after two storage kills and a two-block failure,
    each package's degraded fetch rebuilds the same recovery sets from
    the OTHER package's slots."""
    # K4 needs K | block_size; elsewhere 100 makes the x6 chunks padded
    bs = 96 if route == "staged" else 100
    port_be = backend.create_backend(spec, NB, bs, encode="pallas")
    ref_be = ref_backend.create_backend(spec, NB, bs)
    port_s, ref_s = port_be.open_session(), ref_be.open_session()
    for k, beta, p, v in _events(route, spec, bs):
        for s, vec in ((port_s, v), (ref_s, p)):
            getattr(s, pipeline)(k, {"beta": beta}, {"p": vec})
            if pipeline == "begin":
                s.commit()
    for s in (port_s, ref_s):
        s.drain()
    nchildren = len(port_s._children)
    for j in range(nchildren):
        assert _durable(port_s, j) == _durable(ref_s, j), f"child {j}"
    if route != "numpy":
        assert port_s.device_to_host_bytes == 5 * nchildren * NB * \
            port_be.chunk * 8
    for s in (port_s, ref_s):
        s.fail_storage()
        s.fail_storage()
        s.fail((1, 3))
    # swap the surviving media across the packages
    for j in range(2, nchildren):
        a = port_s._children[j]._backend.prd.store
        b = ref_s._children[j]._backend.prd.store
        a._working, b._working = bytearray(b._working), bytearray(a._working)
        a._durable, b._durable = bytearray(b._durable), bytearray(a._durable)
    got = port_s.fetch((1, 3), (3, 4))
    want = ref_s.fetch((1, 3), (3, 4))
    for g, w in zip(got, want):
        assert (g.k, g.scalars) == (w.k, w.scalars)
        assert g.vectors["p"].tobytes() == w.vectors["p"].tobytes()
    p4 = rng_normal(44, NB * bs).reshape(NB, bs)
    assert np.array_equal(got[1].vectors["p"], p4[[1, 3]].reshape(-1))


@pytest.mark.parametrize("mode", sorted(backend.ENCODE_MODES))
def test_tensor_takes_the_kernel_route_in_every_mode(mode, monkeypatch):
    """The vector's type picks the route: a tensor is encoded through
    ops.rs_encode whatever the encode mode, a numpy vector never is."""
    calls, real = [], ops.rs_encode

    def counted(data, nparity):
        calls.append(nparity)
        return real(data, nparity)

    monkeypatch.setattr(ops, "rs_encode", counted)
    be = backend.create_backend("erasure(nvm-prd x4+p)", NB, 96, encode=mode)
    session = be.open_session()
    session.set_encode_mode(mode)
    p = rng_normal(1, NB * 96)
    session.persist(0, {"beta": 0.0}, {"p": p})
    assert calls == [] and session.device_to_host_bytes == 0
    session.persist(1, {"beta": 0.0}, {"p": torch.from_numpy(p)})
    assert calls == [1]
    assert session.device_to_host_bytes == 5 * NB * 24 * 8
    assert session.fused_geometry(np.float64) == (4, 1)
    assert session.fused_geometry(np.float32) is None


# ----------------------------------------------------------------------
# Whole solves through api.solve, against the reference
# ----------------------------------------------------------------------
SPECS = ["erasure(nvm-prd x4+p)", "erasure(nvm-prd x4+2p)",
         "erasure(nvm-prd x6+2p)"]
COUNTERS = ("iterations", "persist_events", "persist_aborts",
            "failures_recovered", "wasted_iterations", "persist_bytes",
            "recovery_fetch_bytes", "storage_failures", "converged")


def _campaign(pkg):
    """The reference's campaign (tests/test_gf256_encode.py): a PRD kill
    with a block loss, then a two-block loss."""
    return pkg.FailureCampaign((
        pkg.FailureEvent(blocks=(1,), at_iteration=6, prd=True),
        pkg.FailureEvent(blocks=(2, 3), at_iteration=10),
    ))


@pytest.fixture(scope="module")
def solves():
    """Lazily computed solves, shared by the tests of this module:
    ``solves(pkg, grid, spec, mode, fused)``."""
    cache, problems = {}, {}

    def problem(pkg, grid):
        if (pkg, grid) not in problems:
            ref = ref_api.Problem.poisson(grid, grid, grid, nblocks=4)
            problems["ref", grid] = ref
            problems["port", grid] = problem_from_numpy(
                (grid,) * 3, 4, np.asarray(ref.b), device="cpu")
        return problems[pkg, grid]

    def run(pkg, grid, spec, mode, fused):
        key = (pkg, grid, spec, mode, fused)
        if key not in cache:
            mod = ref_api if pkg == "ref" else api
            cache[key] = mod.solve(
                problem(pkg, grid), mod.SolverSpec("pcg", tol=1e-10),
                mod.ResilienceSpec(spec, persist_mode=mode,
                                   fused_persist=fused),
                failures=_campaign(mod))
        return cache[key]

    return run


@pytest.mark.parametrize("fused", [False, True], ids=["numpy", "fused"])
@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("grid", [8, 16])
def test_erasure_solve_matches_reference(solves, grid, spec, mode, fused):
    ref = solves("ref", grid, spec, mode, fused)
    got = solves("port", grid, spec, mode, fused)
    for name in COUNTERS:
        assert getattr(got.report, name) == getattr(ref.report, name), name
    assert got.report.failures_recovered == 2
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("grid", [8, 16])
def test_fused_and_numpy_routes_are_bitwise_equal(solves, grid, spec, mode):
    numpy_route = solves("port", grid, spec, mode, False)
    fused = solves("port", grid, spec, mode, True)
    assert torch.equal(fused.state.x, numpy_route.state.x)
    assert torch.equal(fused.state.p, numpy_route.state.p)
    assert fused.iterations == numpy_route.iterations
    routes = fused.report.metrics.counter_by_label("persist.route", "route")
    k4 = mode == "overlap" and (grid ** 3 // 4) % _k_data(spec) == 0
    if mode == "sync":
        assert set(routes) == {"K3"}
    else:
        assert ("K4" in routes) == k4
    assert sum(routes.values()) >= fused.report.persist_events


def test_traced_fused_overlap_solve_closes_the_triangle():
    """The fused overlap route's trace passes check_trace_report
    (staging conservation included), records the same span and event
    counts as the reference's fused run, and names the kernel route."""
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer, check_trace_report

    ref_problem = ref_api.Problem.poisson(8, 8, 8, nblocks=4)
    port_problem = problem_from_numpy((8, 8, 8), 4, np.asarray(ref_problem.b),
                                      device="cpu")
    ref_tracer, tracer = RefTracer(), Tracer()
    spec = "erasure(nvm-prd x4+2p)"
    ref_api.solve(ref_problem, "pcg",
                  ref_api.ResilienceSpec(spec, persist_mode="overlap",
                                         fused_persist=True),
                  failures=_campaign(ref_api), tracer=ref_tracer)
    got = api.solve(port_problem, "pcg",
                    api.ResilienceSpec(spec, persist_mode="overlap",
                                       fused_persist=True),
                    failures=_campaign(api), tracer=tracer)
    check_trace_report(tracer, got.report)
    assert tracer.counts() == ref_tracer.counts()
    encodes = [rec["args"] for rec in tracer.records
               if rec.get("name") == "gf256.rs_encode"]
    assert {a["encoder"] for a in encodes} == {"pallas"}
    assert any(a["staged"] for a in encodes)
