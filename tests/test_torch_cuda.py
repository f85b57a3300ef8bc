"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither JAX nor the reference package, so it also runs on a GPU
machine that has no JAX: from the repository root,

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float64 1e-12 (the kernels round every operation in the
plain version's order; only the reductions' order differs), float32 and
bfloat16 the reference's own kernel tolerances (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, rng_normal  # noqa: F401
from repro_torch.kernels import fused_cg, gf256_encode, ops, stencil7


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 10, 130), (3, 9, 7, 33)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-1)])
def test_stencil7_kernel_matches_plain_on_card(cuda_device, shape, dtype, tol):
    u = torch.from_numpy(rng_normal(7, *shape, dtype=np.float32)).to(
        cuda_device, dtype)
    before = stencil7.launches
    got = stencil7.stencil7_cuda(u)
    torch.cuda.synchronize()
    assert stencil7.launches == before + 1
    want = stencil7.stencil7_plain(u)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nblocks", [(4096, 8), (8229, 1), (128 * 9, 3)])
@pytest.mark.parametrize("dtype,tol,rz_tol", [(torch.float64, 1e-12, 1e-12),
                                              (torch.float32, 2e-5, 1e-4),
                                              (torch.bfloat16, 2e-1, 3e-2)])
def test_fused_cg_kernel_matches_plain_on_card(cuda_device, n, nblocks, dtype,
                                               tol, rz_tol):
    vals = [torch.from_numpy(rng_normal(s, n)).to(cuda_device, dtype)
            for s in range(4)]
    inv = (0.5 + torch.from_numpy(np.abs(rng_normal(9, n)))).to(cuda_device, dtype)
    alpha = torch.tensor(0.37, dtype=dtype, device=cuda_device)
    got = fused_cg.fused_cg_update_cuda(*vals, alpha, inv, nblocks)
    want = fused_cg.fused_cg_update_plain(*vals, alpha, inv, nblocks)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    rz_rel = abs(float(got[3]) - float(want[3])) / abs(float(want[3]))
    assert rz_rel < rz_tol
    # the fused rz' and det_dot(r', z') share one rounding order, the one
    # det_dot_order_plain writes down
    assert torch.equal(fused_cg.det_dot_cuda(got[1], got[2], nblocks), got[3])
    assert torch.equal(fused_cg.det_dot_order_plain(got[1], got[2], nblocks),
                       got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("n,nblocks", [(4096, 8), (8229, 1), (128 * 9, 3),
                                       (257 * 4096 + 6, 2), (257 * 4096, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_det_dot_kernel_is_the_documented_order_on_card(cuda_device, n,
                                                        nblocks, dtype,
                                                        offset):
    """det_dot bitwise det_dot_order_plain: 16-byte and one-value loads
    (offset 1 unaligns the pointers), ragged tiles, and more tile
    partials than threads; the same bits on every call, and every ticket
    back at 0 afterwards."""
    a, b = (torch.from_numpy(rng_normal(s, n + offset)).to(cuda_device, dtype)
            [offset:] for s in (3, 4))
    want = fused_cg.det_dot_order_plain(a, b, nblocks)
    before = fused_cg.dot_launches
    first = fused_cg.det_dot_cuda(a, b, nblocks)
    again = fused_cg.det_dot_cuda(a, b, nblocks)
    torch.cuda.synchronize()
    assert fused_cg.dot_launches == before + 2
    assert torch.equal(first, want) and torch.equal(again, want)
    for workspace in fused_cg._WORKSPACE.values():
        assert int(workspace.tickets.abs().sum()) == 0


@pytest.mark.cuda
def test_ops_dispatch_launches_kernels_on_card(cuda_device):
    ops.reset_launch_counts()
    u = torch.ones(8, 8, 8, dtype=torch.float64, device=cuda_device)
    v = u.reshape(-1)
    one = torch.tensor(1.0, dtype=torch.float64, device=cuda_device)
    ops.stencil7(u)
    ops.det_dot(v, v, 4)
    ops.fused_cg_update(v, v, v, v, one, v, 4)
    ops.rs_encode(torch.ones(4, 64, dtype=torch.uint8, device=cuda_device), 2)
    ops.fused_cg_update_persist(v, v, v, v, one, v, 4, 4, 2)
    lanes = v.reshape(4, -1)
    ops.det_dot_lanes(lanes, lanes)
    ops.fused_cg_update_lanes(lanes, lanes, lanes, lanes, one.repeat(4),
                              lanes)
    ops.stencil7_halo(u[:2], None, u[2])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"stencil7": 1, "fused_cg_update": 1,
                                   "det_dot": 1, "gf256_rs_encode": 1,
                                   "fused_cg_update_persist": 1,
                                   "fused_cg_update_lanes": 1,
                                   "det_dot_lanes": 1, "stencil7_halo": 1}


def _shards(seed, k_data, length):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(k_data, length), dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("k_data", [2, 3, 4, 6, 255])
@pytest.mark.parametrize("nparity", [1, 2])
@pytest.mark.parametrize("length", [1, 7, 100, 8192, 8205, 1 << 20])
def test_gf256_encode_kernel_matches_plain_on_card(cuda_device, k_data,
                                                   nparity, length):
    """K3 bitwise against its plain version: word and byte routes,
    ragged tails, every K up to 255."""
    data = _shards(k_data * 31 + length, k_data, length).to(cuda_device)
    before = gf256_encode.launches
    got = gf256_encode.gf256_rs_encode_cuda(data, nparity)
    torch.cuda.synchronize()
    assert gf256_encode.launches == before + 1
    assert torch.equal(got, gf256_encode.gf256_rs_encode_plain(data, nparity))


@pytest.mark.cuda
@pytest.mark.parametrize("k_data", [1, 16, 255])
@pytest.mark.parametrize("nparity", [1, 2])
@pytest.mark.parametrize("length", [1000, 4099])
def test_gf256_encode_kernel_unaligned_rows_on_card(cuda_device, k_data,
                                                    nparity, length):
    """K3 on shards that start 1-15 bytes off a 16-byte boundary, with row
    lengths that are not multiples of 16 (every row and the Q row start
    at another misalignment)."""
    buf = _shards(k_data + length, 1, k_data * length + 16)[0].to(cuda_device)
    for offset in range(16):
        data = buf[offset:offset + k_data * length].view(k_data, length)
        assert torch.equal(gf256_encode.gf256_rs_encode_cuda(data, nparity),
                           gf256_encode.gf256_rs_encode_plain(data, nparity))


@pytest.mark.cuda
def test_gf256_encode_kernel_zero_and_saturated_bytes(cuda_device):
    rows = [np.zeros(515, np.uint8), np.full(515, 0xFF, np.uint8),
            np.zeros(515, np.uint8), np.full(515, 0x1D, np.uint8)]
    data = torch.from_numpy(np.stack(rows)).to(cuda_device)
    for nparity in (1, 2):
        for d in (data, data[:, :512].contiguous()):
            assert torch.equal(gf256_encode.gf256_rs_encode_cuda(d, nparity),
                               gf256_encode.gf256_rs_encode_plain(d, nparity))


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks,k_data,nparity", [(8, 4, 1), (8, 6, 2),
                                                    (4, 2, 2), (3, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_fused_persist_kernel_matches_plain_and_k2_on_card(
        cuda_device, nblocks, k_data, nparity, dtype):
    """K4's update outputs are bitwise K2's; its chunks and parity are
    bitwise the plain version's and K3's on the cut of p."""
    n = nblocks * 6 * 700  # block_size 4200: divisible by 2, 4 and 6
    vals = [torch.from_numpy(rng_normal(s, n)).to(cuda_device, dtype)
            for s in range(4)]
    inv = (0.5 + torch.from_numpy(np.abs(rng_normal(9, n)))).to(cuda_device, dtype)
    alpha = torch.tensor(0.37, dtype=dtype, device=cuda_device)
    before = fused_cg.persist_launches
    got = fused_cg.fused_cg_update_persist_cuda(*vals, alpha, inv, nblocks,
                                                k_data, nparity)
    torch.cuda.synchronize()
    assert fused_cg.persist_launches == before + 1
    k2 = fused_cg.fused_cg_update_cuda(*vals, alpha, inv, nblocks)
    for g, w in zip(got[:4], k2):
        assert torch.equal(g, w)
    plain = fused_cg.fused_cg_update_persist_plain(*vals, alpha, inv, nblocks,
                                                   k_data, nparity)
    assert torch.equal(got[4], plain[4]) and torch.equal(got[5], plain[5])
    data = fused_cg.stripe_bytes(vals[2].reshape(nblocks, k_data, -1))
    k3 = gf256_encode.gf256_rs_encode_cuda(data, nparity)
    assert torch.equal(got[5].transpose(0, 1).reshape(nparity, -1), k3)


@pytest.mark.cuda
def test_fused_persist_kernel_refuses_unstriped_blocks(cuda_device):
    v = torch.zeros(4 * 30, dtype=torch.float64, device=cuda_device)
    a = torch.tensor(1.0, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="not divisible by k_data"):
        fused_cg.fused_cg_update_persist_cuda(v, v, v, v, a, v, 4, 4, 1)
    with pytest.raises(ValueError, match="nparity must be in"):
        fused_cg.fused_cg_update_persist_cuda(v, v, v, v, a, v, 4, 2, 3)


# ----------------------------------------------------------------------
# solve_jit as a CUDA graph, and the zoo on the card
# ----------------------------------------------------------------------
def _poisson(device, grid=16, nblocks=4, preconditioner="jacobi", seed=11):
    from repro_torch.convert import problem_from_numpy

    b = 0.5 + rng_normal(seed, grid ** 3)
    return problem_from_numpy((grid,) * 3, nblocks, b, preconditioner,
                              device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,maxiter", [(32, 10_000), (7, 10_000),
                                           (8, 20), (16, 16)])
def test_solve_jit_graph_is_the_eager_loop_bitwise_on_card(cuda_device, chunk,
                                                           maxiter):
    """The graph's x is bitwise the driver's unprotected loop's at the
    same k — a stop inside a chunk, at a chunk's end and at maxiter —
    and the launch counts include every replay."""
    from repro_torch import api
    from repro_torch.core import solve_jit

    problem = _poisson(cuda_device)
    ops.reset_launch_counts()
    info = {}
    x, k = solve_jit(problem.op, problem.precond, problem.b, tol=1e-10,
                     maxiter=maxiter, chunk=chunk, info=info)
    counts = ops.launch_counts()
    size = min(chunk, maxiter)
    assert info["graph"] and info["chunk"] == size
    assert info["launches_per_chunk"] == {
        "stencil7": size, "fused_cg_update": size, "det_dot": 2 * size,
        "gf256_rs_encode": 0, "fused_cg_update_persist": 0,
        "fused_cg_update_lanes": 0, "det_dot_lanes": 0, "stencil7_halo": 0}
    eager = info["eager_iterations"]
    # init (K1, 3 dots), warm-up (one step + one dot), the replays, and
    # the eager rerun of a chunk the stop fell inside
    assert counts["stencil7"] == 1 + 1 + info["chunks"] * size + eager
    assert counts["fused_cg_update"] == 1 + info["chunks"] * size + eager
    free = api.solve(problem, api.SolverSpec("pcg", tol=1e-10))
    assert k == min(maxiter, free.iterations)
    driver = api.solve(problem, api.SolverSpec("pcg", tol=0.0, maxiter=k))
    assert x.device.type == "cuda" and torch.equal(x, driver.state.x)
    cpu_x, cpu_k = solve_jit(*(_cpu_parts(problem)), tol=1e-10,
                             maxiter=maxiter, chunk=chunk)
    assert cpu_k == k
    torch.testing.assert_close(x.cpu(), cpu_x, rtol=1e-10, atol=1e-12)


def _cpu_parts(problem):
    cpu = _poisson("cpu")
    assert torch.equal(cpu.b, problem.b.cpu())
    return cpu.op, cpu.precond, cpu.b


@pytest.mark.cuda
def test_graph_survives_a_grown_workspace_on_card(cuda_device):
    """After capture, a larger det_dot geometry on the graph's stream
    replaces the workspace tensors and a spent scalar pool is replaced;
    freed memory is then refilled with NaN.  Replays still give the
    eager bits, and a second capture on the grown workspace gives the
    same x as the first."""
    from repro_torch.core import pcg, solve_jit

    problem = _poisson(cuda_device)
    op, pre, b = problem.op, problem.precond, problem.b
    x_first, k_first = solve_jit(op, pre, b, tol=1e-10, chunk=8)
    step = pcg.make_step(op.apply, pre.inv_diag, op.nblocks)
    dot = pcg.make_det_dot(op.nblocks)
    start = pcg.init_state(op, pre, b, dot=dot)
    body = pcg._Chunk(step, dot, start, 8)
    graph = pcg._ChunkGraph(body, op.nblocks)
    with torch.cuda.stream(graph.stream):
        ws = fused_cg.workspace(b, op.nblocks)
        old = (ws.partials.data_ptr(), ws.tickets.data_ptr())
        big = torch.ones(1 << 22, dtype=torch.float64, device=cuda_device)
        fused_cg.det_dot_cuda(big, big, 1)
        assert (ws.partials.data_ptr(), ws.tickets.data_ptr()) != old
        for _ in range(fused_cg.SCALAR_SLOTS):
            ws.scalar(torch.float64)
        del big
        junk = [torch.full((1 << 20,), float("nan"), dtype=torch.float64,
                           device=cuda_device) for _ in range(8)]
        for _ in range(2):
            graph.replay()
    torch.cuda.current_stream(cuda_device).wait_stream(graph.stream)
    st = start
    for _ in range(16):
        st = step(st)
    for f in ("x", "r", "z", "p", "rz", "beta_prev"):
        assert torch.equal(body.buf[f], getattr(st, f)), f
    del junk
    x_second, k_second = solve_jit(op, pre, b, tol=1e-10, chunk=8)
    assert k_second == k_first and torch.equal(x_second, x_first)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,opts,fail_at", [
    ("pcg", {}, 8), ("jacobi", {}, 8), ("chebyshev", {}, 8),
    ("bicgstab", {}, 8), ("gmres", {"m": 6}, 2)])
def test_zoo_on_card_matches_the_cpu_port(cuda_device, solver, opts, fail_at,
                                          monkeypatch):
    """Each zoo solver with a block failure on the card, against the CPU
    port on the same inputs.  The CPU run takes det_dot's order on the
    card (``det_dot_order_plain``): BiCGStab amplifies a last-bit
    difference in a dot about tenfold per iteration, so with the plain
    block sum's order the two runs part by 5e-5 after 40 iterations at
    16^3 (the two orders on the CPU alone)."""
    from repro_torch import api

    monkeypatch.setattr(fused_cg, "block_dot_plain",
                        fused_cg.det_dot_order_plain)
    results = []
    for device in (cuda_device, "cpu"):
        results.append(api.solve(
            _poisson(device), api.SolverSpec(solver, tol=1e-10, maxiter=40,
                                             options=opts),
            api.ResilienceSpec("replicated(nvm-prd x2)"),
            failures=[api.FailureEvent(blocks=(1, 2), at_iteration=fail_at)]))
    card, cpu = results
    assert card.state.x.device.type == "cuda"
    assert card.iterations == cpu.iterations
    assert card.report.failures_recovered == 1
    np.testing.assert_allclose(card.x, cpu.x, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_block_jacobi_pcg_on_card_matches_the_cpu_port(cuda_device):
    from repro_torch import api

    results = [api.solve(_poisson(device, preconditioner="block_jacobi"),
                         api.SolverSpec("pcg", tol=1e-10),
                         api.ResilienceSpec("erasure(nvm-prd x4+p)",
                                            persist_mode="overlap",
                                            fused_persist=True),
                         failures=[api.FailureEvent(blocks=(1,),
                                                    at_iteration=5)])
               for device in (cuda_device, "cpu")]
    card, cpu = results
    assert card.iterations == cpu.iterations and card.converged
    np.testing.assert_allclose(card.x, cpu.x, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n", [(4, 4096), (3, 8229), (1, 1000),
                                     (2, 128 * 9)])
@pytest.mark.parametrize("dtype,tol,rz_tol", [(torch.float64, 1e-12, 1e-12),
                                              (torch.float32, 2e-5, 1e-4),
                                              (torch.bfloat16, 2e-1, 3e-2)])
def test_lane_kernels_are_solo_launches_on_card(cuda_device, lanes, n, dtype,
                                                tol, rz_tol):
    """K2's and det_dot's lane modes: each lane bitwise a solo nblocks=1
    launch on that lane (and det_dot_order_plain's order), and the whole
    bucket within tolerance of the plain lane versions."""
    x, r, p, ap = (torch.from_numpy(rng_normal(s, lanes, n)).to(cuda_device,
                                                                 dtype)
                   for s in range(4))
    inv = (0.5 + torch.from_numpy(np.abs(rng_normal(9, lanes, n)))).to(
        cuda_device, dtype)
    alpha = (0.1 + torch.from_numpy(np.abs(rng_normal(8, lanes)))).to(
        cuda_device, dtype)
    before = (fused_cg.update_lanes_launches, fused_cg.dot_lanes_launches)
    got = fused_cg.fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv)
    dots = fused_cg.det_dot_lanes_cuda(p, ap)
    torch.cuda.synchronize()
    assert (fused_cg.update_lanes_launches, fused_cg.dot_lanes_launches) == (
        before[0] + 1, before[1] + 1)
    assert got[3].shape == dots.shape == (lanes,)
    for i in range(lanes):
        solo = fused_cg.fused_cg_update_cuda(x[i], r[i], p[i], ap[i],
                                             alpha[i], inv[i], 1)
        for g, s in zip(got, solo):
            assert torch.equal(g[i], s), f"lane {i}"
        assert torch.equal(dots[i], fused_cg.det_dot_cuda(p[i], ap[i], 1))
        assert torch.equal(dots[i], fused_cg.det_dot_order_plain(p[i], ap[i]))
    want = fused_cg.fused_cg_update_lanes_plain(x, r, p, ap, alpha, inv)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    rz_rel = ((got[3].double() - want[3].double()).abs()
              / want[3].double().abs())
    assert float(rz_rel.max()) < rz_tol
    plain_dots = fused_cg.det_dot_lanes_plain(p, ap).double()
    assert float(((dots.double() - plain_dots).abs()
                  / plain_dots.abs()).max()) < rz_tol


@pytest.mark.cuda
def test_lane_kernels_keep_a_free_lane_nan_in_its_lane(cuda_device):
    lanes, n = 4, 3000
    x, r, p, ap, inv = (torch.from_numpy(rng_normal(s, lanes, n)).to(
        cuda_device) for s in range(5))
    alpha = torch.full((lanes,), 0.3, dtype=torch.float64, device=cuda_device)
    clean = fused_cg.fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv)
    clean_dot = fused_cg.det_dot_lanes_cuda(p, ap)
    for t in (x, r, p, ap):
        t[1] = float("nan")
    alpha[1] = float("nan")
    dirty = fused_cg.fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv)
    dirty_dot = fused_cg.det_dot_lanes_cuda(p, ap)
    for lane in (0, 2, 3):
        for c, d in zip(clean, dirty):
            assert torch.equal(c[lane], d[lane])
        assert torch.equal(clean_dot[lane], dirty_dot[lane])
    assert bool(torch.isnan(dirty[3][1])) and bool(torch.isnan(dirty_dot[1]))


@pytest.mark.cuda
def test_service_on_card_matches_the_cpu_port(cuda_device, monkeypatch):
    """A small mixed bucket with block, PRD and shard kills on the card,
    against the CPU port on the same requests (the CPU run in the card's
    dot order, as for the zoo above); one K1, one K2-lanes and one
    lane-dot launch per PCG bucket step."""
    from repro_torch import api
    from repro_torch.serving import ServiceRequest
    from repro_torch.solvers import FailureEvent

    monkeypatch.setattr(fused_cg, "block_dot_plain",
                        fused_cg.det_dot_order_plain)
    requests = (
        ServiceRequest("a", 0, (16, 16, 16), 8, tol=1e-10, maxiter=60,
                       backend="nvm-prd",
                       failures=(FailureEvent(blocks=(1, 2),
                                              at_iteration=10),)),
        ServiceRequest("b", 0, (12, 16, 16), 4, tol=1e-10, maxiter=60,
                       backend="replicated(nvm-prd x2)",
                       persist_mode="overlap", period=3,
                       failures=(FailureEvent(blocks=(3,), at_iteration=8,
                                              prd=True),)),
        ServiceRequest("c", 0, (10, 10, 10), 5, tol=1e-10, maxiter=60,
                       backend="erasure(nvm-prd x4+p)", nshards=5,
                       failures=(FailureEvent(shard=2, at_iteration=7),)),
        ServiceRequest("d", 0, (16, 16, 12), 4, tol=1e-10, maxiter=60,
                       backend="nvm-homogeneous"),
    )
    card, cpu = (api.serve(requests, device=device)
                 for device in (cuda_device, "cpu"))
    for name in "abcd":
        got, want = card[name].result, cpu[name].result
        assert got.state.x.device.type == "cuda"
        assert got.iterations == want.iterations
        assert (got.report.failures_recovered
                == want.report.failures_recovered == int(name != "d"))
        np.testing.assert_allclose(got.x, want.x, rtol=1e-10, atol=1e-10)
    assert card["c"].result.report.nshards == 5
    assert set(card["c"].result.report.persist_bytes_by_shard) == set(range(5))
    # the failure-free tenant alone: every bucket step is one launch of
    # each lane kernel, and one K1 (plus the lane init's apply)
    ops.reset_launch_counts()
    alone = api.serve(requests[3:], device=cuda_device)["d"].result.report
    counts = ops.launch_counts()
    steps = alone.service_lane_steps
    assert steps > 0
    assert counts["fused_cg_update_lanes"] == counts["det_dot_lanes"] == steps
    assert counts["stencil7"] == steps + 1


# ----------------------------------------------------------------------
# Sharded solves on a one-card data mesh
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("grid,nshards", [((16, 16, 16), 2),
                                          ((16, 16, 16), 16),
                                          ((12, 10, 130), 3)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-1)])
def test_stencil7_halo_kernel_on_card(cuda_device, grid, nshards, dtype, tol):
    """K1's halo mode: each slab against its plain version, and the slabs
    side by side bitwise one full K1 launch (``nz_s = 1`` at 16 shards)."""
    from repro_torch.core import spmv

    u = torch.from_numpy(rng_normal(11, *grid, dtype=np.float32)).to(
        cuda_device, dtype)
    before = stencil7.halo_launches
    got = spmv.sharded_stencil7(u, nshards)
    torch.cuda.synchronize()
    assert stencil7.halo_launches == before + nshards
    assert torch.equal(got, stencil7.stencil7_cuda(u))
    slab = grid[0] // nshards
    for s in range(nshards):
        z = slice(s * slab, (s + 1) * slab)
        lo = u[s * slab - 1] if s > 0 else None
        hi = u[(s + 1) * slab] if s < nshards - 1 else None
        want = stencil7.stencil7_halo_plain(u[z], lo, hi)
        one = stencil7.stencil7_halo_cuda(u[z].contiguous(),
                                          None if lo is None else lo.clone(),
                                          None if hi is None else hi.clone())
        torch.testing.assert_close(one.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(one, got[z])


@pytest.mark.cuda
@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mesh_reductions_bitwise_unsharded_on_card(cuda_device, nshards,
                                                   dtype):
    """Per-shard block sums (det_dot's lane mode) are the unsharded
    launch's: their chain is bitwise det_dot over all blocks, and the
    row dots bitwise one det_dot a row."""
    from repro_torch.core import spmv
    from repro_torch.distributed import make_data_mesh

    nblocks, n = 8, 8 * 12_345
    a, b = (torch.from_numpy(rng_normal(s, n)).to(cuda_device, dtype)
            for s in (1, 2))
    mesh = make_data_mesh(nshards, cuda_device)
    want = fused_cg.det_dot_cuda(a, b, nblocks)
    assert torch.equal(spmv.make_det_dot(nblocks, mesh)(a, b), want)
    sums = fused_cg.det_dot_lanes_cuda(a.view(nblocks, -1), b.view(nblocks, -1))
    assert torch.equal(fused_cg.chain_plain(sums), want)
    rows = torch.from_numpy(rng_normal(3, 5, n)).to(cuda_device, dtype)
    got_rows = spmv.make_det_rowdots(nblocks, mesh)(rows, b)
    for i in range(5):
        assert torch.equal(got_rows[i],
                           fused_cg.det_dot_cuda(rows[i], b, nblocks))


@pytest.mark.cuda
@pytest.mark.parametrize("spec,mode", [("nvm-prd", "sync"),
                                       ("erasure(nvm-prd x4+2p)", "overlap")])
def test_sharded_pcg_solve_bitwise_unsharded_on_card(cuda_device, spec, mode):
    """A 4-shard PCG solve with a ``shard=1`` kill is bitwise the unsharded
    solve with that shard's blocks killed, through K1's halo mode and
    the lane modes of K2 and det_dot."""
    from repro_torch import api

    res, counts = [], []
    for nshards, event in ((4, dict(shard=1)), (1, dict(blocks=(2, 3)))):
        ops.reset_launch_counts()
        res.append(api.solve(
            api.Problem.poisson(24, nblocks=8, device=cuda_device,
                                nshards=nshards),
            api.SolverSpec("pcg", tol=1e-10, maxiter=40),
            api.ResilienceSpec(spec, persist_mode=mode, fused_persist=True),
            failures=[api.FailureEvent(at_iteration=10, **event)]))
        counts.append(ops.launch_counts())
    sharded, plain = res
    from repro_torch.distributed.sharding import gather

    assert torch.equal(gather(sharded.state.x), plain.state.x)
    assert sharded.iterations == plain.iterations
    assert sharded.report.nshards == 4
    assert sharded.report.recovery_fetch_bytes_by_shard == {
        1: plain.report.recovery_fetch_bytes}
    assert counts[0]["stencil7_halo"] > 0
    assert counts[0]["fused_cg_update_lanes"] > 0
    assert counts[0]["det_dot_lanes"] > 0
    assert counts[0]["fused_cg_update_persist"] == 0


# ----------------------------------------------------------------------
# Sharded vectors: one slab a shard, one stream a shard
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream_on_card(cuda_device):
    """K1 (full and halo mode) and K3 launched inside
    ``torch.cuda.stream(side)`` go to that stream: their outputs read on
    the side stream alone are the default stream's bits, and captured in
    a CUDA graph (whose capture stream a launch on any other stream
    would break) they replay to the same bits."""
    u = torch.from_numpy(rng_normal(5, 16, 12, 40)).to(cuda_device)
    slab, lo, hi = u[1:-1].contiguous(), u[0].clone(), u[-1].clone()
    data = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (4, 1000), dtype=np.uint8)).to(cuda_device)

    def launches():
        return (stencil7.stencil7_cuda(u),
                stencil7.stencil7_halo_cuda(slab, lo, hi),
                gf256_encode.gf256_rs_encode_cuda(data, 2))

    want = launches()
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = launches()
    side.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launches()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(captured, want))


@pytest.mark.cuda
@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_sharded_apply_one_stream_a_shard_on_card(cuda_device, nshards):
    """On a one-card mesh every slab is a tensor of its own and every
    shard has a stream of its own; the sharded apply (K1's halo mode a
    slab on its stream, the halo planes moved between streams), the
    mesh dot and a PCG step on sharded vectors are bitwise the
    unsharded ones."""
    from repro_torch.core import spmv
    from repro_torch.core.poisson import JacobiPreconditioner, StencilOperator
    from repro_torch.distributed import sharding
    from repro_torch.solvers.pcg import PCGSolver

    op = StencilOperator(16, 12, 40, nblocks=8, device=cuda_device)
    sop = sharding.ShardedOperator(op, sharding.ShardLayout(8, nshards),
                                   sharding.make_data_mesh(nshards, "cuda:0"))
    mesh = sop.mesh
    assert len({mesh.stream(s) for s in range(nshards)}) == nshards
    x = torch.from_numpy(rng_normal(7, op.n)).to(cuda_device)
    xs = sop.device_put(x)
    assert len({slab.data_ptr() for slab in xs.slabs}) == nshards
    before = stencil7.halo_launches
    got = sop.apply(xs)
    assert stencil7.halo_launches == before + nshards
    want = stencil7.stencil7_cuda(x.view(op.grid)).view(-1)
    assert torch.equal(sharding.gather(got), want)
    assert torch.equal(spmv.make_det_dot(8, mesh)(xs, got),
                       fused_cg.det_dot_cuda(x, want, 8))
    pre = JacobiPreconditioner(op)
    solver = PCGSolver()
    b = torch.from_numpy(0.5 + rng_normal(8, op.n)).to(cuda_device)
    plain = solver.make_step(op, pre)(solver.init_state(op, pre, b))
    placed = sharding.place_preconditioner(pre, sop)
    sharded = solver.make_step(sop, placed)(
        solver.init_state(sop, placed, sop.device_put(b)))
    for f in ("x", "r", "z", "p"):
        assert torch.equal(sharding.gather(getattr(sharded, f)),
                           getattr(plain, f)), f
    assert torch.equal(sharded.rz, plain.rz)
    assert torch.equal(sharded.beta_prev, plain.beta_prev)


@pytest.mark.cuda
def test_shard_streams_wait_for_the_callers_stream_on_card(cuda_device):
    """A 0-d operand written on the caller's stream behind a long sleep
    there reaches every shard's stream only after it is written: an
    elementwise op and K2's lane launches (``alpha``) read the new value,
    never the old one."""
    from repro_torch.core import spmv
    from repro_torch.distributed import sharding

    mesh = sharding.make_data_mesh(4, "cuda:0")
    n = 8 * 4096
    ones = mesh.place(torch.ones(n, dtype=torch.float64, device=cuda_device))
    alpha = torch.zeros((), dtype=torch.float64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # the caller's stream busy for a while
    alpha.fill_(3.0)
    scaled = sharding.gather(alpha * ones)
    x, r, z, _ = spmv.sharded_fused_update(ones, ones, ones, ones, alpha,
                                           ones, 8, 4)
    torch.cuda.synchronize()
    assert torch.equal(scaled, torch.full_like(scaled, 3.0))
    assert torch.equal(sharding.gather(x), torch.full_like(scaled, 4.0))
    assert torch.equal(sharding.gather(r), torch.full_like(scaled, -2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("blocks", [(0, 1), (6, 7), (1, 2, 5), (5, 1, 2)])
def test_failed_slab_restrictions_bitwise_embed_on_card(cuda_device, dtype,
                                                       blocks):
    """``A[F,F] v`` (K1's halo mode with zero halo planes over each run of
    failed blocks) and ``A[F,~F] x`` (a zero slab with the true
    neighbour planes) are bitwise the versions that embed into the whole
    grid, at the domain's ends, over two runs and in any block order."""
    from repro_torch.core.poisson import StencilOperator

    op = StencilOperator(32, 12, 40, nblocks=8, dtype=dtype,
                         device=cuda_device)
    part = op.partition
    x = torch.from_numpy(rng_normal(9, op.n)).to(cuda_device, dtype)
    v = torch.from_numpy(rng_normal(10, len(blocks) * part.block_size)).to(
        cuda_device, dtype)
    assert torch.equal(op.inblock_apply(v, blocks),
                       part.restrict(op.apply(part.embed(v, blocks)), blocks))
    assert torch.equal(op.offblock_apply(x, blocks),
                       part.restrict(op.apply(part.zero_blocks(x, blocks)),
                                     blocks))


@pytest.mark.cuda
def test_local_cg_on_the_failed_slabs_is_the_embed_loop_on_card(cuda_device):
    """Recovery's local CG with ``A[F,F]`` on the failed slabs alone (as a
    graph) stops at the embed version's iteration with its ``x``
    bitwise."""
    from repro_torch.core import reconstruction as rec

    problem = _poisson(cuda_device, grid=32, nblocks=8)
    op, part, failed = problem.op, problem.op.partition, [1, 2]
    rhs = torch.from_numpy(rng_normal(4, 2 * part.block_size)).to(cuda_device)
    info, embed_info = {}, {}
    got = rec._local_cg(lambda u: op.inblock_apply(u, failed), rhs,
                        info=info)
    want = rec._local_cg(lambda u: part.restrict(
        op.apply(part.embed(u, failed)), failed), rhs, info=embed_info)
    assert info["iterations"] == embed_info["iterations"] > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcg", "bicgstab", "gmres", "chebyshev",
                                    "jacobi"])
def test_mesh_over_distinct_cards(cuda_device, solver):
    """Shards on distinct cards (``make_data_mesh(4)``: card ``s * c //
    4``), the slabs on their cards, every cross-card read a peer copy: a
    solve with a ``shard=1`` kill is bitwise the same solve with every
    shard on one card.  Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two visible cards")
    from repro_torch import api
    from repro_torch.distributed import sharding

    cards = sharding.make_data_mesh(4)
    assert cards.distinct
    assert len(set(cards.devices)) == min(4, torch.cuda.device_count())
    runs = []
    for mesh in (cards, sharding.make_data_mesh(4, "cuda:0")):
        problem = api.Problem.poisson(24, nblocks=8, device="cuda:0"
                                      ).with_shards(4, mesh=mesh)
        res = api.solve(problem, api.SolverSpec(
            solver, tol=1e-10, maxiter=24,
            options={"m": 4} if solver == "gmres" else {}),
            api.ResilienceSpec("nvm-prd", period=2),
            failures=[api.FailureEvent(shard=1, at_iteration=8)])
        assert [slab.device for slab in res.state.x.slabs] == list(
            mesh.devices)
        runs.append(res)
    far, near = runs
    assert torch.equal(sharding.gather(far.state.x),
                       sharding.gather(near.state.x))
    assert torch.equal(sharding.gather(far.state.r),
                       sharding.gather(near.state.r))
    for field in ("iterations", "failures_recovered", "persist_events",
                  "recovery_fetch_bytes", "persist_bytes"):
        assert getattr(far.report, field) == getattr(near.report, field)
    assert far.report.residual_history == near.report.residual_history


@pytest.mark.cuda
@pytest.mark.parametrize("esr_mode", ["nvm", "inmemory"])
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
def test_grid_steps_over_distinct_cards(cuda_device, variant, esr_mode,
                                        tmp_path):
    """The PCG grid steps on sharded grids whose slabs span the visible
    cards (``make_data_mesh(4)``): three steps bitwise the same steps on
    views of one card's buffer, each slab on its card, the in-memory
    replica a whole copy on each card; and a dry-run cell placed card by
    card.  Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two visible cards")
    from repro_torch.configs.poisson_pcg import SolverConfig
    from repro_torch.core import spmv
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun

    make = {"auto": spmv.make_sharded_pcg_step,
            "shardmap": spmv.make_shardmap_pcg_step}[variant]
    cards = sharding.make_data_mesh(4)
    assert cards.distinct
    step, _ = make(cards, esr_mode=esr_mode)
    gen = torch.Generator(device="cuda:0").manual_seed(4)
    b = torch.randn(64, 32, 32, generator=gen, device="cuda:0")
    z = b * (1.0 / 6.0)
    rz = spmv.make_det_dot(4)(b.reshape(-1), z.reshape(-1))
    views = dict(x=torch.zeros_like(b), r=b, z=z, p=z.clone(), rz=rz)
    placed = {f: cards.place(v) if v.dim() == 3 else v
              for f, v in views.items()}
    if esr_mode == "inmemory":
        views["esr_red_cur"] = z.clone()
        placed["esr_red_cur"] = sharding.replicate(placed["p"])
    for _ in range(3):
        views, placed = step(views), step(placed)
        assert [s.device for s in placed["x"].slabs] == list(cards.devices)
        for f, v in views.items():
            got = placed[f]
            if isinstance(got, tuple):
                assert [t.device for t in got] == list(
                    dict.fromkeys(cards.devices))
                assert all(torch.equal(t.to("cuda:0"), v) for t in got), f
            else:
                assert torch.equal(sharding.gather(got), v), f
        views = {f: v for f, v in views.items() if f != "beta"
                 and f != "esr_red_prev"}
        placed = {f: v for f, v in placed.items() if f in views}
    sc = SolverConfig("pcg_64", (64, 64, 64), 16, esr_mode=esr_mode,
                      variant=variant)
    row = dryrun.run_solver_cell(sc, results_path=str(tmp_path / "r.jsonl"),
                                 verbose=False, nshards=16)
    assert row["cards"] == min(16, torch.cuda.device_count())
    assert row["x_r_finite"]
    assert row["memory"]["state_bytes"] <= row["memory"]["peak_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
def test_grid_steps_on_card_match_the_cpu_port(cuda_device, variant):
    from repro_torch.core import spmv
    from repro_torch.distributed import make_data_mesh

    make = {"auto": spmv.make_sharded_pcg_step,
            "shardmap": spmv.make_shardmap_pcg_step}[variant]
    b = rng_normal(8, 16, 12, 10, dtype=np.float32)
    z = b / np.float32(6.0)
    init = dict(x=np.zeros_like(b), r=b, z=z, p=z,
                rz=np.asarray(np.sum(b * z), np.float32))
    states = []
    for device in (cuda_device, "cpu"):
        step, _ = make(make_data_mesh(4, device))
        st = {f: torch.from_numpy(v.copy()).to(device) for f, v in init.items()}
        for _ in range(5):
            st = {f: v for f, v in step(st).items() if f in init}
        states.append(st)
    card, cpu = states
    for f in init:
        torch.testing.assert_close(card[f].cpu(), cpu[f], rtol=1e-4,
                                   atol=1e-4 * float(cpu[f].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("esr_mode", ["nvm", "inmemory"])
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
def test_dry_run_cell_on_card(cuda_device, tmp_path, variant, esr_mode):
    """A small dry-run cell on the card: its peak is the card's measured
    allocation within the card's memory, its share of the bound is
    taken, and its rows render."""
    from repro_torch.configs.poisson_pcg import SolverConfig
    from repro_torch.launch import dryrun, report

    sc = SolverConfig("pcg_64", (64, 64, 64), 16, esr_mode=esr_mode,
                      variant=variant)
    out = tmp_path / "rows.jsonl"
    row = dryrun.run_solver_cell(sc, results_path=str(out), verbose=False,
                                 nshards=16)
    grids = 5 if esr_mode == "inmemory" else 4
    assert row["x_r_finite"] and row["device"]["type"] == "cuda"
    # the largest card's state (every grid's bytes on one card)
    assert row["memory"]["state_bytes"] <= row["memory"]["peak_bytes"]
    assert row["cards"] > 1 or \
        grids * 64 ** 3 * 4 <= row["memory"]["state_bytes"]
    assert row["memory"]["peak_bytes"] <= row["device"]["memory_bytes"]
    assert row["roofline_share"] > 0 and row["device"]["power_limit"]
    assert "| poisson_pcg | pcg_64 |" in report.table(report.load(str(out)),
                                                     mesh="16")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["auto", "shardmap"])
@pytest.mark.parametrize("nshards", [32, 64])
def test_dry_run_first_step_matches_the_unsharded_step_on_card(
        cuda_device, variant, nshards):
    """A dry-run cell's first step on slabs of one and two planes (both
    halos from the buffers) against the unsharded fused step on the same
    float32 state."""
    from repro_torch.configs.poisson_pcg import SolverConfig
    from repro_torch.core import pcg
    from repro_torch.core.state import PCGState
    from repro_torch.distributed.sharding import make_data_mesh
    from repro_torch.launch import dryrun

    sc = SolverConfig("pcg_64", (64, 64, 64), nshards, variant=variant)
    mesh = make_data_mesh(nshards, "cuda:0")
    step, spec = dryrun.cell_step(sc, mesh)
    _, structs = spec(*sc.grid)
    state = dryrun.cell_state(structs, mesh, torch.device(cuda_device))
    out = step(state)
    inv = torch.full((64 ** 3,), 1.0 / 6.0, device=cuda_device,
                     dtype=torch.float32)
    ref = pcg.make_step(lambda v: stencil7.stencil7_cuda(
        v.view(sc.grid)).view(-1), inv, 1)(PCGState(
            x=state["x"].reshape(-1), r=state["r"].reshape(-1),
            z=state["z"].reshape(-1), p=state["p"].reshape(-1),
            rz=state["rz"], beta_prev=state["rz"] * 0, k=0))
    for f in ("x", "r", "z", "p"):
        want = getattr(ref, f)
        torch.testing.assert_close(out[f].reshape(-1), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# ----------------------------------------------------------------------
# LM serving: each family's SMOKE model on the card against the CPU
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b", "moonshot_v1_16b_a3b",
                                  "mamba2_370m", "recurrentgemma_9b",
                                  "whisper_small", "qwen2_vl_72b"])
def test_lm_family_logits_on_card_match_the_cpu(cuda_device, arch):
    """f32 teacher-forced, prefill and decode logits of one SMOKE model,
    its parameters copied to the card, within the reference's decode
    tolerance (5e-4) of the same model on the CPU."""
    import copy

    from _torch_port import LM_TOL, lm_cfg, lm_inputs, to_torch
    from repro_torch.models import encdec, registry, transformer

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    b, s = 2, 20
    inputs = to_torch(lm_inputs(cfg, 7, b, s + 2))
    prefill = {k: (v[:, :s] if k == "tokens" and cfg.frontend != "vision"
                   else v) for k, v in inputs.items()}

    def run(model, dev):
        moved = {k: v.to(dev) for k, v in prefill.items()}
        with torch.inference_mode():
            if cfg.family == "encdec":
                enc = encdec.encode(model, moved["frames"], cfg)
                forced = encdec.decode(model, moved["tokens"], enc, cfg)[0]
            else:
                forced = transformer.decoder_forward(
                    model, moved["tokens"], cfg,
                    positions=moved.get("positions"))[0]
            caches = registry.init_caches(cfg, b, s + 2, device=dev)
            logits, caches = registry.make_prefill(cfg)(model, moved, caches)
            outs = [forced, logits]
            if cfg.frontend != "vision":
                tok = inputs["tokens"][:, s:s + 1].to(dev)
                outs.append(registry.make_decode(cfg)(model, tok, caches, s)[0])
        return [o.cpu() for o in outs]

    for got, want in zip(run(card, cuda_device), run(cpu, "cpu")):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) < LM_TOL


# ----------------------------------------------------------------------
# LM training: each family's SMOKE train step on the card against the CPU
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "dbrx_132b",
                                  "granite_20b", "starcoder2_3b", "llama3_8b",
                                  "gemma3_12b", "whisper_small", "mamba2_370m",
                                  "recurrentgemma_9b", "qwen2_vl_72b"])
def test_train_steps_on_card_match_the_cpu(cuda_device, arch):
    """Two f32 train steps of one SMOKE model (``make_train_step`` over
    ``make_train_forward``), its parameters carried to the card by
    ``convert``, against the same steps on the CPU: loss and grad norm
    within 1e-4 relative, every parameter element within 1e-4 relative
    plus twice the two steps' summed ``lr`` (the gradients sum in other
    orders on the card; where an element's gradient is near zero, Adam's
    normalised update can take either sign and move it by up to ``lr``
    a step either way: 3e-6 and 6e-6 in the warmup)."""
    from _torch_port import lm_cfg, to_torch, train_inputs
    from repro_torch import convert
    from repro_torch.models import registry
    from repro_torch.training import optimizer, train_step

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    card = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(cpu),
                                        device=cuda_device)
    batch = to_torch(train_inputs(cfg, 7, 2, 16))
    step = train_step.make_train_step(registry.make_train_forward(cfg),
                                      optimizer.AdamWConfig())
    runs = []
    for model, dev in ((card, cuda_device), (cpu, "cpu")):
        opt = optimizer.adamw_init(model)
        moved = {k: v.to(dev) for k, v in batch.items()}
        metrics = [step(model, opt, moved) for _ in range(2)]
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     {n: p.detach().cpu() for n, p in model.named_parameters()}))
    (got_m, got_p), (want_m, want_p) = runs
    for g, w in zip(got_m, want_m):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g[k], w[k])
        assert g["lr"] == w["lr"]
    for name, w in want_p.items():
        assert torch.isfinite(got_p[name]).all()
        excess = (got_p[name] - w).abs() - 2 * (3e-6 + 6e-6) - 1e-4 * w.abs()
        assert float(excess.max()) <= 0.0, (name, float(excess.max()))


@pytest.mark.cuda
def test_long_sequence_train_step_peaks_within_its_sizing(cuda_device):
    """granite_20b at full width cut to one pattern group takes one train
    step of one row of 16384 tokens.  Each attention chunk is
    checkpointed, so the backward holds one chunk's scores: the step's
    peak stays within the dry run's sizing of it (about 31 GB; with the
    layer's 48 x 16384^2 scores saved whole it was sized at 112 GB, over
    the card), and its loss and grad norm are finite."""
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.training import optimizer, train_step
    from repro_torch.training.data import SyntheticCorpus, to_tensors

    seq = 16384
    cfg = dryrun._depth_variant(registry.get_config("granite_20b"), 1)
    need = dryrun.variant_bytes(cfg, registry.Shape("train", "train", seq, 1),
                                1)["need"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = registry.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    opt = optimizer.adamw_init(model)
    corpus = SyntheticCorpus(vocab=cfg.vocab, batch=1, seq=seq, seed=0)
    step = train_step.make_train_step(registry.make_train_forward(cfg),
                                      optimizer.AdamWConfig())
    metrics = step(model, opt, to_tensors(corpus.batch_at(0), cuda_device))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert peak <= need, (peak, need)
    del model, opt, metrics
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the LM dry run: each kind's SMOKE cell on the card against the CPU
# ----------------------------------------------------------------------
def _to_device(obj, dev):
    """A cell's arguments (modules, tensors, dicts and lists of them) on
    ``dev``."""
    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, dev) for v in obj]
    return obj


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_dry_run_cell_on_card_matches_the_cpu(cuda_device, shape):
    """llama3_8b's SMOKE cell (f32 compute) at the dry run's smoke cut of
    ``shape``: its step on the card from the arguments ``cell_args``
    makes on the CPU (seed 0), against the same step on the CPU: the
    train step's loss and grad norm, or the logits, within 1e-5 of the
    largest magnitude; then ``run_cell`` on the card, whose row measures
    every variant and estimates the peak."""
    import dataclasses

    from repro_torch.launch import dryrun, mesh
    from repro_torch.distributed.sharding import AxisRules, DEFAULT_RULES
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config("llama3_8b", smoke=True),
                              compute_dtype="float32")
    rules = AxisRules(mesh.make_production_mesh(), dict(DEFAULT_RULES))
    cell = registry.build_cell(cfg, "llama3_8b",
                               dryrun._cell_shape(shape, True), rules)
    cpu = torch.device("cpu")
    outs = []
    for dev in (cuda_device, cpu):
        args = _to_device(dryrun.cell_args(cell, 2, cpu), dev)
        out = cell.fn(*args)
        outs.append([out["loss"], out["grad_norm"]] if shape == "train_4k"
                    else [out[0]])
    for got, want in zip(*outs):
        got = got.cpu()
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    row = dryrun.run_cell("llama3_8b", shape, False, None, verbose=False,
                          device="cuda", smoke=True)
    assert row["ok"] and row["device"]["name"]
    assert row["memory"]["peak_bytes"] >= row["memory"]["argument_bytes"]
    for var in row["measured"]["variants"].values():
        assert var["step_s"] > 0 and var["peak_bytes"] > 0 and var["finite"]
        assert var["step_q1_s"] <= var["step_s"] <= var["step_q3_s"]
        assert var["step_mode"] == ("graph" if shape == "decode_32k"
                                    else "eager")
        assert var["timed_steps"] >= dryrun.WARM_STEPS
    least, most = row["measured"]["replica_step_range_s"]
    assert 0 < least <= row["measured"]["replica_step_s"] <= most


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [2, 4])
def test_train_peak_split_bounds_a_larger_batch_on_card(cuda_device, cut):
    """llama3_8b's SMOKE train cell (128 tokens) run by ``run_variant`` on
    the card at 1 row and at ``cut`` rows: the 1-row variant's
    ``peak_split`` scaled by ``cut`` (:func:`scaled_peak`) bounds the
    ``cut``-row variant's non-argument peak within 10 %."""
    import dataclasses

    from repro_torch.launch import dryrun, mesh
    from repro_torch.distributed.sharding import AxisRules, DEFAULT_RULES
    from repro_torch.models import registry

    cfg = registry.get_config("llama3_8b", smoke=True)
    shape = dataclasses.replace(registry.SHAPES["train_4k"], seq=128, batch=4)
    rules = AxisRules(mesh.make_production_mesh(), dict(DEFAULT_RULES))
    cell = registry.build_cell(cfg, "llama3_8b", shape, rules)
    one, more = (dryrun.run_variant(cell, b, cuda_device, count=False)
                 for b in (1, cut))
    assert one["finite"] and more["finite"]
    est = dryrun.scaled_peak(one["peak_split"], cut)
    assert more["nonarg_peak_bytes"] <= est <= \
        1.1 * more["nonarg_peak_bytes"], (one["peak_split"], est, more)


# ----------------------------------------------------------------------
# the reference's compiled loops as CUDA graphs: recovery's local CG and
# the LM decode step
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 7, 1000])
def test_local_cg_graph_is_the_plain_loop_bitwise_on_card(cuda_device, chunk):
    """Recovery's local CG as replays of one captured chunk: ``x`` bitwise
    the plain loop's on the card at the same iteration, the launch
    counts holding every replay (one K1 halo-mode launch over the failed
    run and two det_dot a captured iteration), and within 1e-10 of the
    plain loop on the CPU."""
    from repro_torch.core import reconstruction as rec

    problem = _poisson(cuda_device, grid=32)
    failed = [1, 2]
    op = problem.op

    def apply_fn(u):
        return op.inblock_apply(u, failed)

    rhs = torch.from_numpy(rng_normal(3, 2 * op.partition.block_size)).to(
        cuda_device)
    plain = {}
    want = rec._local_cg_plain(apply_fn, rhs, info=plain)
    ops.reset_launch_counts()
    info = {}
    got = rec._local_cg_chunked(apply_fn, rhs, chunk=chunk, info=info)
    counts = ops.launch_counts()
    k = plain["iterations"]
    assert info["graph"] and info["iterations"] == k > 0
    assert torch.equal(got, want)
    size = min(chunk, 10_000)
    assert info["launches_per_chunk"]["stencil7_halo"] == size
    assert info["launches_per_chunk"]["stencil7"] == 0
    assert info["launches_per_chunk"]["det_dot"] == 2 * size
    # rhs.rhs, the warm-up iteration, the replays, the eager rerun
    assert counts["stencil7_halo"] == 1 + info["chunks"] * size + \
        info["eager_iterations"]
    assert counts["det_dot"] == 1 + 2 + 2 * (info["chunks"] * size +
                                             info["eager_iterations"])
    dispatched = rec._local_cg(apply_fn, rhs)
    assert torch.equal(dispatched, want)
    cpu = _poisson("cpu", grid=32)
    cpu_x = rec._local_cg_plain(lambda u: cpu.op.inblock_apply(u, failed),
                                rhs.cpu())
    torch.testing.assert_close(got.cpu(), cpu_x, rtol=1e-10, atol=1e-12)


def _serve(cfg, model, dev, frames=None):
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine

    prefill_fn = registry.make_prefill(cfg)

    def prefill(p, t, c):
        inputs = {"tokens": t}
        if frames is not None:
            inputs["frames"] = frames
        return prefill_fn(p, inputs, c)

    return prefill, ServeEngine(
        prefill, registry.make_decode(cfg),
        lambda b, s: registry.init_caches(cfg, b, s, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "moonshot_v1_16b_a3b",
                                  "starcoder2_3b", "mamba2_370m",
                                  "whisper_small"])
def test_decode_graph_is_the_eager_decode_bitwise_on_card(cuda_device, arch):
    """``ServeEngine.generate`` on the card (one eager decode step, then
    replays of one capture) against a hand-written eager loop over
    ``make_decode`` from the same prefill: every step's logits and the
    tokens bit for bit, past starcoder2's 32-slot ring; every decode
    step but the first a replay."""
    from _torch_port import lm_cfg, lm_inputs
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    model = registry.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    b, s, steps = 2, 28, 9
    np_in = lm_inputs(cfg, 4, b, s)
    prompt = torch.as_tensor(np_in["tokens"]).long().to(cuda_device)
    frames = (torch.as_tensor(np_in["frames"]).to(cuda_device)
              if cfg.family == "encdec" else None)
    prefill, eng = _serve(cfg, model, cuda_device, frames)
    seen = []
    out = eng.generate(model, prompt, steps,
                       on_step=lambda i, logits: seen.append(logits.clone()))
    assert eng.stats["graph"] and eng.stats["eager_steps"] == 1
    assert eng.stats["replays"] == steps - 2 and eng.stats["capture_s"] > 0
    with torch.inference_mode():
        caches = registry.init_caches(cfg, b, s + steps, device=cuda_device)
        logits, caches = prefill(model, prompt, caches)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        want = [tok]
        assert torch.equal(logits, seen[0])
        for i in range(1, steps):
            pos = torch.tensor(s + i - 1, dtype=torch.int32, device=cuda_device)
            logits, caches = registry.make_decode(cfg)(model, tok, caches, pos)
            assert torch.equal(logits, seen[i]), (arch, i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            want.append(tok)
    assert torch.equal(out, torch.cat(want, dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 12])
def test_engine_replays_every_decode_step_but_one_on_card(cuda_device, steps):
    """The engine's replay count: of ``steps - 1`` decode steps, one runs
    eagerly on the graph's stream and the rest are replays (no capture
    when no step would replay it)."""
    from _torch_port import lm_cfg
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config("gemma3_12b", smoke=True))
    model = registry.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 14))).to(cuda_device)
    _, eng = _serve(cfg, model, cuda_device)
    out = eng.generate(model, prompt, steps)
    assert out.shape == (2, steps) and out.dtype == prompt.dtype
    assert eng.stats["graph"]
    assert eng.stats["eager_steps"] == min(1, steps - 1)
    assert eng.stats["replays"] == max(0, steps - 2)


# ----------------------------------------------------------------------
# LM serving over a (data, model) device mesh
# ----------------------------------------------------------------------
def _mesh_serve(cfg, model, caches, tokens, prompt, steps):
    """The prefill's logits and each of ``steps`` teacher-forced decode
    steps', on the tokens' device."""
    from repro_torch.models import registry

    out = []
    with torch.inference_mode():
        logits, caches = registry.make_prefill(cfg)(model, tokens[:, :prompt],
                                                    caches)
        out.append(logits)
        for t in range(steps):
            logits, caches = registry.make_decode(cfg)(
                model, tokens[:, prompt + t:prompt + t + 1], caches, prompt + t)
            out.append(logits)
    return out


def _mesh_run(cfg, mesh, device, b=4, prompt=14, steps=3, max_seq=20):
    from repro_torch.models import registry

    model = registry.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        mesh=mesh)
    caches = registry.init_caches(cfg, b, max_seq, device=device, mesh=mesh)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (b, prompt + steps))).to(device)
    return _mesh_serve(cfg, model, caches, tokens, prompt, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel", [None, 2])
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b", "starcoder2_3b",
                                  "granite_20b", "dbrx_132b",
                                  "moonshot_v1_16b_a3b"])
def test_lm_mesh_serving_on_card_matches_one_device(cuda_device, arch,
                                                    model_parallel):
    """A SMOKE config on ``make_mesh_for(4)`` (the one card repeated, a
    stream a shard) and on the (2, 2) mesh: prefill and three decode
    steps within the reference's tolerance of the one-device run on the
    card (f32, MoE at capacity factor 16)."""
    from _torch_port import LM_TOL, lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    mesh = make_mesh_for(4, model_parallel, device="cuda:0")
    want = _mesh_run(cfg, None, "cuda:0")
    got = _mesh_run(cfg, mesh, "cuda:0")
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.device == w.device
        assert float((g - w).abs().max()) < LM_TOL, t


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel", [None, 2])
def test_lm_mesh_over_distinct_cards(cuda_device, model_parallel):
    """The (1, 4) and (2, 2) meshes with the shards on distinct cards
    (``make_mesh_for(4)``: card ``s * c // 4``): the logits bitwise the
    same mesh with every shard on one card.  Skips with fewer than two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two visible cards")
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    for arch in ("llama3_8b", "moonshot_v1_16b_a3b"):
        cfg = lm_cfg(registry.get_config(arch, smoke=True))
        cards = make_mesh_for(4, model_parallel)
        assert cards.distinct
        far = _mesh_run(cfg, cards, "cuda:0")
        near = _mesh_run(cfg, make_mesh_for(4, model_parallel,
                                            device="cuda:0"), "cuda:0")
        assert all(torch.equal(a, b) for a, b in zip(far, near)), arch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx_132b", "moonshot_v1_16b_a3b"])
def test_moe_block_over_a_mesh_on_card(cuda_device, arch):
    """The expert-parallel block on a (1, 4) mesh of the card against the
    one-device block (f32, default capacity): within the reference's
    tolerance, and its aux loss the same on every shard."""
    import dataclasses

    from _torch_port import LM_TOL
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import moe, registry

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              compute_dtype="float32")
    mesh = make_mesh_for(4, device="cuda:0")

    def block(m):
        return registry.init_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(0),
            device=cuda_device, mesh=m).layers[0].moe

    x = torch.randn(4, 12, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(5))
    with torch.inference_mode():
        want, aux = moe.moe(block(None), x, cfg)
        got, got_aux = moe.moe(block(mesh), sharding.place(
            x, mesh, (None, None, None)), cfg)
        got = sharding.to_whole(got)
    assert float((got - want).abs().max()) < LM_TOL
    assert all(torch.equal(a.to(cuda_device), got_aux.pieces[0])
               for a in got_aux.pieces)
    assert abs(float(got_aux.pieces[0]) - float(aux)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_370m", "whisper_small"])
def test_lm_mesh_families_on_card_match_one_device(cuda_device, arch):
    """mamba2's SSD stack and whisper's encoder-decoder (SMOKE, f32) on
    ``make_mesh_for(4)`` with the one card repeated, a stream a shard:
    prefill (whisper with its frames) and three teacher-forced decode
    steps within the reference's tolerance of the one-device run on the
    card."""
    from _torch_port import LM_TOL, lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    rng = np.random.default_rng(7)
    b, prompt, steps = 4, 14, 3
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, (b, prompt + steps))).to(cuda_device)
    inputs = {"tokens": tokens[:, :prompt]}
    if cfg.family == "encdec":
        inputs["frames"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(cuda_device)

    def run(mesh):
        model = registry.init_params(
            cfg, torch.Generator(device="cuda:0").manual_seed(0),
            device="cuda:0", mesh=mesh)
        caches = registry.init_caches(cfg, b, 20, device="cuda:0", mesh=mesh)
        out = []
        with torch.inference_mode():
            logits, caches = registry.make_prefill(cfg)(model, inputs, caches)
            out.append(logits)
            for t in range(prompt, prompt + steps):
                logits, caches = registry.make_decode(cfg)(
                    model, tokens[:, t:t + 1], caches, t)
                out.append(logits)
        return out

    want = run(None)
    got = run(make_mesh_for(4, device="cuda:0"))
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.device == w.device
        assert float((g - w).abs().max()) < LM_TOL, t


# ----------------------------------------------------------------------
# the decode step over a (data, model) mesh as a CUDA graph
# ----------------------------------------------------------------------
def _mesh_graph_inputs(cfg, b, s, dev):
    """Seeded prompt token ids ``(b, s)`` on ``dev`` and the prefill that
    serves them: with frames for the encoder-decoder; patch embeddings
    and three M-RoPE streams (the ids only give the prompt's shape) for
    the vision frontend."""
    from repro_torch.models import registry

    rng = np.random.default_rng(11)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frontend == "vision":
        extra = {"embeds": torch.as_tensor(rng.standard_normal(
                     (b, s, cfg.d_model)).astype(np.float32)).to(dev),
                 "positions": torch.as_tensor(rng.integers(
                     0, 4 * s, (3, b, s))).to(dev)}
    prefill_fn = registry.make_prefill(cfg)

    def prefill(model, tokens, caches):
        inputs = {"tokens": tokens, **extra}
        if "embeds" in extra:
            inputs = {"tokens": extra["embeds"],
                      "positions": extra["positions"]}
        return prefill_fn(model, inputs, caches)

    return prompt, prefill


def _placed_equal(a, b) -> bool:
    from repro_torch.models import registry

    return all(x.spec == y.spec and all(torch.equal(p, q) for p, q in
                                        zip(x.pieces, y.pieces))
               for (_, x), (_, y) in zip(registry.placed_leaves(a),
                                         registry.placed_leaves(b)))


def _mesh_decode_graph_vs_eager(cfg, mesh, dev, b=4, s=14, steps=7,
                                max_seq=20):
    """Greedy ``ServeEngine.generate`` on ``mesh`` against a hand-written
    eager loop over ``make_decode`` from its own prefill (0-d tensor
    positions): the engine's stats, each step's logits and the tokens;
    then ``steps - 1`` teacher-forced steps through one ``DecodeGraph``
    (one eager step, then replays) against the eager steps, the logits
    and every cache piece after them bit for bit."""
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import DecodeGraph

    model = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        mesh=mesh)
    prompt, prefill = _mesh_graph_inputs(cfg, b, s, dev)
    decode = registry.make_decode(cfg)

    def caches():
        return registry.init_caches(cfg, b, max_seq, device=dev, mesh=mesh)

    eng = ServeEngine(prefill, decode, lambda bb, ss: caches())
    seen = []
    out = eng.generate(model, prompt, steps,
                       on_step=lambda i, logits: seen.append(logits.clone()))
    stats = dict(eng.stats)
    with torch.inference_mode():
        logits, c = prefill(model, prompt, caches())
        assert torch.equal(logits, seen[0])
        tok = torch.argmax(logits[:, -1:], dim=-1)
        want = [tok]
        for i in range(1, steps):
            pos = torch.tensor(s + i - 1, dtype=torch.int32, device=dev)
            logits, c = decode(model, tok, c, pos)
            assert torch.equal(logits, seen[i]), (cfg.name, i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            want.append(tok)
    assert torch.equal(out, torch.cat(want, dim=1))
    # teacher-forced: the graph's caches against the eager caches
    toks = [out[:, i:i + 1] for i in range(steps - 1)]
    runs = []
    for graph in (False, True):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        logits_seen = []
        with torch.cuda.stream(stream), torch.inference_mode():
            _, c = prefill(model, prompt, caches())
            for t, tok in enumerate(toks):
                if t == 0 or not graph:
                    pos = torch.full((), s + t, dtype=torch.int32, device=dev)
                    logits, c = decode(model, tok, c, pos)
                else:
                    if t == 1:
                        step = DecodeGraph(decode, model, tok, c, stream)
                    logits = step(tok, s + t)
                logits_seen.append(logits.clone())
            mesh.fork()
        torch.cuda.current_stream(dev).wait_stream(stream)
        runs.append((logits_seen, c))
    mesh.synchronize()
    for t, (g, e) in enumerate(zip(runs[1][0], runs[0][0])):
        assert torch.equal(g, e), (cfg.name, t)
    assert _placed_equal(runs[1][1], runs[0][1]), cfg.name
    return stats, out, step


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel", [None, 2])
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma3_12b", "starcoder2_3b",
                                  "granite_20b", "dbrx_132b",
                                  "moonshot_v1_16b_a3b", "mamba2_370m",
                                  "recurrentgemma_9b", "whisper_small",
                                  "qwen2_vl_72b"])
def test_lm_mesh_decode_graph_is_the_eager_mesh_decode_on_card(
        cuda_device, arch, model_parallel):
    """The ten SMOKE configs (f32) on a (1, 4) and a (2, 2) mesh of the
    one card, a stream a shard: the engine captures the decode step (one
    eager step, the rest replays), its logits and tokens are an eager
    loop's bit for bit, and a graph's caches after teacher-forced steps
    are the eager steps' (gemma3's and recurrentgemma's 16-slot rings
    wrap at position 16)."""
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    mesh = make_mesh_for(4, model_parallel, device="cuda:0")
    steps = 7
    stats, _, _ = _mesh_decode_graph_vs_eager(cfg, mesh, "cuda:0",
                                              steps=steps)
    assert stats["graph"] and stats["eager_steps"] == 1, stats
    assert stats["replays"] == steps - 2 and stats["capture_s"] > 0, stats


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel", [None, 2])
@pytest.mark.parametrize("arch", ["llama3_8b", "moonshot_v1_16b_a3b",
                                  "mamba2_370m", "whisper_small"])
def test_lm_mesh_decode_graph_over_distinct_cards(cuda_device, arch,
                                                  model_parallel):
    """A mesh over distinct cards (``make_mesh_for(4)``, card ``s * c //
    4``): the engine captures its decode step too, and the replays are
    the eager steps and the one-card mesh's bit for bit; the capture's
    allocations on the other cards lie in private pools of the graph's
    pool id there; the replays stay bitwise while the other cards
    allocate and fill memory between and during them.  Skips with fewer
    than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two visible cards")
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    far = make_mesh_for(4, model_parallel)
    assert far.distinct
    near = make_mesh_for(4, model_parallel, device="cuda:0")
    steps = 7
    stats, got, graph = _mesh_decode_graph_vs_eager(cfg, far, "cuda:0",
                                                    steps=steps)
    assert stats["graph"] and stats["replays"] == steps - 2, stats
    cards = sorted({d.index for d in far.devices} - {0})
    pool = tuple(graph.graph.pool())
    pooled = {seg["device"] for seg in torch.cuda.memory_snapshot()
              if tuple(seg["segment_pool_id"]) == pool}
    assert pooled == {0, *cards}, (pooled, cards)
    del graph
    _, want, _ = _mesh_decode_graph_vs_eager(cfg, near, "cuda:0", steps=steps)
    assert torch.equal(got, want)
    # the other cards' memory churned while the replays run
    model = registry.init_params(
        cfg, torch.Generator(device="cuda:0").manual_seed(0),
        device="cuda:0", mesh=far)
    prompt, prefill = _mesh_graph_inputs(cfg, 4, 14, "cuda:0")

    def churn(i, logits):
        for d in cards:
            with torch.cuda.device(d):
                for n in (1 << 10, 1 << 16, 1 << 20):
                    torch.full((n,), float("nan"), device=d)

    seen = []
    eng = ServeEngine(prefill, registry.make_decode(cfg),
                      lambda b, s: registry.init_caches(cfg, b, s, mesh=far))
    out = eng.generate(model, prompt, steps, on_step=lambda i, logits: (
        churn(i, logits), seen.append(logits.clone())))
    assert eng.stats["replays"] == steps - 2
    assert torch.equal(out, want)
    assert all(bool(torch.isfinite(x[..., :cfg.vocab]).all()) for x in seen)


# ----------------------------------------------------------------------
# LM training over a (data, model) mesh on the card
# ----------------------------------------------------------------------
def _mesh_train_run(cfg, mesh, device, steps=2, seed=4, batch=4, seq=32):
    """``steps`` train steps of ``cfg`` on ``mesh`` (or one device) over
    the batch ``train_inputs`` draws from ``seed``, from the parameters a
    CPU generator seeded 0 draws (carried by ``convert``, so the card and
    the CPU start from the same values): the metrics of each step, and
    every parameter and moment gathered whole on the host."""
    from _torch_port import to_torch, train_inputs
    from repro_torch import convert
    from repro_torch.models import registry
    from repro_torch.training import optimizer, train_step

    tree = convert.lm_params_to_numpy(registry.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    model = convert.lm_params_from_numpy(cfg, tree, device=device, mesh=mesh)
    opt = optimizer.adamw_init(model)
    step = train_step.make_train_step(registry.make_train_forward(cfg),
                                      optimizer.AdamWConfig())
    inputs = {k: v.to(device) for k, v in
              to_torch(train_inputs(cfg, seed, batch, seq)).items()}
    metrics = [{k: v.cpu() for k, v in step(model, opt, inputs).items()}
               for _ in range(steps)]
    return metrics, convert.train_state_to_numpy(model, opt)


def _flat_state(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat_state(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def _same_runs(a, b) -> bool:
    (ma, sa), (mb, sb) = a, b
    return (all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)
            and all(np.array_equal(x, y) for (_, x), (_, y) in
                    zip(_flat_state(sa), _flat_state(sb))))


#: a decoder LM, an MoE and the other four families: the SSD heads, the
#: RG-LRU channels, the encoder-decoder with
#: its tied embedding's two uses, the patch embeddings with M-RoPE
MESH_TRAIN_ARCHS = ["llama3_8b", "moonshot_v1_16b_a3b", "mamba2_370m",
                    "recurrentgemma_9b", "whisper_small", "qwen2_vl_72b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MESH_TRAIN_ARCHS)
def test_lm_mesh_train_step_on_card_bitwise_and_matches_the_cpu(cuda_device,
                                                               arch):
    """A SMOKE config (f32, the MoE at capacity factor 16) trained two
    steps on the (1, 4) mesh of the one card, a stream a shard: two runs
    bitwise equal (the MoE's gathers, the checkpointed layers'
    recomputes on the shard streams and their backward included), and
    within 1e-4 of each leaf's scale of the same mesh on the CPU."""
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    cfg = lm_cfg(registry.get_config(arch, smoke=True))
    first = _mesh_train_run(cfg, make_mesh_for(4, device="cuda:0"), "cuda:0")
    again = _mesh_train_run(cfg, make_mesh_for(4, device="cuda:0"), "cuda:0")
    assert _same_runs(first, again)
    cpu = _mesh_train_run(cfg, make_mesh_for(4, device="cpu"), "cpu")
    for got, want in zip(first[0], cpu[0]):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(got[k]) - float(want[k])) <= \
                1e-4 * abs(float(want[k])), k
    for (key, got), (_, want) in zip(_flat_state(first[1]),
                                     _flat_state(cpu[1])):
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
        assert float(np.abs(got - want).max() if want.size else 0.0) \
            <= 1e-4 * scale, key


def _rel_off(got, want) -> float:
    """The largest ``|got - want|`` over ``want``'s largest magnitude."""
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    return float(np.abs(got - want).max() if want.size else 0.0) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4, 5])
def test_mamba2_mesh_moments_differ_from_one_device_as_the_cpu_does(
        cuda_device, seed):
    """mamba2_370m at full width cut to 2 layers, f32, two steps of 2 x 64
    on the (2, 2) mesh of the one card, on one device of the card and on
    the CPU, all from the same parameters: each leaf's first moment (its
    ``a_log`` rows alone too: a sum over the batch, the positions and the
    head's channels, whose terms cancel) as far from the card's one-device
    run on the mesh as the CPU's one-device run is, within 1e-4 of the
    leaf's scale and within 4x the CPU's distance (at least 1e-6).  A
    mesh fault would show as a distance that the CPU's summation order
    does not have.  The readings are printed as one JSON line."""
    import dataclasses
    import json

    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    cfg = dataclasses.replace(lm_cfg(registry.get_config("mamba2_370m")),
                              n_layers=2)
    run = dict(seed=seed, batch=2, seq=64)
    card = _mesh_train_run(cfg, None, "cuda:0", **run)[1]
    mesh = _mesh_train_run(cfg, make_mesh_for(4, 2, device="cuda:0"),
                           "cuda:0", **run)[1]
    cpu = _mesh_train_run(cfg, None, "cpu", **run)[1]
    out, worst = {}, {}
    for (key, c), (_, m), (_, h) in zip(_flat_state(card), _flat_state(mesh),
                                        _flat_state(cpu)):
        if not key.startswith("opt/m/"):
            continue
        rows = ([(f"{key}[{i}]", c[i], m[i], h[i]) for i in range(len(c))]
                if key.endswith("a_log") else [(key, c, m, h)])
        for name, c_, m_, h_ in rows:
            off = dict(mesh_vs_card=_rel_off(m_, c_),
                       cpu_vs_card=_rel_off(h_, c_),
                       mesh_vs_cpu=_rel_off(m_, h_))
            if "a_log" in name:
                out[name] = off
            if off["mesh_vs_card"] > worst.get("mesh_vs_card", -1.0):
                worst = dict(leaf=name, **off)
            assert off["mesh_vs_card"] <= 1e-4, (name, off)
            assert off["mesh_vs_card"] <= max(4 * off["cpu_vs_card"],
                                               1e-6), (name, off)
    print(json.dumps({"seed": seed, "a_log": out, "worst": worst}))


@pytest.mark.cuda
@pytest.mark.parametrize("model_parallel", [None, 2])
def test_lm_mesh_train_over_distinct_cards(cuda_device, model_parallel):
    """The (1, 4) and (2, 2) meshes with the shards on distinct cards:
    two train steps of each family bitwise the same mesh with every
    shard on one card (metrics, parameters and moments; the whisper
    decoder's tied embedding takes its lookup's and its logits' partials
    on one shard, whatever order the cards' autograd threads run in).
    Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two visible cards")
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry

    for arch in MESH_TRAIN_ARCHS:
        cfg = lm_cfg(registry.get_config(arch, smoke=True))
        cards = make_mesh_for(4, model_parallel)
        assert cards.distinct
        far = _mesh_train_run(cfg, cards, "cuda:0")
        near = _mesh_train_run(cfg, make_mesh_for(4, model_parallel,
                                                  device="cuda:0"), "cuda:0")
        assert _same_runs(far, near), arch


@pytest.mark.cuda
def test_decode_graph_capture_starts_with_nothing_cached_unused(
        cuda_device, monkeypatch):
    """The engine's capture starts with no segment of the regular pool
    held cached and unused on the mesh's cards: ``DecodeGraph`` gives
    them back first, so the graph's private pool can take that memory
    (a 256 MiB block freed before the run is such a segment)."""
    from _torch_port import lm_cfg
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine, engine

    cfg = lm_cfg(registry.get_config("llama3_8b", smoke=True))
    mesh = make_mesh_for(4, device="cuda:0")
    cards = {d.index for d in mesh.devices}
    model = registry.init_params(
        cfg, torch.Generator(device="cuda:0").manual_seed(0), mesh=mesh)
    seen = []
    capturing = engine.capturing

    def watched(*args, **kwargs):
        seen.append([seg for seg in torch.cuda.memory_snapshot()
                     if seg["device"] in cards and seg["allocated_size"] == 0
                     and tuple(seg.get("segment_pool_id", (0, 0)))
                     == (0, 0)])
        return capturing(*args, **kwargs)

    monkeypatch.setattr(engine, "capturing", watched)
    block = torch.empty(1 << 28, dtype=torch.uint8, device="cuda:0")
    del block
    assert any(seg["allocated_size"] == 0
               for seg in torch.cuda.memory_snapshot())
    prompt = torch.randint(0, cfg.vocab, (4, 14), device="cuda:0",
                           generator=torch.Generator(device="cuda:0")
                           .manual_seed(1))
    eng = ServeEngine(registry.make_prefill(cfg), registry.make_decode(cfg),
                      lambda b, s: registry.init_caches(cfg, b, s, mesh=mesh))
    eng.generate(model, prompt, 5)
    assert eng.stats["replays"] == 3
    assert seen == [[]]
