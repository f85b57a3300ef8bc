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
    graph = pcg._ChunkGraph(body, step, op.nblocks)
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
    assert torch.equal(sharded.state.x, plain.state.x)
    assert sharded.iterations == plain.iterations
    assert sharded.report.nshards == 4
    assert sharded.report.recovery_fetch_bytes_by_shard == {
        1: plain.report.recovery_fetch_bytes}
    assert counts[0]["stencil7_halo"] > 0
    assert counts[0]["fused_cg_update_lanes"] > 0
    assert counts[0]["det_dot_lanes"] > 0
    assert counts[0]["fused_cg_update_persist"] == 0


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
