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
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"stencil7": 1, "fused_cg_update": 1,
                                   "det_dot": 1, "gf256_rs_encode": 1,
                                   "fused_cg_update_persist": 1}


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
