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
from repro_torch.kernels import fused_cg, ops, stencil7


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
    # the fused rz' and det_dot(r', z') share one rounding order
    assert torch.equal(fused_cg.det_dot_cuda(got[1], got[2], nblocks), got[3])


@pytest.mark.cuda
def test_ops_dispatch_launches_kernels_on_card(cuda_device):
    ops.reset_launch_counts()
    u = torch.ones(8, 8, 8, dtype=torch.float64, device=cuda_device)
    v = u.reshape(-1)
    ops.stencil7(u)
    ops.det_dot(v, v, 4)
    ops.fused_cg_update(v, v, v, v, torch.tensor(1.0, dtype=torch.float64,
                                                 device=cuda_device), v, 4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"stencil7": 1, "fused_cg_update": 1,
                                   "det_dot": 1}
