"""K1: the 7-point Poisson stencil SpMV (the PCG hot spot), hand-written
CUDA for Hopper, and its plain PyTorch version.

Replaces ``src/repro/kernels/stencil7.py::stencil7_pallas`` (the TPU
z-slab kernel ``_stencil7_kernel``).  On the H100 the stencil is bound by
memory: 7 flops per point against one read of ``u`` and one write of the
output (16 bytes a point in float64).  ``csrc/stencil7.cu`` marches each
thread along z with the z-1/z/z+1 values in registers, threads
contiguous along x, so ``u`` comes from device memory about once; the
source note there has the details.  The TPU kernel's ``bz`` z-block was a
VMEM tiling choice: this kernel takes any ``(nz, ny, nx)`` and masks the
domain boundary itself.

Both versions take ``(..., nz, ny, nx)``: leading dimensions are a batch
(recovery's dense local solve applies ``A`` to the columns of an
identity).  float64, float32 and bfloat16 are supported; bfloat16 is
computed in float32 and rounded once.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: kernel launches since the last reset (the main-path proof counter)
launches = 0

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
_SYMBOL = {torch.float64: "stencil7_f64", torch.float32: "stencil7_f32",
           torch.bfloat16: "stencil7_bf16"}
#: (u, out, batch, nz, ny, nx, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def stencil7_plain(u: torch.Tensor) -> torch.Tensor:
    """``6u`` minus the six face neighbours, homogeneous Dirichlet
    boundary, on the last three dimensions of ``u``."""
    dtype = u.dtype
    v = u.to(_acc_dtype(dtype))
    p = F.pad(v, (1, 1, 1, 1, 1, 1))
    out = (6.0 * v
           - p[..., :-2, 1:-1, 1:-1]
           - p[..., 2:, 1:-1, 1:-1]
           - p[..., 1:-1, :-2, 1:-1]
           - p[..., 1:-1, 2:, 1:-1]
           - p[..., 1:-1, 1:-1, :-2]
           - p[..., 1:-1, 1:-1, 2:])
    return out.to(dtype)


def stencil7_cuda(u: torch.Tensor) -> torch.Tensor:
    """Launch K1 on a contiguous CUDA tensor ``(..., nz, ny, nx)``."""
    global launches
    if u.device.type != "cuda":
        raise ValueError(f"stencil7_cuda needs a CUDA tensor, got {u.device}")
    if u.dtype not in DTYPES:
        raise TypeError(f"stencil7_cuda takes {DTYPES}, got {u.dtype}")
    if u.dim() < 3:
        raise ValueError(f"stencil7 needs (..., nz, ny, nx), got shape "
                         f"{tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("stencil7_cuda needs a contiguous tensor")
    fn = _build.function("stencil7", _SYMBOL[u.dtype], _ARGTYPES)
    out = torch.empty_like(u)
    nz, ny, nx = u.shape[-3:]
    batch = math.prod(u.shape[:-3])
    if out.numel() == 0:
        return out
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), out.data_ptr(), batch, nz, ny, nx,
                torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil7 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
