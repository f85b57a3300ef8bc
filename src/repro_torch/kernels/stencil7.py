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

The halo mode (:func:`stencil7_halo_cuda`, :func:`stencil7_halo_plain`)
serves a sharded apply: one launch per z-slab shard, on the slab
``(nz_s, ny, nx)`` with the neighbouring shards' boundary planes handed
in as two ``(ny, nx)`` halo planes (``None`` at the domain's boundary:
zero), as the reference's ``ppermute`` delivers them.  The same kernel
runs with the halo planes in place of the zero fill, so the slabs'
outputs side by side are bitwise one full launch's.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: kernel launches since the last reset (the main-path proof counter)
launches = 0
#: halo-mode launches since the last reset
halo_launches = 0

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
_SYMBOL = {torch.float64: "stencil7_f64", torch.float32: "stencil7_f32",
           torch.bfloat16: "stencil7_bf16"}
#: (u, out, batch, nz, ny, nx, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_HALO_SYMBOL = {dtype: symbol.replace("stencil7_", "stencil7_halo_")
                for dtype, symbol in _SYMBOL.items()}
#: (u, lo, hi, out, nz, ny, nx, stream); a null lo / hi reads as zero
_HALO_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p)


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


# ----------------------------------------------------------------------
# Halo mode: one z-slab shard with its two halo planes
# ----------------------------------------------------------------------
def stencil7_halo_plain(u: torch.Tensor, lo, hi, out=None) -> torch.Tensor:
    """``A u`` on the planes of the slab ``u`` ``(nz_s, ny, nx)``, the
    plane below it being ``lo`` and the plane above it ``hi`` (``(ny,
    nx)`` each, ``None`` for zero); the same operations in the same order
    as :func:`stencil7_plain`.  Written into ``out`` when given."""
    dtype = u.dtype
    acc = _acc_dtype(dtype)
    v = u.to(acc)

    def plane(h):
        return (torch.zeros_like(v[0]) if h is None else h.to(acc))[None]

    zm = torch.cat([plane(lo), v[:-1]])
    zp = torch.cat([v[1:], plane(hi)])
    p = F.pad(v, (1, 1, 1, 1))
    res = (6.0 * v - zm - zp
           - p[:, :-2, 1:-1] - p[:, 2:, 1:-1]
           - p[:, 1:-1, :-2] - p[:, 1:-1, 2:]).to(dtype)
    if out is None:
        return res
    return out.copy_(res)


def _check_halo(u: torch.Tensor, lo, hi, out) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"stencil7_halo_cuda needs a CUDA tensor, got "
                         f"{u.device}")
    if u.dtype not in DTYPES:
        raise TypeError(f"stencil7_halo_cuda takes {DTYPES}, got {u.dtype}")
    if u.dim() != 3 or u.numel() == 0 or not u.is_contiguous():
        raise ValueError(f"stencil7_halo needs a contiguous non-empty "
                         f"(nz, ny, nx) slab, got shape {tuple(u.shape)}")
    for name, t, shape in (("lo", lo, u.shape[1:]), ("hi", hi, u.shape[1:]),
                           ("out", out, u.shape)):
        if t is None:
            continue
        if (t.device != u.device or t.dtype != u.dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"stencil7_halo: {name} must be a contiguous "
                             f"{u.dtype} tensor of shape {tuple(shape)} on "
                             f"{u.device}")


def stencil7_halo_cuda(u: torch.Tensor, lo, hi, out=None) -> torch.Tensor:
    """Launch K1 in halo mode on the contiguous CUDA slab ``u``; ``lo``
    and ``hi`` are its halo planes or ``None``; the result goes to
    ``out`` (a contiguous tensor of ``u``'s shape, such as the slab's
    view of a full output) or to a new tensor."""
    global halo_launches
    _check_halo(u, lo, hi, out)
    fn = _build.function("stencil7", _HALO_SYMBOL[u.dtype], _HALO_ARGTYPES)
    if out is None:
        out = torch.empty_like(u)
    nz, ny, nx = u.shape
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), None if lo is None else lo.data_ptr(),
                None if hi is None else hi.data_ptr(), out.data_ptr(),
                nz, ny, nx, torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stencil7_halo kernel launch failed: CUDA error "
                           f"{rc}")
    halo_launches += 1
    return out
