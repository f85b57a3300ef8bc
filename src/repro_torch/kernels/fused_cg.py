"""K2: the fused PCG vector update (Algorithm 1 lines 4-7a), hand-written
CUDA for Hopper, the block-partial reduction it shares with ``det_dot``,
and the plain PyTorch versions of both.

Replaces ``src/repro/kernels/fused_cg.py::fused_cg_update_pallas`` (the
TPU kernel ``_fused_cg_kernel`` with its per-tile partials and
``jnp.sum`` epilogue).  On the H100 the update is bound by memory: 5
reads and 3 writes of ``n`` values, a few flops each.
``csrc/fused_cg.cu`` does it in one pass, reads ``alpha`` from device
memory, and reduces ``r'.z'`` without atomics in a fixed order: per-tile
partials, per-partition-block partials, then a left-to-right chain over
the ``nblocks`` block partials.  ``det_dot`` runs the same tiling and the
same reduction on ``a * b``, so the solve's ``p.ap``, its ``rz'`` and
reconstruction's recomputed ``rz`` share one rounding order.

Precision: float64 inputs accumulate in float64 (the main path's ``rz``
is a float64 dot; the reference kernel's fp32 downcast would break it),
float32 and bfloat16 accumulate in float32 (the TPU kernel's contract).
The TPU kernel's ``n % 128`` and ``bm`` rules were (8, 128) tiling rules;
this kernel takes any ``n`` divisible by ``nblocks`` and masks ragged
tiles.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: fused-update launches since the last reset
update_launches = 0
#: det_dot launches since the last reset
dot_launches = 0

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type of the reduction for inputs of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def block_dot_plain(a: torch.Tensor, b: torch.Tensor,
                    nblocks: int) -> torch.Tensor:
    """Order-pinned inner product: per-partition-block partial sums, then
    a left-to-right chain (the reference's ``make_det_dot``).  Returns a
    0-d tensor of ``a.dtype``."""
    acc = acc_dtype(a.dtype)
    partials = (a.to(acc) * b.to(acc)).reshape(nblocks, -1).sum(dim=1)
    total = partials[0]
    for i in range(1, nblocks):
        total = total + partials[i]
    return total.to(a.dtype)


def fused_cg_update_plain(x, r, p, ap, alpha, inv_diag, nblocks: int = 1
                          ) -> Tuple[torch.Tensor, ...]:
    """``x' = x + alpha p``, ``r' = r - alpha ap``, ``z' = r' inv_diag``,
    ``rz' = <r', z'>`` (bfloat16 computed in float32, rounded once)."""
    dtype = x.dtype
    acc = acc_dtype(dtype)
    a = torch.as_tensor(alpha, dtype=dtype, device=x.device).to(acc)
    xn = (x.to(acc) + a * p.to(acc)).to(dtype)
    rn = (r.to(acc) - a * ap.to(acc)).to(dtype)
    zn = (rn.to(acc) * inv_diag.to(acc)).to(dtype)
    return xn, rn, zn, block_dot_plain(rn, zn, nblocks)


def _check(name: str, tensors, n: int, nblocks: int) -> None:
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {first.device}")
    if first.dtype not in DTYPES:
        raise TypeError(f"{name} takes {DTYPES}, got {first.dtype}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: every input must share device and "
                             f"dtype ({first.device}, {first.dtype})")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous 1-D "
                             f"vectors of length {n}")
    if n < 1:
        raise ValueError(f"{name}: empty input")
    if nblocks < 1 or n % nblocks != 0:
        raise ValueError(f"{name}: n={n} not divisible by nblocks={nblocks}")


def _function(symbol: str, nptr: int):
    # nptr pointers, then (n, nblocks, stream)
    return _build.function(
        "fused_cg", symbol,
        [ctypes.c_void_p] * nptr + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p])


def _partials(x: torch.Tensor, nblocks: int) -> torch.Tensor:
    """Scratch for the per-tile partial sums of every partition block."""
    tiles = _build.function("fused_cg", "fused_cg_tiles", [ctypes.c_longlong],
                            ctypes.c_longlong)(x.shape[0] // nblocks)
    return torch.empty(nblocks * tiles, dtype=acc_dtype(x.dtype),
                       device=x.device)


def fused_cg_update_cuda(x, r, p, ap, alpha, inv_diag, nblocks: int = 1
                         ) -> Tuple[torch.Tensor, ...]:
    """Launch K2; ``alpha`` is a one-element tensor of ``x.dtype`` on the
    same device (read by the kernel through its pointer)."""
    global update_launches
    n = x.shape[0] if x.dim() == 1 else -1
    _check("fused_cg_update", (x, r, p, ap, inv_diag), n, nblocks)
    if not (isinstance(alpha, torch.Tensor) and alpha.numel() == 1
            and alpha.device == x.device and alpha.dtype == x.dtype):
        raise ValueError("fused_cg_update_cuda: alpha must be a one-element "
                         f"{x.dtype} tensor on {x.device}")
    fn = _function(f"fused_cg_update_{_SUFFIX[x.dtype]}", 11)
    alpha = alpha.contiguous()
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    rz = torch.empty((), dtype=x.dtype, device=x.device)
    partials = _partials(x, nblocks)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
                inv_diag.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
                ro.data_ptr(), zo.data_ptr(), partials.data_ptr(),
                rz.data_ptr(), n, nblocks,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_cg_update kernel launch failed: CUDA "
                           f"error {rc}")
    update_launches += 1
    return xo, ro, zo, rz


def det_dot_cuda(a: torch.Tensor, b: torch.Tensor,
                 nblocks: int = 1) -> torch.Tensor:
    """Launch the block-partial reduction of ``a * b`` (K2's tiling)."""
    global dot_launches
    n = a.shape[0] if a.dim() == 1 else -1
    _check("det_dot", (a, b), n, nblocks)
    fn = _function(f"det_dot_{_SUFFIX[a.dtype]}", 4)
    out = torch.empty((), dtype=a.dtype, device=a.device)
    partials = _partials(a, nblocks)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), partials.data_ptr(),
                out.data_ptr(), n, nblocks,
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"det_dot kernel launch failed: CUDA error {rc}")
    dot_launches += 1
    return out
