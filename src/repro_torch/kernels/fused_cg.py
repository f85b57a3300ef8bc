"""K2: the fused PCG vector update (Algorithm 1 lines 4-7a), hand-written
CUDA for Hopper, the block-partial reduction it shares with ``det_dot``,
K4 (the same update plus the erasure stripe's staging of ``p``), and the
plain PyTorch versions of all three.

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

K4 replaces ``fused_cg_update_persist_pallas`` (the TPU kernel
``_make_persist_kernel``): K2's update, and from the same pass the
stripe chunks of the input ``p`` (``(nblocks, K, block_size / K)``, ``p``
in its own order) and their GF(2^8) P/Q parity bytes
(``(nblocks, P, block_size / K * itemsize)`` uint8), byte for byte what
``ErasureSession._shards`` and ``gf256.rs_encode`` make of the same
``p``.  It is K2's CUDA kernel instantiated with staging on, so its
``x', r', z', rz'`` are bitwise K2's.  It needs ``K | block_size``; the
reference's ``128 | block_size`` rule was (8, 128) TPU tiling and is
dropped, as K2 dropped it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gf256_encode import gf256_rs_encode_plain
from repro_torch.nvm import gf256

#: fused-update launches since the last reset
update_launches = 0
#: det_dot launches since the last reset
dot_launches = 0
#: fused update+staging (K4) launches since the last reset
persist_launches = 0

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


# ----------------------------------------------------------------------
# K4: the fused update plus the erasure stripe's staging of ``p``
# ----------------------------------------------------------------------
def check_stripe(n: int, nblocks: int, k_data: int, nparity: int) -> int:
    """Validate K4's geometry (the reference's error texts); returns the
    chunk length ``block_size // k_data``."""
    if nblocks < 1 or n % nblocks != 0:
        raise ValueError(f"n={n} not divisible by nblocks={nblocks}")
    bs = n // nblocks
    if bs % k_data != 0:
        raise ValueError(
            f"block_size={bs} not divisible by k_data={k_data}: the "
            f"stripe pads chunks, which the fused pass does not model")
    gf256.vandermonde(nparity, k_data)
    return bs // k_data


def stripe_bytes(chunks: torch.Tensor) -> torch.Tensor:
    """The ``(K, nblocks * chunk * itemsize)`` uint8 data shards of a
    ``(nblocks, K, chunk)`` chunk array: shard ``j`` is chunk ``j`` of
    every block, in block order (the stripe's logical data shard)."""
    return (chunks.transpose(0, 1).contiguous()
            .view(torch.uint8).reshape(chunks.shape[1], -1))


def fused_cg_update_persist_plain(x, r, p, ap, alpha, inv_diag, nblocks: int,
                                  k_data: int, nparity: int):
    """K2's plain update, then the chunks of ``p`` and their parity:
    ``(x', r', z', rz', chunks, parity)``."""
    chunk = check_stripe(p.shape[0], nblocks, k_data, nparity)
    xn, rn, zn, rz = fused_cg_update_plain(x, r, p, ap, alpha, inv_diag,
                                           nblocks)
    chunks = p.reshape(nblocks, k_data, chunk).clone()
    parity = gf256_rs_encode_plain(stripe_bytes(chunks), nparity)
    parity = parity.reshape(nparity, nblocks, -1).transpose(0, 1).contiguous()
    return xn, rn, zn, rz, chunks, parity


def fused_cg_update_persist_cuda(x, r, p, ap, alpha, inv_diag, nblocks: int,
                                 k_data: int, nparity: int):
    """Launch K4; ``alpha`` as for :func:`fused_cg_update_cuda`."""
    global persist_launches
    n = x.shape[0] if x.dim() == 1 else -1
    _check("fused_cg_update_persist", (x, r, p, ap, inv_diag), n, nblocks)
    chunk = check_stripe(n, nblocks, k_data, nparity)
    if not (isinstance(alpha, torch.Tensor) and alpha.numel() == 1
            and alpha.device == x.device and alpha.dtype == x.dtype):
        raise ValueError("fused_cg_update_persist_cuda: alpha must be a "
                         f"one-element {x.dtype} tensor on {x.device}")
    fn = _build.function(
        "fused_cg", f"fused_cg_update_persist_{_SUFFIX[x.dtype]}",
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    alpha = alpha.contiguous()
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    rz = torch.empty((), dtype=x.dtype, device=x.device)
    partials = _partials(x, nblocks)
    chunks = torch.empty((nblocks, k_data, chunk), dtype=x.dtype,
                         device=x.device)
    parity = torch.empty((nblocks, nparity, chunk * x.element_size()),
                         dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
                inv_diag.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
                ro.data_ptr(), zo.data_ptr(), partials.data_ptr(),
                rz.data_ptr(), n, nblocks,
                torch.cuda.current_stream(x.device).cuda_stream,
                chunks.data_ptr(), parity.data_ptr(), k_data, nparity)
    if rc != 0:
        raise RuntimeError(f"fused_cg_update_persist kernel launch failed: "
                           f"CUDA error {rc}")
    persist_launches += 1
    return xo, ro, zo, rz, chunks, parity


def fused_pass_traffic(n: int, itemsize: int, k_data: int,
                       nparity: int) -> dict:
    """Device-memory traffic of the fused update+staging pass: the bare
    update moves 5n reads + 3n writes; staging adds the chunk emission
    (n values) and the parity emission (n * P/K values) as writes — the
    encode's reads ride on the ``p`` read the update already does."""
    update_read = 5 * n * itemsize
    update_write = 3 * n * itemsize
    staged_write = n * itemsize + (n * itemsize * nparity) // k_data
    total = update_read + update_write + staged_write
    return {
        "update_read_bytes": update_read,
        "update_write_bytes": update_write,
        "staged_write_bytes": staged_write,
        "total_bytes": total,
        # share of the fused pass's traffic that is persist staging
        "persist_bw_fraction": staged_write / total,
        # what a standalone staging pass would add: re-read the vector
        # (n) plus the same writes — the traffic the fusion removes
        "unfused_extra_read_bytes": n * itemsize,
    }
