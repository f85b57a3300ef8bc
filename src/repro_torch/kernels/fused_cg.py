"""K2: the fused PCG vector update (Algorithm 1 lines 4-7a), hand-written
CUDA for Hopper, the block-partial reduction it shares with ``det_dot``,
K4 (the same update plus the erasure stripe's staging of ``p``), and the
plain PyTorch versions of all three.

Replaces ``src/repro/kernels/fused_cg.py::fused_cg_update_pallas`` (the
TPU kernel ``_fused_cg_kernel`` with its per-tile partials and
``jnp.sum`` epilogue).  On the H100 the update is bound by memory: 5
reads and 3 writes of ``n`` values, a few flops each.
``csrc/fused_cg.cu`` does it in one pass, reads ``alpha`` from device
memory, and reduces ``r'.z'`` without atomics in its arithmetic, in a
fixed order (per-thread sums, lane and warp trees, per-partition-block
folds, a left-to-right chain over the ``nblocks`` block sums) in the
same launch: the CTA that takes a block's last ticket folds it.
``det_dot`` runs the same tiling and the same reduction on ``a * b``, so
the solve's ``p.ap``, its ``rz'`` and reconstruction's recomputed ``rz``
share one rounding order.  :func:`det_dot_order_plain` repeats that
order step by step in torch (tests and ``chip_smoke.py`` hold the
kernels to it bitwise; nothing on the main path calls it).

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

The lane mode of K2 and ``det_dot`` (:func:`fused_cg_update_lanes_cuda`,
:func:`det_dot_lanes_cuda`) serves the multi-tenant service's bucket
step, where the reference vmaps one lane's step over a ``(lanes, n)``
bucket: the same kernels with ``nblocks = lanes``, ``alpha`` read per
lane and the lane sums returned unfolded (no chain), so each lane's
outputs are bitwise a solo ``nblocks=1`` launch on that lane.  Their
plain versions (:func:`fused_cg_update_lanes_plain`,
:func:`det_dot_lanes_plain`) call the solo plain reduction lane by lane,
so on the CPU too a lane's bits do not depend on the lane count.
"""
from __future__ import annotations

import ctypes
import math
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
#: K2 lane-mode launches since the last reset
update_lanes_launches = 0
#: det_dot lane-mode launches since the last reset
dot_lanes_launches = 0

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
#: the reduction's tiling, as ``csrc/fused_cg.cu`` defines it: THREADS
#: threads a CTA in WARPS warps, ITEMS values a thread, TILE values a CTA
THREADS, WARPS, ITEMS = 256, 8, 8
TILE = THREADS * ITEMS


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


def _tree(v: torch.Tensor) -> torch.Tensor:
    """Pairwise tree over the last dimension (a power of two): lane ``i``
    adds lane ``i + h`` for h = half the width, then half again."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _cta_tree(v: torch.Tensor) -> torch.Tensor:
    """Step 2 over the last dimension of THREADS per-thread values: the
    tree over each warp's 32 lanes, then over the WARPS warp sums."""
    return _tree(_tree(v.reshape(*v.shape[:-1], WARPS, 32)))


def _sequential(v: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum from +0 over the last dimension."""
    total = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for i in range(v.shape[-1]):
        total = total + v[..., i]
    return total


def det_dot_order_plain(a: torch.Tensor, b: torch.Tensor,
                        nblocks: int = 1) -> torch.Tensor:
    """``det_dot`` in the CUDA kernel's exact order, from torch operations
    (round-to-nearest ``*`` and ``+``), so it equals the kernel bitwise:

    1. per thread of each tile, its ITEMS products from +0, group by group
       (group ``g`` of thread ``t`` is the ``16 / itemsize`` values at tile
       offset ``(g * THREADS + t) * 16 / itemsize``), zero past the block;
    2. per tile, the lane tree, then the warp tree;
    3. per partition block, thread ``t`` adds tile partials ``t, t +
       THREADS, ...`` from +0, then the tree of step 2;
    4. a left-to-right chain over the block sums.

    Padding adds +0, which changes no sum (a sum begun at +0 is never
    -0).  Tests and ``chip_smoke.py`` use it; the main path does not."""
    acc = acc_dtype(a.dtype)
    bs = a.shape[0] // nblocks
    tiles = -(-bs // TILE)
    vec = 16 // a.element_size()
    prod = (a.to(acc) * b.to(acc)).reshape(nblocks, bs)
    prod = torch.nn.functional.pad(prod, (0, tiles * TILE - bs))
    groups = prod.reshape(nblocks, tiles, ITEMS // vec, THREADS, vec)
    per_thread = groups.transpose(2, 3).reshape(nblocks, tiles, THREADS, ITEMS)
    tile_sums = _cta_tree(_sequential(per_thread))
    rounds = -(-tiles // THREADS)
    tile_sums = torch.nn.functional.pad(tile_sums, (0, rounds * THREADS - tiles))
    block_sums = _cta_tree(_sequential(
        tile_sums.reshape(nblocks, rounds, THREADS).transpose(1, 2)))
    total = block_sums[0]
    for i in range(1, nblocks):
        total = total + block_sums[i]
    return total.to(a.dtype)


def _update_vectors_plain(x, r, p, ap, alpha: torch.Tensor, inv_diag):
    """``x' = x + alpha p``, ``r' = r - alpha ap``, ``z' = r' inv_diag``
    with ``alpha`` (of ``x.dtype``) broadcast against the vectors
    (bfloat16 computed in float32, rounded once)."""
    dtype = x.dtype
    acc = acc_dtype(dtype)
    a = alpha.to(acc)
    xn = (x.to(acc) + a * p.to(acc)).to(dtype)
    rn = (r.to(acc) - a * ap.to(acc)).to(dtype)
    zn = (rn.to(acc) * inv_diag.to(acc)).to(dtype)
    return xn, rn, zn


def fused_cg_update_plain(x, r, p, ap, alpha, inv_diag, nblocks: int = 1
                          ) -> Tuple[torch.Tensor, ...]:
    """``x' = x + alpha p``, ``r' = r - alpha ap``, ``z' = r' inv_diag``,
    ``rz' = <r', z'>`` (bfloat16 computed in float32, rounded once)."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    xn, rn, zn = _update_vectors_plain(x, r, p, ap, alpha, inv_diag)
    return xn, rn, zn, block_dot_plain(rn, zn, nblocks)


def _check(name: str, tensors, shape: Tuple[int, ...], nblocks: int) -> int:
    """Validate the inputs of a launch over ``shape`` (``(n,)``, or
    ``(lanes, n)`` in lane mode); returns the value count."""
    first = tensors[0]
    device, dtype = first.device, first.dtype
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    if dtype not in DTYPES:
        raise TypeError(f"{name} takes {DTYPES}, got {dtype}")
    shape = tuple(shape)
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: every input must share device and "
                             f"dtype ({device}, {dtype})")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous tensors "
                             f"of shape {shape}")
    n = math.prod(shape)
    if n < 1:
        raise ValueError(f"{name}: empty input")
    if nblocks < 1 or n % nblocks != 0:
        raise ValueError(f"{name}: n={n} not divisible by nblocks={nblocks}")
    return n


def _check_alpha(name: str, alpha, x: torch.Tensor, count: int) -> None:
    """``alpha`` must be a ``count``-element tensor of ``x``'s dtype on
    its device (the kernel reads it through its pointer)."""
    if not (isinstance(alpha, torch.Tensor) and alpha.numel() == count
            and alpha.device == x.device and alpha.dtype == x.dtype):
        raise ValueError(f"{name}: alpha must be a {count}-element "
                         f"{x.dtype} tensor on {x.device}")


def _lane_shape(name: str, x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name}: lane mode takes (lanes, n) tensors, got "
                         f"shape {tuple(x.shape)}")
    return tuple(x.shape)


#: (symbol, dtype) -> bound C function, so a launch looks it up once
_FUNCTIONS = {}


def _function(symbol: str, dtype: torch.dtype, nptr: int, extra=()):
    """``<symbol>_<f64|f32|bf16>``: nptr pointers, then (n, nblocks,
    device, stream, *extra)."""
    fn = _FUNCTIONS.get((symbol, dtype))
    if fn is None:
        fn = _FUNCTIONS[(symbol, dtype)] = _build.function(
            "fused_cg", f"{symbol}_{_SUFFIX[dtype]}",
            [ctypes.c_void_p] * nptr + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p, *extra])
    return fn


#: 0-d results handed out from one pool before a new pool is made
SCALAR_SLOTS = 4096


class _Workspace:
    """The reduction's scratch on one stream of one device: tile partials
    and block sums (float64 slots, read as the accumulation type), the
    ticket counters (zeroed once; every launch leaves them at 0), and
    pools of 0-d results.  Launches on one stream run in order, so they
    share it.  Each result is a view of a pool slot, made ahead in one
    ``unbind`` and handed out once, never reused (a spent pool lives on
    only through its views), which costs the host less per call than
    allocating a tensor.  ``allocations`` counts the tensors the
    workspace has made, so a CUDA-graph capture can check it made
    none."""

    def __init__(self, device: torch.device):
        self.device = device
        self.partials = self.tickets = None
        self.slots = 0
        self.pools = {}
        self.allocations = 0

    def reserve(self, slots: int, counters: int) -> None:
        if self.slots < slots or self.tickets.numel() < counters:
            self.slots = max(self.slots, slots)
            self.partials = torch.empty(self.slots, dtype=torch.float64,
                                        device=self.device)
            self.tickets = torch.zeros(max(counters, 0 if self.tickets is None
                                           else self.tickets.numel()),
                                       dtype=torch.int32, device=self.device)
            self.partials_ptr = self.partials.data_ptr()
            self.tickets_ptr = self.tickets.data_ptr()
            self.allocations += 2

    def reserve_scalars(self, dtype: torch.dtype, count: int) -> list:
        """Make sure the next ``count`` results of ``dtype`` come from the
        current pool (a new pool if fewer are left); returns the pool's
        views, whose storage the caller may keep alive."""
        pool = self.pools.get(dtype)
        if pool is None or len(pool) < count:
            pool = torch.empty(max(count, SCALAR_SLOTS), dtype=dtype,
                               device=self.device).unbind()[::-1]
            pool = self.pools[dtype] = list(pool)
            self.allocations += 1
        return list(pool)

    def scalar(self, dtype: torch.dtype) -> torch.Tensor:
        pool = self.pools.get(dtype)
        if not pool:
            self.reserve_scalars(dtype, 1)
            pool = self.pools[dtype]
        return pool.pop()


#: (device index, stream) -> _Workspace
_WORKSPACE = {}
#: (device index, stream, n, nblocks) -> (device index, stream,
#: _Workspace reserved for that geometry)
_LAUNCH = {}


def _launch_args(x: torch.Tensor, nblocks: int):
    """``(device, stream, workspace)`` for a launch on ``x``'s device and
    current stream, the workspace holding ``nblocks * (tiles + 1)``
    partial slots and ``nblocks + 1`` tickets; the tile count is worked
    out once per ``(n, nblocks)``, ``n = x.numel()``.  The stream handle
    is the one ``torch.cuda.current_stream`` wraps, read without building
    a Stream object per launch."""
    device = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(device)
    key = (device, stream, x.numel(), nblocks)
    args = _LAUNCH.get(key)
    if args is None:
        ws = _WORKSPACE.get(key[:2])
        if ws is None:
            ws = _WORKSPACE[key[:2]] = _Workspace(x.device)
        ws.reserve(nblocks * (-(-(x.numel() // nblocks) // TILE) + 1),
                   nblocks + 1)
        args = _LAUNCH[key] = (device, stream, ws)
    return args


def workspace(x: torch.Tensor, nblocks: int) -> _Workspace:
    """The workspace the kernels of this module use for ``x``'s geometry
    on ``x``'s device and the current stream (reserved for it)."""
    return _launch_args(x, nblocks)[2]


def fused_cg_update_cuda(x, r, p, ap, alpha, inv_diag, nblocks: int = 1
                         ) -> Tuple[torch.Tensor, ...]:
    """Launch K2; ``alpha`` is a one-element tensor of ``x.dtype`` on the
    same device (read by the kernel through its pointer)."""
    global update_launches
    n = _check("fused_cg_update", (x, r, p, ap, inv_diag), (x.numel(),),
               nblocks)
    _check_alpha("fused_cg_update_cuda", alpha, x, 1)
    fn = _function("fused_cg_update", x.dtype, 12)
    alpha = alpha.contiguous()
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    device, stream, ws = _launch_args(x, nblocks)
    rz = ws.scalar(x.dtype)
    rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
            inv_diag.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
            ro.data_ptr(), zo.data_ptr(), ws.partials_ptr, ws.tickets_ptr,
            rz.data_ptr(), n, nblocks, device, stream)
    if rc != 0:
        raise RuntimeError(f"fused_cg_update kernel launch failed: CUDA "
                           f"error {rc}")
    update_launches += 1
    return xo, ro, zo, rz


def det_dot_cuda(a: torch.Tensor, b: torch.Tensor,
                 nblocks: int = 1) -> torch.Tensor:
    """Launch the block-partial reduction of ``a * b`` (K2's tiling and
    order, one launch)."""
    global dot_launches
    n = _check("det_dot", (a, b), (a.numel(),), nblocks)
    fn = _function("det_dot", a.dtype, 5)
    device, stream, ws = _launch_args(a, nblocks)
    out = ws.scalar(a.dtype)
    rc = fn(a.data_ptr(), b.data_ptr(), ws.partials_ptr, ws.tickets_ptr,
            out.data_ptr(), n, nblocks, device, stream)
    if rc != 0:
        raise RuntimeError(f"det_dot kernel launch failed: CUDA error {rc}")
    dot_launches += 1
    return out


# ----------------------------------------------------------------------
# Lane mode: one launch over a (lanes, n) bucket, one result a lane
# ----------------------------------------------------------------------
def det_dot_lanes_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner products of two ``(lanes, n)`` tensors: lane ``i``
    is :func:`block_dot_plain` of ``a[i]`` and ``b[i]`` over one block,
    computed lane by lane.  Returns ``(lanes,)``."""
    return torch.stack([block_dot_plain(a[i], b[i], 1)
                        for i in range(a.shape[0])])


def fused_cg_update_lanes_plain(x, r, p, ap, alpha, inv_diag
                                ) -> Tuple[torch.Tensor, ...]:
    """:func:`fused_cg_update_plain` on every lane of ``(lanes, n)``
    tensors with ``alpha`` one value a lane: ``(x', r', z', rz')``,
    ``rz'`` of shape ``(lanes,)``."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    xn, rn, zn = _update_vectors_plain(x, r, p, ap, alpha.reshape(-1, 1),
                                       inv_diag)
    return xn, rn, zn, det_dot_lanes_plain(rn, zn)


def fused_cg_update_lanes_cuda(x, r, p, ap, alpha, inv_diag
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch K2 in lane mode on ``(lanes, n)`` tensors; ``alpha`` holds
    one value a lane (read by the kernel through its pointer)."""
    global update_lanes_launches
    shape = _lane_shape("fused_cg_update_lanes", x)
    lanes = shape[0]
    n = _check("fused_cg_update_lanes", (x, r, p, ap, inv_diag), shape, lanes)
    _check_alpha("fused_cg_update_lanes_cuda", alpha, x, lanes)
    fn = _function("fused_cg_update_lanes", x.dtype, 12)
    alpha = alpha.contiguous()
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    rz = torch.empty(lanes, dtype=x.dtype, device=x.device)
    device, stream, ws = _launch_args(x, lanes)
    rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
            inv_diag.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
            ro.data_ptr(), zo.data_ptr(), ws.partials_ptr, ws.tickets_ptr,
            rz.data_ptr(), n, lanes, device, stream)
    if rc != 0:
        raise RuntimeError(f"fused_cg_update_lanes kernel launch failed: "
                           f"CUDA error {rc}")
    update_lanes_launches += 1
    return xo, ro, zo, rz


def det_dot_lanes_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch det_dot in lane mode on ``(lanes, n)`` tensors; returns
    ``(lanes,)``."""
    global dot_lanes_launches
    shape = _lane_shape("det_dot_lanes", a)
    lanes = shape[0]
    n = _check("det_dot_lanes", (a, b), shape, lanes)
    fn = _function("det_dot_lanes", a.dtype, 5)
    out = torch.empty(lanes, dtype=a.dtype, device=a.device)
    device, stream, ws = _launch_args(a, lanes)
    rc = fn(a.data_ptr(), b.data_ptr(), ws.partials_ptr, ws.tickets_ptr,
            out.data_ptr(), n, lanes, device, stream)
    if rc != 0:
        raise RuntimeError(f"det_dot_lanes kernel launch failed: CUDA error "
                           f"{rc}")
    dot_lanes_launches += 1
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
    n = _check("fused_cg_update_persist", (x, r, p, ap, inv_diag),
               (x.numel(),), nblocks)
    chunk = check_stripe(n, nblocks, k_data, nparity)
    _check_alpha("fused_cg_update_persist_cuda", alpha, x, 1)
    fn = _function("fused_cg_update_persist", x.dtype, 12,
                   (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int))
    alpha = alpha.contiguous()
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    chunks = torch.empty((nblocks, k_data, chunk), dtype=x.dtype,
                         device=x.device)
    parity = torch.empty((nblocks, nparity, chunk * x.element_size()),
                         dtype=torch.uint8, device=x.device)
    device, stream, ws = _launch_args(x, nblocks)
    rz = ws.scalar(x.dtype)
    rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
            inv_diag.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
            ro.data_ptr(), zo.data_ptr(), ws.partials_ptr, ws.tickets_ptr,
            rz.data_ptr(), n, nblocks, device, stream, chunks.data_ptr(),
            parity.data_ptr(), k_data, nparity)
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
