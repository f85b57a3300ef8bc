"""Order-pinned block-hierarchical reductions, the sharded stencil, and
the sharded PCG grid steps (port of ``repro/core/spmv.py``).

The solve's inner products combine per-partition-block partial sums in a
fixed left-to-right order, so the trajectory does not depend on how a
library happens to reassociate a global sum, nor on how the blocks are
spread over shards.  On CUDA tensors :func:`make_det_dot` runs kernel
K2's block-partial reduction (``ops.det_dot``), the same code the fused
update uses for ``rz'``.

Under a data mesh (:class:`repro_torch.distributed.sharding.DataMesh`:
the shards of a z-slab row-block distribution, each a contiguous run of
partition blocks and so a whole-plane slab of the grid) every reduction
runs shard by shard: each shard writes out the block sums of its own
blocks (det_dot's and K2's lane modes with one lane a block, whose block
sums are bitwise those the unsharded launch chains), the sums are
gathered in block order, and one left-to-right chain over all
``nblocks`` sums finishes the reduction.  The stencil runs K1's halo
mode once per shard, on its slab, with the two neighbouring planes
copied into halo buffers first (the reference's ``ppermute``).  Vectors
stay full-length tensors on the mesh's one device, so a sharded solve is
bitwise the unsharded one by construction.  Sums are bitwise for float64
and float32; bfloat16 block sums round to bfloat16 before the chain.

:func:`make_sharded_pcg_step` and :func:`make_shardmap_pcg_step` are the
reference's sharded grid iterations (its dry-run and roofline path) on
dict states of ``(nz, ny, nx)`` grids, z-sharded over the mesh: the
local stencil is K1's halo mode and the update K2.  The reference's
``lower_pcg_step`` returns an XLA ``Lowered`` for its dry-run launcher
and has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_cg import chain_plain


def _nshards(mesh, axes=("data",)) -> int:
    nshards = 1
    for axis in axes:
        nshards *= int(mesh.shape[axis])
    return nshards


def _shard_views(a: torch.Tensor, nblocks: int, nshards: int
                 ) -> List[torch.Tensor]:
    """Shard ``s``'s blocks of the flat ``a`` as a ``(blocks_per_shard,
    block_size)`` view."""
    bps = nblocks // nshards
    return list(a.reshape(nshards, bps, -1).unbind(0))


def _gather_block_sums(a: torch.Tensor, b: torch.Tensor, nblocks: int,
                       nshards: int) -> torch.Tensor:
    """Each shard's block sums of ``a * b`` (one det_dot lane-mode launch
    a shard), gathered in block order: ``(nblocks,)``."""
    sums = torch.empty(nblocks, dtype=a.dtype, device=a.device)
    bps = nblocks // nshards
    for s, (a_s, b_s) in enumerate(zip(_shard_views(a, nblocks, nshards),
                                       _shard_views(b, nblocks, nshards))):
        ops.det_dot_lanes(a_s, b_s, out=sums[s * bps:(s + 1) * bps])
    return sums


def make_det_dot(nblocks: int, mesh=None):
    """Build ``dot(a, b)``: per-block partials, then a left-to-right chain
    over the ``nblocks`` partials; a 0-d tensor on ``a``'s device.  With
    ``mesh`` (the 1-D ``data`` mesh of a sharded operator) each shard
    computes its own blocks' partials; the result is bitwise the
    unsharded one."""
    if mesh is None:
        def det_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return ops.det_dot(a, b, nblocks)
        return det_dot

    nshards = _nshards(mesh)

    def mesh_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return chain_plain(_gather_block_sums(a, b, nblocks, nshards))

    return mesh_dot


def make_det_rowdots(nblocks: int, mesh=None):
    """Row-batched :func:`make_det_dot`: ``rowdots(M, w)[i] ==
    det_dot(M[i], w)`` bitwise for an ``(rows, n)`` matrix — the Arnoldi
    projection shape — with the order pinned within each block too (each
    row is a det_dot launch on CUDA, and its block sums gathered shard by
    shard under ``mesh``), so it does not depend on the row count or the
    sharding."""
    dot = make_det_dot(nblocks, mesh)

    def det_rowdots(m_rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.stack([dot(row, w) for row in m_rows.unbind(0)])

    return det_rowdots


def sharded_fused_update(x, r, p, ap, alpha: torch.Tensor,
                         inv_diag: torch.Tensor, nblocks: int, nshards: int):
    """K2 once per shard of flat vectors, one lane a partition block
    (``alpha`` repeated per lane): ``x', r', z'`` written into
    full-length outputs and each shard's ``r' z'`` block sums gathered in
    block order, ``(nblocks,)``.  ``x', r', z'`` are bitwise the
    unsharded ``nblocks`` launch's, and so is the chain of the sums."""
    bps = nblocks // nshards
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    sums = torch.empty(nblocks, dtype=x.dtype, device=x.device)
    alphas = alpha.reshape(1).repeat(bps)
    views = [_shard_views(t, nblocks, nshards)
             for t in (x, r, p, ap, inv_diag, xo, ro, zo)]
    for s, (xs, rs, ps, aps, invs, *out) in enumerate(zip(*views)):
        *_, rz = ops.fused_cg_update_lanes(xs, rs, ps, aps, alphas, invs,
                                           out=out)
        sums[s * bps:(s + 1) * bps].copy_(rz)
    return xo, ro, zo, sums


# ----------------------------------------------------------------------
# The sharded stencil: K1's halo mode once per z-slab shard
# ----------------------------------------------------------------------
def halo_nbytes(grid: Tuple[int, int, int], nshards: int,
                dtype: torch.dtype) -> int:
    """Bytes one sharded apply moves between shards: each of the
    ``nshards - 1`` shard boundaries sends one plane each way."""
    _, ny, nx = grid
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * (nshards - 1) * ny * nx * itemsize


def sharded_stencil7(u: torch.Tensor, nshards: int) -> torch.Tensor:
    """``A u`` on the ``(nz, ny, nx)`` grid ``u`` split into ``nshards``
    z-slabs: each shard's halo planes are copied into two small buffers
    (none at the domain's boundary, which reads as zero), then K1's halo
    mode runs once per shard, writing its slab of one output.  Bitwise
    ``ops.stencil7(u)``."""
    nz = u.shape[0]
    if nz % nshards != 0:
        raise ValueError(f"nz={nz} not divisible by nshards={nshards}")
    u = u.contiguous()
    out = torch.empty_like(u)
    slab = nz // nshards
    halos = [(None if s == 0 else u[s * slab - 1].clone(),
              None if s == nshards - 1 else u[(s + 1) * slab].clone())
             for s in range(nshards)]
    for s, (lo, hi) in enumerate(halos):
        z = slice(s * slab, (s + 1) * slab)
        ops.stencil7_halo(u[z], lo, hi, out=out[z])
    return out


# ----------------------------------------------------------------------
# The sharded PCG grid steps (the reference's dry-run / roofline path)
# ----------------------------------------------------------------------
def _grid_update(x, r, p, ap, alpha, inv6, nshards: int):
    """K2 once per z-slab shard of the grids, one lane a shard: ``x', r',
    z'`` grids and the ``(nshards,)`` shard sums of ``r' z'``."""
    flat = (t.reshape(-1) for t in (x, r, p, ap))
    xo, ro, zo, sums = sharded_fused_update(*flat, alpha, inv6.reshape(-1),
                                            nshards, nshards)
    return xo.view(x.shape), ro.view(x.shape), zo.view(x.shape), sums


def _mesh_axes(mesh, shard_axes) -> Tuple[str, ...]:
    return tuple(a for a in shard_axes if a in mesh.axis_names)


def _grid_spec(mesh, axes, esr_mode: str, grid_dtype: torch.dtype,
               rz_dtype: torch.dtype):
    """``spec(nz, ny, nx) -> (shardings, structs)``: each field's
    placement (the mesh axes a grid is z-sharded over, ``None`` for a
    replicated value) and its shape and dtype as a ``meta`` tensor."""

    def spec(nz: int, ny: int, nx: int):
        grid = torch.empty((nz, ny, nx), dtype=grid_dtype, device="meta")
        scalar = torch.empty((), dtype=rz_dtype, device="meta")
        shardings = dict(x=axes, r=axes, z=axes, p=axes, rz=None)
        structs = dict(x=grid, r=grid, z=grid, p=grid, rz=scalar)
        if esr_mode == "inmemory":
            shardings["esr_red_cur"] = None
            structs["esr_red_cur"] = grid
        return shardings, structs

    return spec


def _inv6(p: torch.Tensor, cache: Dict) -> torch.Tensor:
    """The Jacobi ``M^{-1} = 1/6`` as the vector K2 reads, one per grid
    shape, dtype and device."""
    key = (tuple(p.shape), p.dtype, p.device)
    inv = cache.get(key)
    if inv is None:
        inv = cache[key] = torch.full_like(p, 1.0 / 6.0)
    return inv


def make_sharded_pcg_step(mesh, shard_axes=("pod", "data", "model"),
                          esr_mode: str = "nvm",
                          dtype: torch.dtype = torch.float32
                          ) -> Tuple[Callable, Callable]:
    """Build ``(step_fn, spec_fn)`` for one sharded PCG iteration on a
    dict state of ``(nz, ny, nx)`` grids (``x, r, z, p``) and the 0-d
    ``rz``, z-sharded over ``mesh``.  ``A p`` is K1's halo mode shard by
    shard; ``p.Ap`` and ``r'z'`` are the dtype's own sums (block sums a
    shard, chained); the update is K2 with Jacobi's ``1/6``.  With
    ``esr_mode="inmemory"`` the step also keeps the replicated ``p`` of
    the last two iterations (``esr_red_prev``, ``esr_red_cur``: the
    peer-RAM redundancy of Algorithm 2, a full copy each)."""
    axes = _mesh_axes(mesh, shard_axes)
    nshards = _nshards(mesh, axes)
    cache: Dict = {}

    def step(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, r, p, rz = state["x"], state["r"], state["p"], state["rz"]
        ap = sharded_stencil7(p, nshards)                 # halo exchange on z
        pap = chain_plain(_gather_block_sums(p.reshape(-1), ap.reshape(-1),
                                             nshards, nshards))
        alpha = rz / pap
        xn, rn, zn, sums = _grid_update(x, r, p, ap, alpha, _inv6(p, cache),
                                        nshards)
        rz_new = chain_plain(sums)
        beta = rz_new / rz
        pn = zn + beta * p
        out = dict(x=xn, r=rn, z=zn, p=pn, rz=rz_new, beta=beta)
        if esr_mode == "inmemory":
            out["esr_red_prev"] = state["esr_red_cur"]
            out["esr_red_cur"] = pn.clone()
        return out

    return step, _grid_spec(mesh, axes, esr_mode, dtype, dtype)


def make_shardmap_pcg_step(mesh, shard_axes=("pod", "data", "model"),
                           esr_mode: str = "nvm",
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[Callable, Callable]:
    """The reference's explicit-halo iteration: each shard exchanges one
    plane with each neighbour (the information-theoretic minimum) and
    reduces to float32 shard sums, which a ``psum`` combines (here a
    left-to-right chain in float32); ``rz`` and the sums are float32
    whatever the grid's dtype, and ``alpha``/``beta`` are cast back to
    it.  Float64 grids sum each shard at float64 and round the shard sum
    to float32.  Same state and spec as :func:`make_sharded_pcg_step`,
    with a float32 ``rz``."""
    axes = _mesh_axes(mesh, shard_axes)
    nshards = _nshards(mesh, axes)
    cache: Dict = {}

    def psum(sums: torch.Tensor) -> torch.Tensor:
        return chain_plain(sums.to(torch.float32))

    def step(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, r, p, rz = state["x"], state["r"], state["p"], state["rz"]
        ap = sharded_stencil7(p, nshards)
        pap = psum(_gather_block_sums(p.reshape(-1), ap.reshape(-1),
                                      nshards, nshards))
        alpha = (rz / pap).to(p.dtype)
        xn, rn, zn, sums = _grid_update(x, r, p, ap, alpha, _inv6(p, cache),
                                        nshards)
        rz_new = psum(sums)
        beta = (rz_new / rz).to(p.dtype)
        pn = zn + beta * p
        out = dict(x=xn, r=rn, z=zn, p=pn, rz=rz_new, beta=beta)
        if esr_mode == "inmemory":
            out["esr_red_prev"] = state["esr_red_cur"]
            out["esr_red_cur"] = pn.clone()
        return out

    return step, _grid_spec(mesh, axes, esr_mode, dtype, torch.float32)


def nvm_persist_host(state: Dict[str, torch.Tensor]) -> np.ndarray:
    """NVM-ESR persistence tap: pull ``p``'s shards to the host, in shard
    order (one device holds every shard, so all are addressable).  No
    collective, no device memory."""
    return state["p"].detach().reshape(-1).cpu().numpy()
