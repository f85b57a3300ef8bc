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
partition blocks and so a whole-plane slab of the grid) a vector is a
:class:`~repro_torch.distributed.sharding.ShardedVector`, one slab a
shard on the shard's device, and every reduction runs shard by shard:
each shard writes out the block sums of its own blocks on its own stream
(det_dot's and K2's lane modes with one lane a block, whose block sums
are bitwise those the unsharded launch chains), the sums move to shard
0's device in block order, and one left-to-right chain over all
``nblocks`` sums finishes the reduction.  The stencil runs K1's halo
mode once per slab, after moving the two neighbouring planes into its
shard (the reference's ``ppermute``).  So a sharded solve is bitwise
the unsharded one by construction, whether the shards share a card or
not.  Sums are bitwise for float64 and float32; bfloat16 block sums
round to bfloat16 before the chain.

:func:`make_sharded_pcg_step` and :func:`make_shardmap_pcg_step` are the
reference's sharded grid iterations (its dry-run and roofline path) on
dict states of ``(nz, ny, nx)`` grids, z-sharded over the mesh: the
local stencil is K1's halo mode and the update K2.  A state of plain
grids of one device runs on the mesh's views of them; a state of
sharded grids (:class:`~repro_torch.distributed.sharding.ShardedVector`
s of ``(nz / n, ny, nx)`` slabs, placed by ``DataMesh.place``, on a
mesh of one card or of distinct cards) runs each slab on its shard, as
a sharded solve does, and is bitwise the views' step.  The reference's
``lower_pcg_step`` returns an XLA ``Lowered`` for its dry-run launcher
and has no counterpart here.
"""
from __future__ import annotations

import contextlib
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


def _slabs(t: torch.Tensor, nshards: int):
    """``(slabs, mesh)``: a sharded vector's slabs and its mesh, or for a
    plain tensor ``nshards`` contiguous views of it and ``None`` (every
    shard on its one device: the grid steps)."""
    slabs = getattr(t, "slabs", None)
    if slabs is not None:
        return slabs, t.mesh
    return t.reshape(nshards, -1).unbind(0), None


def slab_block_sums(a_slabs, b_slabs, nblocks: int, mesh=None
                    ) -> torch.Tensor:
    """Each shard's block sums of ``a * b`` (one det_dot lane-mode launch
    a shard, on its device and stream), moved in block order to shard
    0's device: ``(nblocks,)``.  With no mesh the slabs are views of one
    tensor and everything runs on the current stream."""
    bps = nblocks // len(a_slabs)
    dev = a_slabs[0].device if mesh is None else mesh.device
    sums = torch.empty(nblocks, dtype=a_slabs[0].dtype, device=dev)
    for s, (a_s, b_s) in enumerate(zip(a_slabs, b_slabs)):
        out = sums[s * bps:(s + 1) * bps]
        if mesh is None:
            ops.det_dot_lanes(a_s.view(bps, -1), b_s.view(bps, -1), out=out)
            continue
        with mesh.on(s):
            part = ops.det_dot_lanes(a_s.view(bps, -1), b_s.view(bps, -1))
        mesh.move(part, None, src=s, out=out)
    return sums


def make_det_dot(nblocks: int, mesh=None):
    """Build ``dot(a, b)``: per-block partials, then a left-to-right chain
    over the ``nblocks`` partials; a 0-d tensor on ``a``'s device.  With
    ``mesh`` (the 1-D ``data`` mesh of a sharded operator) each shard
    computes its own blocks' partials from its slabs and the chain runs
    on shard 0's device; the result is bitwise the unsharded one."""
    if mesh is None:
        def det_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return ops.det_dot(a, b, nblocks)
        return det_dot

    nshards = _nshards(mesh)

    def mesh_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a_slabs, on = _slabs(a, nshards)
        return chain_plain(slab_block_sums(a_slabs, _slabs(b, nshards)[0],
                                           nblocks, on))

    return mesh_dot


def make_det_rowdots(nblocks: int, mesh=None):
    """Row-batched :func:`make_det_dot`: ``rowdots(rows, w)[i] ==
    det_dot(rows[i], w)`` bitwise for an ``(rows, n)`` matrix or a
    sequence of vectors (sharded ones under ``mesh``) — the Arnoldi
    projection shape — with the order pinned within each block too (each
    row is a det_dot launch on CUDA, and its block sums gathered shard by
    shard under ``mesh``), so it does not depend on the row count or the
    sharding."""
    dot = make_det_dot(nblocks, mesh)

    def det_rowdots(rows, w: torch.Tensor) -> torch.Tensor:
        if isinstance(rows, torch.Tensor):
            rows = rows.unbind(0)
        return torch.stack([dot(row, w) for row in rows])

    return det_rowdots


def sharded_fused_update(x, r, p, ap, alpha: torch.Tensor,
                         inv_diag: torch.Tensor, nblocks: int, nshards: int):
    """K2 once per shard, one lane a partition block (``alpha`` moved to
    each shard and repeated per lane): ``x', r', z'`` and each shard's
    ``r' z'`` block sums in block order on shard 0's device,
    ``(nblocks,)``.  Sharded vectors give sharded ``x', r', z'``, each
    slab computed on its shard's device and stream; plain vectors (one
    device, the grid steps) give full-length ones.  ``x', r', z'`` are
    bitwise the unsharded ``nblocks`` launch's, and so is the chain of
    the sums."""
    slabs = [_slabs(t, nshards) for t in (x, r, p, ap, inv_diag)]
    mesh = slabs[0][1]
    if any((on is None) != (mesh is None) for _, on in slabs):
        raise ValueError("sharded_fused_update takes sharded vectors or "
                         "plain ones, not both")
    bps = nblocks // nshards
    sums = torch.empty(nblocks, dtype=x.dtype,
                       device=x.device if mesh is None else mesh.device)
    if mesh is None:
        xo, ro, zo = (torch.empty_like(x) for _ in range(3))
        outs = [_slabs(t, nshards)[0] for t in (xo, ro, zo)]
        alphas = alpha.reshape(1).repeat(bps)
    new = ([], [], [])
    for s in range(nshards):
        xs, rs, ps, aps, invs = (t[s].view(bps, -1) for t, _ in slabs)
        out = sums[s * bps:(s + 1) * bps]
        if mesh is None:
            *_, rz = ops.fused_cg_update_lanes(
                xs, rs, ps, aps, alphas, invs,
                out=[o[s].view(bps, -1) for o in outs])
            out.copy_(rz)
            continue
        alpha_s = mesh.move(alpha, s)  # before the shard's stream is current
        with mesh.on(s):
            *vectors, rz = ops.fused_cg_update_lanes(
                xs, rs, ps, aps, alpha_s.reshape(1).repeat(bps), invs)
        for got, v in zip(new, vectors):
            got.append(v.view(slabs[0][0][s].shape))
        mesh.move(rz, None, src=s, out=out)
    if mesh is None:
        return xo, ro, zo, sums
    from repro_torch.distributed.sharding import ShardedVector

    return (*(ShardedVector(v, mesh) for v in new), sums)


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


def slab_stencil7(slabs, mesh=None, out=None) -> List[torch.Tensor]:
    """``A u`` of the grid whose z-slabs are ``slabs`` (``(nz_s, ny,
    nx)`` each, in shard order): each slab's two halo planes are its
    neighbours' edge planes, moved to its shard (``mesh.move``: none at
    the domain's boundary, which reads as zero), then K1's halo mode runs
    once per slab on its shard's device and stream, into ``out[s]`` when
    given.  With no mesh the slabs are views of one tensor, the planes
    are copied on the current stream.  The outputs side by side are
    bitwise ``ops.stencil7`` of the whole grid."""

    def halo(plane, dst, src):
        return plane.clone() if mesh is None else mesh.move(plane, dst,
                                                            src=src)

    last = len(slabs) - 1
    halos = [(None if s == 0 else halo(slabs[s - 1][-1], s, s - 1),
              None if s == last else halo(slabs[s + 1][0], s, s + 1))
             for s in range(last + 1)]
    outs = []
    for s, (slab, (lo, hi)) in enumerate(zip(slabs, halos)):
        with contextlib.nullcontext() if mesh is None else mesh.on(s):
            outs.append(ops.stencil7_halo(slab, lo, hi,
                                          out=None if out is None else out[s]))
    return outs


def sharded_stencil7(u: torch.Tensor, nshards: int) -> torch.Tensor:
    """``A u`` on the ``(nz, ny, nx)`` grid ``u`` of one device split into
    ``nshards`` z-slabs (:func:`slab_stencil7` on its views, writing the
    slabs of one output).  Bitwise ``ops.stencil7(u)``."""
    nz = u.shape[0]
    if nz % nshards != 0:
        raise ValueError(f"nz={nz} not divisible by nshards={nshards}")
    u = u.contiguous()
    out = torch.empty_like(u)
    slab_stencil7(u.chunk(nshards), out=out.chunk(nshards))
    return out


# ----------------------------------------------------------------------
# The sharded PCG grid steps (the reference's dry-run / roofline path)
# ----------------------------------------------------------------------
def _grid_update(x, r, p, ap, alpha, inv6, nshards: int):
    """K2 once per z-slab shard of the grids, one lane a shard: ``x', r',
    z'`` grids (sharded ones for sharded grids) and the ``(nshards,)``
    shard sums of ``r' z'`` on shard 0's device."""
    flat = (t.reshape(-1) for t in (x, r, p, ap))
    xo, ro, zo, sums = sharded_fused_update(*flat, alpha, inv6.reshape(-1),
                                            nshards, nshards)
    return xo.view(x.shape), ro.view(x.shape), zo.view(x.shape), sums


def _mesh_axes(mesh, shard_axes) -> Tuple[str, ...]:
    return tuple(a for a in shard_axes if a in mesh.axis_names)


def _grid_apply(p: torch.Tensor, nshards: int) -> torch.Tensor:
    """``A p`` of a grid: K1's halo mode on each slab of a sharded grid,
    on its shard, or on the ``nshards`` z-slab views of a plain one."""
    slabs = getattr(p, "slabs", None)
    if slabs is None:
        return sharded_stencil7(p, nshards)
    if len(slabs) != nshards:
        raise ValueError(f"a grid of {len(slabs)} slabs for a step over "
                         f"{nshards} shards")
    from repro_torch.distributed.sharding import ShardedVector

    return ShardedVector(slab_stencil7(slabs, p.mesh), p.mesh)


def _grid_block_sums(a: torch.Tensor, b: torch.Tensor,
                     nshards: int) -> torch.Tensor:
    """The ``(nshards,)`` shard sums of ``a * b`` over two grids, one
    block a shard, on shard 0's device (of a sharded grid's mesh, or
    the plain grids' one device)."""
    a_slabs, mesh = _slabs(a.reshape(-1), nshards)
    return slab_block_sums(a_slabs, _slabs(b.reshape(-1), nshards)[0],
                           nshards, mesh)


def esr_replica(p: torch.Tensor):
    """The in-memory ESR copy of ``p``: a clone of a plain grid; for a
    sharded grid a whole copy on each distinct device of its mesh (the
    reference's replicated ``P()``, ``sharding.replicate``)."""
    if getattr(p, "slabs", None) is None:
        return p.clone()
    from repro_torch.distributed.sharding import replicate

    return replicate(p)


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
    shape, dtype, device and mesh (a sharded grid's is sharded)."""
    key = (tuple(p.shape), p.dtype, p.device, getattr(p, "mesh", None))
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
    ``rz``, z-sharded over ``mesh``: plain grids of one device (the
    shards views of them) or sharded grids on the mesh's shards, which
    may span distinct cards (``rz`` and ``beta`` then live on shard 0's
    device, as ``make_det_dot``'s result does).  ``A p`` is K1's halo
    mode shard by shard; ``p.Ap`` and ``r'z'`` are the dtype's own sums
    (block sums a shard, chained on shard 0's device); the update is K2
    with Jacobi's ``1/6``.  With ``esr_mode="inmemory"`` the step also
    keeps the replicated ``p`` of the last two iterations
    (``esr_red_prev``, ``esr_red_cur``: the peer-RAM redundancy of
    Algorithm 2, a full copy each, one on each distinct card of a
    sharded state's mesh)."""
    axes = _mesh_axes(mesh, shard_axes)
    nshards = _nshards(mesh, axes)
    cache: Dict = {}

    def step(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, r, p, rz = state["x"], state["r"], state["p"], state["rz"]
        ap = _grid_apply(p, nshards)                      # halo exchange on z
        pap = chain_plain(_grid_block_sums(p, ap, nshards))
        alpha = rz / pap
        xn, rn, zn, sums = _grid_update(x, r, p, ap, alpha, _inv6(p, cache),
                                        nshards)
        rz_new = chain_plain(sums)
        beta = rz_new / rz
        pn = zn + beta * p
        out = dict(x=xn, r=rn, z=zn, p=pn, rz=rz_new, beta=beta)
        if esr_mode == "inmemory":
            out["esr_red_prev"] = state["esr_red_cur"]
            out["esr_red_cur"] = esr_replica(pn)
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
    with a float32 ``rz``, on plain or sharded grids as there."""
    axes = _mesh_axes(mesh, shard_axes)
    nshards = _nshards(mesh, axes)
    cache: Dict = {}

    def psum(sums: torch.Tensor) -> torch.Tensor:
        return chain_plain(sums.to(torch.float32))

    def step(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, r, p, rz = state["x"], state["r"], state["p"], state["rz"]
        ap = _grid_apply(p, nshards)
        pap = psum(_grid_block_sums(p, ap, nshards))
        alpha = (rz / pap).to(p.dtype)
        xn, rn, zn, sums = _grid_update(x, r, p, ap, alpha, _inv6(p, cache),
                                        nshards)
        rz_new = psum(sums)
        beta = (rz_new / rz).to(p.dtype)
        pn = zn + beta * p
        out = dict(x=xn, r=rn, z=zn, p=pn, rz=rz_new, beta=beta)
        if esr_mode == "inmemory":
            out["esr_red_prev"] = state["esr_red_cur"]
            out["esr_red_cur"] = esr_replica(pn)
        return out

    return step, _grid_spec(mesh, axes, esr_mode, dtype, torch.float32)


def nvm_persist_host(state: Dict[str, torch.Tensor]) -> np.ndarray:
    """NVM-ESR persistence tap: pull ``p``'s shards to the host, in shard
    order (a sharded grid slab by slab from its shards,
    ``sharding.to_host``).  No collective, no device memory."""
    p = state["p"]
    if getattr(p, "slabs", None) is not None:
        from repro_torch.distributed.sharding import to_host

        return to_host(p).reshape(-1)
    return p.detach().reshape(-1).cpu().numpy()
