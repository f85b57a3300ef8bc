"""Sharded solves: block-rows of a solver problem mapped onto a 1-D
``data`` mesh (port of ``repro/distributed/sharding.py:145-281``).

The paper's failure unit is a *node*: one shard owning a contiguous run
of partition blocks.  A :class:`ShardLayout` is that mapping, and it is
all a solve needs to resolve ``FailureEvent(shard=...)`` into block sets
and to label per-shard persist and fetch bytes — the multi-tenant
service declares one per tenant (``nshards=``) without placing anything.

A :class:`DataMesh` places the shards: an ordered tuple of
``torch.device`` s, one a shard, like the reference's single-controller
mesh of faked host devices.  Every shard lives on one device (the card
repeated, or ``cpu`` repeated); vectors stay full-length flat tensors
there and a shard is the contiguous range of its blocks — for the
stencil, whose blocks are z-slabs, a whole-plane slab.  A
:class:`ShardedOperator` computes shard by shard: its stencil apply runs
K1's halo mode once per slab after copying each slab's two halo planes,
and the solvers' reductions (:mod:`repro_torch.core.spmv`) gather
per-shard block sums and chain them in block order, so a sharded solve
is bitwise the unsharded one by construction.  A mesh over distinct
cards (with a stream a shard) waits for a machine with more than one
card (ROADMAP, Queue 1).  The reference's logical-axis rules
(``AxisRules``, ``shard``) belong to the NN stack and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.spmv import halo_nbytes, sharded_stencil7


@dataclass(frozen=True)
class ShardLayout:
    """Block-rows -> shards, contiguously: shard ``s`` owns blocks
    ``[s*bps, (s+1)*bps)`` with ``bps = nblocks // nshards`` (z-slab
    locality: a shard's blocks are its slab of the grid)."""

    nblocks: int
    nshards: int

    def __post_init__(self):
        if not (1 <= self.nshards <= self.nblocks):
            raise ValueError(
                f"need 1 <= nshards <= nblocks, got nshards={self.nshards} "
                f"with nblocks={self.nblocks}")
        if self.nblocks % self.nshards != 0:
            raise ValueError(
                f"nblocks={self.nblocks} not divisible by "
                f"nshards={self.nshards}")

    @property
    def blocks_per_shard(self) -> int:
        return self.nblocks // self.nshards

    def blocks_of(self, shard: int) -> Tuple[int, ...]:
        """The partition blocks owned by shard ``shard``."""
        if not (0 <= shard < self.nshards):
            raise ValueError(
                f"shard {shard} out of range for nshards={self.nshards}")
        bps = self.blocks_per_shard
        return tuple(range(shard * bps, (shard + 1) * bps))

    def shard_of_block(self, block: int) -> int:
        if not (0 <= block < self.nblocks):
            raise ValueError(
                f"block {block} out of range for nblocks={self.nblocks}")
        return block // self.blocks_per_shard

    def shard_of_block_map(self) -> Dict[int, int]:
        """The full block -> owning-shard map (per-shard session
        addressing: :meth:`repro_torch.nvm.backend.PersistSession.bind_shards`)."""
        return {b: self.shard_of_block(b) for b in range(self.nblocks)}


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: one ``torch.device`` a shard, in shard order.
    Every shard must live on the same device."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a data mesh needs at least one device")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"a data mesh over distinct devices {sorted(map(str, set(self.devices)))} "
                f"waits for a machine with more than one card (ROADMAP, "
                f"Queue 1: a mesh over distinct cards); place every shard "
                f"on one device")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]


def make_data_mesh(nshards: int,
                   device: Union[str, torch.device] = "cuda") -> DataMesh:
    """A 1-D ``data`` mesh of ``nshards`` shards, all on ``device`` (the
    card unless the caller asks for the CPU)."""
    if nshards < 1:
        raise ValueError(f"a data mesh needs nshards >= 1, got {nshards}")
    return DataMesh((resolve_device(device),) * nshards)


class ShardedOperator:
    """An operator whose vectors are laid out block-sharded on a ``data``
    mesh.

    Every attribute but ``apply`` (``partition``, ``nblocks``, ``n``,
    ``diag``, ``inblock_apply``, ``offblock_apply``, ...) delegates to
    the base operator, so preconditioners and reconstruction code run
    unchanged.  The wrapper adds ``layout`` and ``mesh`` — the driver
    and the solvers' order-pinned reductions key off both
    (``getattr(op, "mesh", None)``) — and :meth:`device_put`.  ``apply``
    on a :class:`~repro_torch.core.poisson.StencilOperator` runs K1's
    halo mode once per shard and counts the halo bytes it moves in
    ``halo_bytes``; on any other operator it is the base's ``apply``
    over the whole vector, as in the reference."""

    def __init__(self, base, layout: ShardLayout, mesh: DataMesh):
        if "data" not in mesh.axis_names:
            raise ValueError("ShardedOperator needs a mesh with a 'data' axis")
        if int(mesh.shape["data"]) != layout.nshards:
            raise ValueError(
                f"mesh data axis has {mesh.shape['data']} device(s) but the "
                f"layout declares nshards={layout.nshards}")
        if base.nblocks != layout.nblocks:
            raise ValueError(
                f"operator has {base.nblocks} blocks but the layout "
                f"declares nblocks={layout.nblocks}")
        self.base = base
        self.layout = layout
        self.mesh = mesh
        #: bytes the sharded applies have moved between shards (halo
        #: planes), since construction
        self.halo_bytes = 0

    def __getattr__(self, name):
        return getattr(self.base, name)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        base = self.base
        if not isinstance(base, StencilOperator) or x.dim() != 1:
            return base.apply(x)
        nshards = self.layout.nshards
        self.halo_bytes += halo_nbytes(base.grid, nshards, x.dtype)
        return sharded_stencil7(x.reshape(base.grid), nshards).reshape(-1)

    def device_put(self, x: torch.Tensor) -> torch.Tensor:
        """Place a full-length vector on the mesh, contiguous."""
        return x.to(self.mesh.device).contiguous()


def shard_problem(op, b: torch.Tensor, nshards: int,
                  mesh: Optional[DataMesh] = None):
    """Shard a block-partitioned problem across ``nshards`` shards.

    Returns ``(sharded_op, sharded_b)``: the operator wrapped in a
    :class:`ShardedOperator` over a 1-D ``data`` mesh on ``b``'s device
    (or ``mesh``) and the rhs placed on it.  ``nshards`` must divide the
    operator's block count (blocks are the failure unit; shards are whole
    groups of them)."""
    layout = ShardLayout(nblocks=op.nblocks, nshards=nshards)
    if mesh is None:
        mesh = make_data_mesh(nshards, device=b.device)
    sharded = ShardedOperator(op, layout, mesh)
    return sharded, sharded.device_put(b)


def place_state(state, mesh: DataMesh, vector_fields: Sequence[str]):
    """Re-pin a solver state NamedTuple to the mesh: every tensor field on
    the mesh's device, contiguous (vector fields are the block-sharded
    ones; on one device every field has one placement, so they are named
    only for the multi-card layout to come).  The driver applies it after
    ``init_state`` and after ``reconstruct``."""
    dev = mesh.device
    return type(state)(**{
        f: (v.to(dev).contiguous() if isinstance(v, torch.Tensor) else v)
        for f, v in zip(state._fields, state)})
