"""The NN stack's logical-axis rules, and sharded solves: block-rows of
a solver problem mapped onto a 1-D ``data`` mesh (port of
``repro/distributed/sharding.py``).

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
card (ROADMAP, Queue 1).

The first half of the module is the NN stack's logical-axis rules (port
of ``repro/distributed/sharding.py:33-143``): model code names *logical*
dimensions and an :class:`AxisRules` table maps them onto the axes of a
mesh.  Torch has no ``PartitionSpec``: a spec is a plain tuple of
physical axis names (or ``None``, or a tuple of names), and the mesh is
any object with ``axis_names`` and a ``shape`` mapping (a
:class:`LogicalMesh`, or the reference's ``jax.sharding.Mesh``), and
:func:`shard_shape` gives a tensor's per-device shape under the rules
(what the LM dry run sums its per-device bytes from).  On the one card
every tensor is whole, so :func:`shard` is the identity, as the
reference's is with no mesh; a mesh over distinct cards waits for a
machine with more than one card (ROADMAP, Queue 1 item 4).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.spmv import halo_nbytes, sharded_stencil7

Axis = Union[str, Tuple[str, ...], None]
#: a physical spec: one entry a tensor dimension (the reference's
#: ``PartitionSpec`` as a plain tuple)
Spec = Tuple[Axis, ...]


@dataclass(frozen=True)
class LogicalMesh:
    """A mesh's axis names and extents, and nothing placed on it: what
    the axis rules read of a mesh."""

    axis_names: Tuple[str, ...]
    shape: Mapping[str, int] = field(default_factory=dict)


@dataclass(frozen=True)
class AxisRules:
    """Mapping of logical axis names to physical mesh axes."""

    mesh: Optional[Any]
    rules: Dict[str, Axis]

    def physical(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        axis = self.rules.get(logical)
        if axis is None or self.mesh is None:
            return None
        # keep only axes present in this mesh (e.g. no "pod" single-pod)
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a in self.mesh.axis_names)
            return kept if kept else None
        return axis if axis in self.mesh.axis_names else None

    def spec(self, *logical: Optional[str]) -> Spec:
        """The physical spec of ``logical`` dims, a one-axis tuple written
        as its axis (``PartitionSpec``'s canonical form)."""
        out = []
        for l in logical:
            ax = self.physical(l)
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax)
        return tuple(out)


DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "seq": "model",      # sequence parallelism of the residual stream
    "kv_seq": "model",   # sequence-sharded decode caches
    "embed": None,
    "layers": None,
    "state": None,       # SSM state dim
}

_ctx = threading.local()


def set_rules(mesh: Optional[Any],
              rules: Optional[Dict[str, Axis]] = None) -> AxisRules:
    r = AxisRules(mesh, dict(DEFAULT_RULES if rules is None else rules))
    _ctx.rules = r
    return r


def current_rules() -> AxisRules:
    r = getattr(_ctx, "rules", None)
    if r is None:
        r = AxisRules(None, dict(DEFAULT_RULES))
        _ctx.rules = r
    return r


@contextlib.contextmanager
def use_rules(mesh: Optional[Any], rules: Optional[Dict[str, Axis]] = None):
    prev = getattr(_ctx, "rules", None)
    set_rules(mesh, rules)
    try:
        yield current_rules()
    finally:
        _ctx.rules = prev


def logical_spec(*logical: Optional[str]) -> Spec:
    return current_rules().spec(*logical)


def spec_for_shape(rules: AxisRules, shape: Sequence[int],
                   logical: Sequence[Optional[str]]) -> Spec:
    """Physical spec with per-dimension divisibility degradation.

    A logical axis whose mapped mesh extent does not divide the tensor
    dimension is dropped (for tuple mappings, the longest divisible prefix
    is kept) — e.g. kv_heads=8 on a model=16 axis falls back to
    replication while q-heads=32 shard fully.
    """
    phys = []
    mesh = rules.mesh
    for dim, l in zip(shape, logical):
        ax = rules.physical(l)
        if ax is None or mesh is None:
            phys.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        kept = []
        prod = 1
        for a in axes:
            ext = mesh.shape[a]
            if dim % (prod * ext) == 0:
                kept.append(a)
                prod *= ext
        if not kept:
            phys.append(None)
        elif len(kept) == 1:
            phys.append(kept[0])
        else:
            phys.append(tuple(kept))
    return tuple(phys)


def shard_shape(rules: AxisRules, shape: Sequence[int],
                logical: Sequence[Optional[str]]) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor with logical spec
    ``logical`` (the counterpart of ``NamedSharding(mesh,
    spec_for_shape(...)).shard_shape(shape)``): each dimension divided
    by the product of the mesh extents :func:`spec_for_shape` keeps for
    it; dimensions past the spec's length stay whole."""
    spec = spec_for_shape(rules, shape, logical)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= int(rules.mesh.shape[a])
        out.append(int(dim) // n)
    return tuple(out)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s layout by logical axis names: the identity on
    the one card, where every tensor is whole."""
    return x


# ======================================================================
# Sharded solves: block-rows of a solver problem on a 1-D data mesh
# ======================================================================
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
