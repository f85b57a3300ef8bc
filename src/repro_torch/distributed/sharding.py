"""The NN stack's logical-axis rules, and sharded solves: block-rows of
a solver problem mapped onto a 1-D ``data`` mesh (port of
``repro/distributed/sharding.py``).

The paper's failure unit is a *node*: one shard owning a contiguous run
of partition blocks.  A :class:`ShardLayout` is that mapping, and it is
all a solve needs to resolve ``FailureEvent(shard=...)`` into block sets
and to label per-shard persist and fetch bytes — the multi-tenant
service declares one per tenant (``nshards=``) without placing anything.

A :class:`DataMesh` places the shards: an ordered tuple of
``torch.device`` s, one a shard — the card repeated, distinct cards, or
``cpu`` repeated — and on CUDA a stream a shard.  A sharded solve's
vectors are :class:`ShardedVector` s: one slab a shard, each a tensor
of its own on its shard's device (for the stencil, whose blocks are
z-slabs, a whole-plane slab), their work enqueued on the shard's
stream.  Every read of one shard's data by another is an explicit copy
ordered by an event (:meth:`DataMesh.move`): the halo planes, the block
sums and a recovery's failed slabs.  On repeated devices the same
copies, streams and events run, so every sharded test on the CPU and
every sharded phase on the one card runs the code a machine with
several cards runs.  A :class:`ShardedOperator` computes shard by
shard: its stencil apply runs K1's halo mode once per slab after moving
each slab's two halo planes, and the solvers' reductions
(:mod:`repro_torch.core.spmv`) move per-shard block sums to shard 0's
device and chain them in block order, so a sharded solve is bitwise the
unsharded one by construction.  Nothing gathers a sharded vector but
:func:`gather`, where the API hands a result back.

The first half of the module is the NN stack's logical-axis rules (port
of ``repro/distributed/sharding.py:33-143``): model code names *logical*
dimensions and an :class:`AxisRules` table maps them onto the axes of a
mesh.  Torch has no ``PartitionSpec``: a spec is a plain tuple of
physical axis names (or ``None``, or a tuple of names), and the mesh is
any object with ``axis_names`` and a ``shape`` mapping (a
:class:`LogicalMesh`, or the reference's ``jax.sharding.Mesh``), and
:func:`shard_shape` gives a tensor's per-device shape under the rules
(what the LM dry run sums its per-device bytes from).

The LM stack serves over a :class:`DeviceMesh`: a :class:`DataMesh`
whose shards are the coordinates of a ``(data, model)`` mesh.  Its
tensors are :class:`Placed`: one piece a coordinate, laid out by the
physical spec :func:`spec_for_shape` gives under the rules.  The model
code runs shard by shard (:func:`each`) and writes each collective out:
:func:`reshard` (the all-gather of :func:`gather_axis` among its
cases), :func:`reduce_sum` and :func:`reduce_scatter` in rank order,
:func:`heads_to_seq` and
:func:`to_whole`, every one of them built on :meth:`DataMesh.move`.
:func:`shard` stays the identity: where the reference constrains a
layout, the port's mesh code lays the tensor out explicitly.

The gradient convention
-----------------------
The LM stack trains over a :class:`DeviceMesh` with autograd.  In the
forward each shard's piece is a tensor of its own, and the loss reads
the whole logits through :func:`to_whole`, so the gradient a replica's
piece receives is a *partial*: the gradient of the whole value is the
rank-order sum of its pieces' gradients.  Every collective is a
``torch.autograd.Function`` whose backward holds to that, summing in
rank order (shard order), never in the order autograd would add the
gradients that reach one tensor from several shards (arrival order,
which over distinct cards is that of a worker thread a device):

- :meth:`DataMesh.move` (without ``out``): the transpose is a move
  back to the producer's shard and stream;
- :func:`reshard` (:func:`gather_axis`, a replication, the fsdp gather
  of ``layers.use_param``) and :func:`place`: a reduce-scatter, each
  source part the sum of the gradients of every copy made of it, in
  rank order;
- :func:`reduce_sum`: the group's output gradients summed in rank
  order, the sum handed to every input piece;
- :func:`reduce_scatter`: the all-gather of the group's output
  gradients in rank order, each input piece the whole of them;
- :func:`to_whole`: each part's slice of the whole gradient to the
  piece it came from, nothing to the replicas it skipped;
- :func:`mean_over_mesh`: each piece ``1 / nshards`` of the gradient.

:func:`heads_to_seq` and the partial softmaxes of
``layers.attend_kv_seq`` are decode-only: a training forward writes no
cache and reaches neither, so they have no backward.  A placed
parameter's pieces are leaves that require grad (``registry.
place_parameters``); after the backward, :func:`sum_replica_grads`
sums the partial gradients of each part's replicas once, in rank order,
and hands every replica the same sum, so that after the optimizer the
replicas stay bitwise copies.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.spmv import halo_nbytes, sharded_stencil7, slab_stencil7

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


#: one CUDA stream a (device, shard index): meshes over the same devices
#: enqueue a shard's work on the same stream
_STREAMS: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: one ``torch.device`` a shard, in shard order,
    the card repeated, distinct cards, or ``cpu`` repeated.  On CUDA
    each shard has a stream of its own (made at its first use, shared by
    every mesh with that device at that shard index), and a shard's work
    is enqueued there (:meth:`on`); every read of one shard's data by
    another goes through :meth:`move`."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a data mesh needs at least one device")
        devices = tuple(torch.device(d) for d in self.devices)
        if any(d.type == "cuda" and d.index is None for d in devices):
            # "cuda" names the current card, as a tensor's device does
            here = torch.cuda.current_device()
            devices = tuple(torch.device("cuda", here)
                            if d.type == "cuda" and d.index is None else d
                            for d in devices)
        object.__setattr__(self, "devices", devices)
        kinds = {d.type for d in devices}
        if len(kinds) > 1:
            raise ValueError(f"a data mesh's devices must all be of one "
                             f"kind, got {sorted(kinds)}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def nshards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Shard 0's device, where a sharded solve's scalars live."""
        return self.devices[0]

    @property
    def distinct(self) -> bool:
        """Whether the shards live on more than one device."""
        return len(set(self.devices)) > 1

    def stream(self, shard: int):
        """Shard ``shard``'s stream (``None`` on the CPU)."""
        dev = self.devices[shard]
        if dev.type != "cuda":
            return None
        key = (dev, shard)
        stream = _STREAMS.get(key)
        if stream is None:
            stream = _STREAMS[key] = torch.cuda.Stream(dev)
        return stream

    def on(self, shard: int):
        """A context in which the work enqueued goes to ``shard``'s
        stream (nothing to switch on the CPU)."""
        stream = self.stream(shard)
        return (contextlib.nullcontext() if stream is None
                else torch.cuda.stream(stream))

    def _queue(self, where, device: torch.device):
        if isinstance(where, int):
            return self.stream(where)
        return torch.cuda.current_stream(device)

    def move(self, t: torch.Tensor, dst: Union[int, torch.device, None],
             src: Optional[int] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A copy of ``t`` for its consumer ``dst``: shard ``dst``'s
        device and stream, or with a device (``None``: shard 0's) the
        current stream there.  The copy waits on an event of the
        producer's stream (shard ``src``'s, or with ``src=None`` the
        current stream of ``t``'s device) and is enqueued on the
        consumer's, so it sees everything the producer queued before it.
        A peer copy across cards, a device-to-device copy on one card, a
        clone on the CPU: always a new tensor (or ``out``), never an
        alias.  Call it outside :meth:`on`, where the current streams are
        the caller's.  Without ``out`` the copy is a
        ``torch.autograd.Function`` (:class:`_Move`) whose backward moves
        the gradient back to the producer's shard and stream."""
        if out is not None:
            return self._copy(t, dst, src, out)
        return _Move.apply(t, self, dst, src)

    def _copy(self, t: torch.Tensor, dst: Union[int, torch.device, None],
              src: Optional[int] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`move`'s copy, outside autograd: what the collectives'
        forwards and backwards enqueue, where autograd is off."""
        if isinstance(dst, int):
            dev = self.devices[dst]
        else:
            dev = self.device if dst is None else torch.device(dst)
        if dev.type != "cuda":
            return t.clone() if out is None else out.copy_(t)
        producer = (self._queue(src, t.device) if t.device.type == "cuda"
                    else None)
        consumer = self._queue(dst, dev)
        if producer is not None and producer != consumer:
            consumer.wait_stream(producer)
        with torch.cuda.stream(producer or consumer), \
                torch.cuda.stream(consumer):
            if out is None:
                out = torch.empty(t.shape, dtype=t.dtype, device=dev)
            out.copy_(t, non_blocking=True)
        if t.device == dev and producer != consumer:
            # read on the consumer's stream: its memory waits for it
            t.record_stream(consumer)
        return out

    def place(self, x: torch.Tensor) -> "ShardedVector":
        """The vector ``x`` (of a length the shard count divides), or the
        grid ``x`` (its first dimension so), as a :class:`ShardedVector`:
        slab ``s`` a copy of the ``s``-th equal range of the first
        dimension, moved onto shard ``s``."""
        if x.dim() < 1 or x.shape[0] % self.nshards:
            raise ValueError(f"cannot split a tensor of shape "
                             f"{tuple(x.shape)} into {self.nshards} slabs")
        step = x.shape[0] // self.nshards
        return ShardedVector([self.move(x[s * step:(s + 1) * step], s)
                              for s in range(self.nshards)], self)

    def fork(self) -> None:
        """Make every shard's stream wait for the current stream of shard
        0's device (no host wait): each shard's next work sees all that
        was queued there.  Under a stream capture on that stream, the
        shard streams join the capture, so their work lands in the graph
        (and :meth:`join` must follow before the capture ends)."""
        if self.device.type != "cuda":
            return
        current = torch.cuda.current_stream(self.device)
        for s in range(self.nshards):
            self.stream(s).wait_stream(current)

    def join(self) -> None:
        """Make the current streams wait for every shard's queued work
        (no host wait): what runs there next sees all of it."""
        for s, dev in enumerate(self.devices):
            stream = self.stream(s)
            if stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(stream)

    def synchronize(self) -> None:
        """Wait for every shard's queued work."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_data_mesh(nshards: int,
                   device: Union[str, torch.device] = "cuda") -> DataMesh:
    """A 1-D ``data`` mesh of ``nshards`` shards.  With ``device="cuda"``
    (no index) shard ``s`` lives on card ``s * c // nshards``, ``c =
    min(nshards, torch.cuda.device_count())``: one card holds every
    shard, four cards hold a 4-shard mesh one shard each.  A device with
    an index (``"cuda:0"``) or ``"cpu"`` holds every shard."""
    if nshards < 1:
        raise ValueError(f"a data mesh needs nshards >= 1, got {nshards}")
    return DataMesh(_mesh_devices(nshards, device))


def _mesh_devices(nshards: int, device: Union[str, torch.device]
                  ) -> Tuple[torch.device, ...]:
    """Shard ``s``'s device: card ``s * c // nshards`` of the ``c =
    min(nshards, device_count)`` visible cards for ``"cuda"`` without an
    index, else ``device`` repeated."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = min(nshards, torch.cuda.device_count())
        return tuple(torch.device("cuda", s * cards // nshards)
                     for s in range(nshards))
    return (dev,) * nshards


# ----------------------------------------------------------------------
# The LM stack's (data, model) device mesh and its placed tensors
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class DeviceMesh(DataMesh):
    """The ``(data, model)`` mesh of the LM axis rules over a
    :class:`DataMesh`'s shards: coordinate ``(d, m)`` is shard ``d *
    model + m``, with that shard's device and stream.  ``AxisRules``
    read its ``axis_names`` and ``shape`` as they read a
    :class:`LogicalMesh`'s; its tensors are :class:`Placed`."""

    model: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.model < 1 or len(self.devices) % self.model:
            raise ValueError(f"a model axis of {self.model} does not divide "
                             f"{len(self.devices)} shards")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) // self.model, "model": self.model}

    def coords(self, shard: int) -> Dict[str, int]:
        """Shard ``shard``'s coordinate on each axis."""
        d, m = divmod(shard, self.model)
        return {"data": d, "model": m}

    def group(self, axis: str, shard: int) -> Tuple[int, ...]:
        """The shards that differ from ``shard`` on ``axis`` alone, in
        rank order along it (``shard`` among them)."""
        d, m = divmod(shard, self.model)
        if axis == "model":
            return tuple(d * self.model + r for r in range(self.model))
        return tuple(r * self.model + m for r in range(self.shape["data"]))

    def ranks(self, axis: str) -> "PerShard":
        """Every shard's rank along ``axis``, in shard order."""
        return PerShard(self.coords(s)[axis] for s in range(self.nshards))


def make_device_mesh(data: int, model: int,
                     device: Union[str, torch.device] = "cuda") -> DeviceMesh:
    """The ``(data, model)`` mesh of ``data * model`` shards, shard ``s``
    on card ``s * c // (data * model)`` as :func:`make_data_mesh` places
    them (one card repeated, or the cards spanned), or all on an indexed
    device or the CPU."""
    if data < 1 or model < 1:
        raise ValueError(f"a ({data}, {model}) mesh has an empty axis")
    return DeviceMesh(_mesh_devices(data * model, device), model)


class PerShard(tuple):
    """One value a shard, in shard order: :func:`each` hands shard ``s``
    its ``s``-th entry."""


class Placed:
    """A tensor laid out on a :class:`DeviceMesh`: one piece a mesh
    coordinate, in shard order, each a tensor of its own on its shard's
    device, and the physical ``spec`` (one axis name or ``None`` a
    dimension) that says which part of the whole each piece is: a
    dimension on an axis is cut into that axis' extent of equal parts,
    rank ``r`` holding part ``r``; a dimension on no axis is whole in
    every piece.  Along an axis on no dimension a parameter's pieces are
    copies; a value computed per data shard (the expert outputs of its
    own tokens) differs between data ranks, as a ``shard_map`` body's
    local values do, and is only ever gathered within its group.  Its
    work runs on each shard's stream (:func:`each`); every read of one
    shard's piece by another is a :meth:`DataMesh.move`."""

    __slots__ = ("pieces", "mesh", "spec")

    def __init__(self, pieces: Sequence[torch.Tensor], mesh: DeviceMesh,
                 spec: Spec):
        self.pieces = tuple(pieces)
        self.mesh = mesh
        self.spec = tuple(spec)
        if len(self.pieces) != mesh.nshards:
            raise ValueError(f"{len(self.pieces)} pieces for a mesh of "
                             f"{mesh.nshards} shards")

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole tensor's shape."""
        ext = self.mesh.shape
        return tuple(n * (ext[a] if a else 1)
                     for n, a in zip(self.pieces[0].shape, self.spec))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def physical_spec(rules: AxisRules, shape: Sequence[int],
                  logical: Sequence[Optional[str]]) -> Spec:
    """:func:`spec_for_shape` on a :class:`DeviceMesh`, an axis of
    extent 1 written as ``None`` (its one part is the whole)."""
    spec = spec_for_shape(rules, shape, logical)
    ext = rules.mesh.shape
    out = []
    for ax in spec:
        if isinstance(ax, tuple):
            raise NotImplementedError(f"a dimension on the axes {ax}: a "
                                      f"DeviceMesh puts one axis on a "
                                      f"dimension")
        out.append(ax if ax is not None and ext[ax] > 1 else None)
    return tuple(out) + (None,) * (len(shape) - len(out))


def _part(n: int, ax: Axis, coords: Dict[str, int],
          ext: Dict[str, int]) -> Tuple[int, int]:
    """The ``[lo, hi)`` range of a dimension of ``n`` that coordinate
    ``coords`` holds when the dimension is on axis ``ax``."""
    if ax is None:
        return 0, n
    step = n // ext[ax]
    return coords[ax] * step, (coords[ax] + 1) * step


def ranges(x: Placed, dim: int) -> "PerShard":
    """Each shard's ``(lo, hi)`` of ``x``'s dimension ``dim`` in the
    whole tensor."""
    n, ax = x.shape[dim], x.spec[dim]
    return PerShard(_part(n, ax, x.mesh.coords(s), x.mesh.shape)
                    for s in range(x.mesh.nshards))


def _region(t: torch.Tensor, region) -> torch.Tensor:
    """``t`` narrowed to ``region``: one ``(lo, hi)`` a dimension
    (``None``: the whole tensor)."""
    if region is None:
        return t
    for dim, (lo, hi) in enumerate(region):
        if (lo, hi) != (0, t.shape[dim]):
            t = t.narrow(dim, lo, hi - lo)
    return t


def _whole_region(region, shape) -> bool:
    return region is None or all((lo, hi) == (0, n)
                                 for (lo, hi), n in zip(region, shape))


def wait_current(mesh: DataMesh) -> None:
    """Every shard's stream waits on the current stream of every card of
    the mesh (no host wait; nothing to do on the CPU): in a collective's
    backward, where autograd ordered the gradients coming in, and after
    a backward, where it ordered the leaves' ``.grad``."""
    if mesh.device.type != "cuda":
        return
    currents = [torch.cuda.current_stream(d)
                for d in dict.fromkeys(mesh.devices)]
    for s in range(mesh.nshards):
        stream = mesh.stream(s)
        for cur in currents:
            if cur != stream:
                stream.wait_stream(cur)


def join_current(mesh: DataMesh) -> None:
    """The current stream of every card of the mesh waits on that card's
    shards' streams (no host wait): what runs there next sees all of
    their work."""
    if mesh.device.type != "cuda":
        return
    for dev in dict.fromkeys(mesh.devices):
        cur = torch.cuda.current_stream(dev)
        for s, d in enumerate(mesh.devices):
            if d == dev:
                cur.wait_stream(mesh.stream(s))


def _bw_join(mesh: DataMesh, grads) -> tuple:
    """In a collective's backward: :func:`join_current`, so that
    whatever autograd runs next sees the gradients going out, each of
    them marked as read there."""
    grads = tuple(grads)
    if mesh.device.type != "cuda":
        return grads
    join_current(mesh)
    for g in grads:
        if isinstance(g, torch.Tensor) and g.device.type == "cuda":
            g.record_stream(torch.cuda.current_stream(g.device))
    return grads


class _Move(torch.autograd.Function):
    """:meth:`DataMesh.move` under autograd: the gradient moves back to
    the producer's shard and stream (or, with ``src=None``, to the
    current stream of the input's device)."""

    @staticmethod
    def forward(ctx, t, mesh, dst, src):
        ctx.mesh, ctx.dst, ctx.src, ctx.device = mesh, dst, src, t.device
        return mesh._copy(t, dst, src=src)

    @staticmethod
    def backward(ctx, g):
        mesh, dst, src = ctx.mesh, ctx.dst, ctx.src
        wait_current(mesh)
        back = src if isinstance(src, int) else ctx.device
        out = mesh._copy(g, back, src=dst if isinstance(dst, int) else None)
        return _bw_join(mesh, [out])[0], None, None, None


def _place_pieces(t: torch.Tensor, mesh: DeviceMesh, spec: Spec):
    """``place``'s pieces and each one's region of ``t``."""
    ext = mesh.shape
    pieces, regions = [], []
    for s in range(mesh.nshards):
        c = mesh.coords(s)
        region = tuple(_part(t.shape[dim], ax, c, ext)
                       for dim, ax in enumerate(spec))
        regions.append(region)
        pieces.append(mesh._copy(_region(t, region), s))
    return pieces, regions


class _Place(torch.autograd.Function):
    """:func:`place` under autograd: the whole tensor's gradient is the
    sum of its pieces' gradients, each moved back from its shard, added
    into its part in rank order."""

    @staticmethod
    def forward(ctx, t, mesh, spec):
        pieces, ctx.regions = _place_pieces(t, mesh, spec)
        ctx.mesh, ctx.shape, ctx.device = mesh, t.shape, t.device
        return tuple(pieces)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        wait_current(mesh)
        acc = torch.zeros(ctx.shape, dtype=grads[0].dtype, device=ctx.device)
        for s, (g, region) in enumerate(zip(grads, ctx.regions)):
            _region(acc, region).add_(mesh._copy(g, ctx.device, src=s))
        return _bw_join(mesh, [acc])[0], None, None


def place(t: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> Placed:
    """The whole tensor ``t`` placed on ``mesh`` by ``spec``: each
    piece a copy of its part, moved onto its shard (from the current
    stream of ``t``'s device).  Under autograd its transpose sums the
    pieces' gradients into the whole in rank order (:class:`_Place`)."""
    return Placed(_Place.apply(t, mesh, tuple(spec)), mesh, spec)


def placed_full(shape: Sequence[int], spec: Spec, mesh: DeviceMesh,
                value: float, dtype: torch.dtype) -> Placed:
    """A placed tensor of ``shape`` filled with ``value``, each piece
    made on its shard's device and stream: nothing is made whole."""
    ext = mesh.shape
    pieces = []
    for s in range(mesh.nshards):
        c = mesh.coords(s)
        piece = tuple(hi - lo for lo, hi in
                      (_part(n, ax, c, ext) for n, ax in zip(shape, spec)))
        with mesh.on(s):
            pieces.append(torch.full(piece, value, dtype=dtype,
                                     device=mesh.devices[s]))
    return Placed(pieces, mesh, spec)


def on_every_shard(value, mesh: DataMesh) -> "PerShard":
    """``value`` for every shard: a tensor moved to each shard's device
    and stream (:meth:`DataMesh.move`, from the current stream of its
    device), so that no shard reads another's memory; anything else (a
    Python number) as it is.  Call it outside :meth:`DataMesh.on`."""
    if isinstance(value, PerShard):
        return value
    if isinstance(value, torch.Tensor):
        return PerShard(mesh.move(value, s) for s in range(mesh.nshards))
    return PerShard((value,) * mesh.nshards)


def each(fn, *args, spec, mesh: Optional[DeviceMesh] = None):
    """``fn`` shard by shard on each shard's stream: a :class:`Placed`
    argument as its piece, a :class:`PerShard` as its entry, anything
    else as it is (never a tensor of another shard: move it first).
    ``spec`` is the output's physical spec, a list of them when ``fn``
    returns a tuple (one :class:`Placed` an entry), or ``None`` for
    values that are no part of one whole tensor (a :class:`PerShard`).
    ``mesh`` is the first placed argument's unless given."""
    if mesh is None:
        mesh = next(a.mesh for a in args if isinstance(a, Placed))
    outs = []
    for s in range(mesh.nshards):
        local = [a.pieces[s] if isinstance(a, Placed)
                 else a[s] if isinstance(a, PerShard) else a for a in args]
        with mesh.on(s):
            outs.append(fn(*local))
    if spec is None:
        return PerShard(outs)
    if isinstance(spec, list):
        return tuple(Placed([o[i] for o in outs], mesh, sp)
                     for i, sp in enumerate(spec))
    return Placed(outs, mesh, spec)


def _reshard_plan(x: Placed, spec: Spec):
    """Each shard's new piece under ``spec``: ``None`` where the old
    piece is already the new one, else its shape and the copies that
    assemble it, ``(source shard, region of the source piece, region of
    the new piece)`` in the order :func:`reshard` makes them."""
    mesh, ext, shape = x.mesh, x.mesh.shape, x.shape
    plan = []
    for s in range(mesh.nshards):
        c = mesh.coords(s)
        want = [_part(n, ax, c, ext) for n, ax in zip(shape, spec)]
        # the source shards: every rank of an axis the old spec uses
        # whose part meets the wanted range, the own rank of any other
        options = []
        for axis in mesh.axis_names:
            if axis not in x.spec:
                options.append([c[axis]])
                continue
            dim = x.spec.index(axis)
            step = shape[dim] // ext[axis]
            lo, hi = want[dim]
            options.append([r for r in range(ext[axis])
                            if r * step < hi and lo < (r + 1) * step])
        sources = [d * mesh.model + m for d in options[0] for m in options[1]]
        have = [_part(n, ax, c, ext) for n, ax in zip(shape, x.spec)]
        if sources == [s] and have == want:
            plan.append(None)
            continue
        copies = []
        for r in sources:
            rc = mesh.coords(r)
            src_reg, dst_reg = [], []
            for dim, (n, ax) in enumerate(zip(shape, x.spec)):
                slo, shi = _part(n, ax, rc, ext)
                lo, hi = max(slo, want[dim][0]), min(shi, want[dim][1])
                src_reg.append((lo - slo, hi - slo))
                dst_reg.append((lo - want[dim][0], hi - want[dim][0]))
            copies.append((r, tuple(src_reg), tuple(dst_reg)))
        plan.append((tuple(hi - lo for lo, hi in want), copies))
    return plan


def _reshard_pieces(pieces, mesh: DeviceMesh, plan, dtype) -> list:
    out = []
    for s, entry in enumerate(plan):
        if entry is None:
            out.append(pieces[s])
            continue
        shape, copies = entry
        with mesh.on(s):
            buf = torch.empty(shape, dtype=dtype, device=mesh.devices[s])
        for r, src_reg, dst_reg in copies:
            mesh._copy(_region(pieces[r], src_reg), s, src=r,
                       out=_region(buf, dst_reg))
        out.append(buf)
    return out


class _Reshard(torch.autograd.Function):
    """:func:`reshard` under autograd.  Its transpose is the
    reduce-scatter: each source piece's gradient is the sum, in rank
    order of the new pieces, of the gradients of every copy made of its
    parts, each moved back from the shard that holds it; a source piece
    copied once, whole, takes that copy's gradient as it is.  The sum
    starts from zeros and adds the copies' gradients in shard order,
    which along the gathered axis is its rank order: the all-gather of
    the residual stream's positions over ``model`` (:func:`gather_axis`)
    has as its transpose each position piece's gradient summed over its
    model group from rank 0's, as :func:`reduce_sum` sums."""

    @staticmethod
    def forward(ctx, mesh, plan, *pieces):
        ctx.mesh, ctx.plan = mesh, plan
        ctx.shapes = [p.shape for p in pieces]
        return tuple(_reshard_pieces(pieces, mesh, plan, pieces[0].dtype))

    @staticmethod
    def backward(ctx, *grads):
        mesh, plan = ctx.mesh, ctx.plan
        wait_current(mesh)
        # every source piece's copies, in the rank order of the new pieces
        uses = [[] for _ in plan]
        for s, entry in enumerate(plan):
            if entry is None:
                uses[s].append((s, None, None))
            else:
                for r, src_reg, dst_reg in entry[1]:
                    uses[r].append((s, src_reg, dst_reg))
        out = []
        for r, copies in enumerate(uses):
            shape = ctx.shapes[r]
            if not copies:
                out.append(None)
                continue
            if len(copies) == 1 and _whole_region(copies[0][1], shape):
                s, _, dst_reg = copies[0]
                g = _region(grads[s], dst_reg)
                out.append(g if s == r else mesh._copy(g, r, src=s))
                continue
            with mesh.on(r):
                acc = torch.zeros(shape, dtype=grads[0].dtype,
                                  device=mesh.devices[r])
            for s, src_reg, dst_reg in copies:
                g = _region(grads[s], dst_reg)
                if s != r:
                    g = mesh._copy(g, r, src=s)
                with mesh.on(r):
                    _region(acc, src_reg).add_(g)
            out.append(acc)
        return (None, None) + _bw_join(mesh, out)


def reshard(x: Placed, spec: Spec) -> Placed:
    """``x`` laid out by ``spec``: each shard's new piece assembled from
    the pieces that hold its parts (for an axis the old spec does not
    use, the replica at the shard's own rank), each part moved from its
    shard and written into place.  A piece that is already the new one
    is kept as it is.  Gathering a dimension over an axis (the
    all-gather) is a reshard to ``None`` on it.  Under autograd its
    transpose is the reduce-scatter of :class:`_Reshard`."""
    spec = tuple(spec)
    if spec == x.spec:
        return x
    return Placed(_Reshard.apply(x.mesh, _reshard_plan(x, spec), *x.pieces),
                  x.mesh, spec)


def gather_axis(x: Placed, axis: str) -> Placed:
    """``x`` with every dimension on ``axis`` gathered whole (the
    all-gather over ``axis``, parts in rank order)."""
    return reshard(x, tuple(None if ax == axis else ax for ax in x.spec))


def group_pieces(x: Union[Placed, PerShard], axis: str,
                 mesh: Optional[DeviceMesh] = None) -> PerShard:
    """Each shard's group along ``axis``: the group's pieces (or
    per-shard values) in rank order, each moved to the shard (its own
    as it is)."""
    mesh = x.mesh if mesh is None else mesh
    pieces = x.pieces if isinstance(x, Placed) else x
    return PerShard(
        tuple(pieces[r] if r == s else mesh.move(pieces[r], s, src=r)
              for r in mesh.group(axis, s))
        for s in range(mesh.nshards))


def _rank_sum(parts):
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _reduce_pieces(pieces, mesh: DeviceMesh, axis: str) -> list:
    out = []
    for s, group in enumerate(group_pieces(PerShard(pieces), axis, mesh)):
        with mesh.on(s):
            out.append(_rank_sum(group))
    return out


class _ReduceSum(torch.autograd.Function):
    """:func:`reduce_sum` under autograd.  Every output of a group is
    the same sum, and each carries a partial of its gradient: each input
    piece's gradient is its group's output gradients summed in rank
    order (moved to it), the same bits on every shard of the group."""

    @staticmethod
    def forward(ctx, mesh, axis, *pieces):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_reduce_pieces(pieces, mesh, axis))

    @staticmethod
    def backward(ctx, *grads):
        wait_current(ctx.mesh)
        out = _reduce_pieces(grads, ctx.mesh, ctx.axis)
        return (None, None) + _bw_join(ctx.mesh, out)


def reduce_sum(x: Placed, axis: str) -> Placed:
    """The sum over ``axis`` (the reference's ``psum``): every shard
    gets its group's pieces moved to it and added in rank order, from
    rank 0's, so every shard of a group holds the same bits.  Under
    autograd the transpose is the same sum of the output gradients
    (:class:`_ReduceSum`)."""
    if x.mesh.shape[axis] == 1:
        return x
    return Placed(_ReduceSum.apply(x.mesh, axis, *x.pieces), x.mesh, x.spec)


def _scatter_pieces(pieces, mesh: DeviceMesh, axis: str, dim: int) -> list:
    """Each shard's range of ``dim`` of its group's pieces, moved to it
    (its own as it is) and added in rank order from rank 0's."""
    step = pieces[0].shape[dim] // mesh.shape[axis]
    out = []
    for s in range(mesh.nshards):
        lo = mesh.coords(s)[axis] * step
        parts = [pieces[r].narrow(dim, lo, step) if r == s else
                 mesh._copy(pieces[r].narrow(dim, lo, step), s, src=r)
                 for r in mesh.group(axis, s)]
        with mesh.on(s):
            out.append(_rank_sum(parts))
    return out


class _ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter` under autograd.  Its transpose is the
    all-gather: each input piece's gradient is its group's output
    gradients joined along the scattered dimension in rank order."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, spec, *pieces):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.out_spec = tuple(axis if i == dim else ax
                             for i, ax in enumerate(spec))
        return tuple(_scatter_pieces(pieces, mesh, axis, dim))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        wait_current(mesh)
        # the all-gather: a reshard of the output gradients to the input's
        # spec, each part copied into place in rank order
        g = Placed(grads, mesh, ctx.out_spec)
        out = _reshard_pieces(grads, mesh, _reshard_plan(g, ctx.spec),
                              grads[0].dtype)
        return (None, None, None, None) + _bw_join(mesh, out)


def reduce_scatter(x: Placed, axis: str, dim: int) -> Placed:
    """The sum over ``axis`` of the partial pieces of ``x``, each shard
    keeping its rank's range of dimension ``dim`` (whole in ``x``, cut
    into the axis' extent of equal parts): only that range of each of
    its group's pieces is moved to it, and the ranges are added in rank
    order from rank 0's, so each piece is element for element the
    matching rows of :func:`reduce_sum`'s.  Under autograd the transpose
    is the all-gather of the output gradients in rank order
    (:class:`_ReduceScatter`)."""
    n = x.mesh.shape[axis]
    if n == 1:
        return x
    if x.spec[dim] is not None or axis in x.spec or x.shape[dim] % n:
        raise ValueError(f"cannot reduce-scatter dimension {dim} of {x} "
                         f"over {axis!r}")
    pieces = _ReduceScatter.apply(x.mesh, axis, dim, x.spec, *x.pieces)
    return Placed(pieces, x.mesh, tuple(axis if i == dim else ax
                                        for i, ax in enumerate(x.spec)))


def heads_to_seq(x: Placed, ranges: Sequence[Tuple[int, int]],
                 seq_dim: int = 1, head_dim: int = 2) -> PerShard:
    """The head-to-sequence relayout of a prefill's keys or values: from
    ``x``, its heads on the model axis (or whole) and its positions
    whole, to each shard holding positions ``ranges[s] = (lo, hi)`` of
    every head, its model group's head pieces of those positions moved
    to it and joined in rank order (the all-to-all).  With the heads
    whole each shard slices its own piece.  The ranges need not split
    the positions evenly, so the result is one tensor a shard."""
    mesh = x.mesh
    pieces = []
    for s, (lo, hi) in enumerate(ranges):
        if x.spec[head_dim] is None:
            pieces.append(x.pieces[s].narrow(seq_dim, lo, hi - lo))
            continue
        parts = []
        for r in mesh.group("model", s):
            part = x.pieces[r].narrow(seq_dim, lo, hi - lo)
            parts.append(part if r == s else mesh.move(part, s, src=r))
        with mesh.on(s):
            pieces.append(torch.cat(parts, dim=head_dim))
    return PerShard(pieces)


def _whole_regions(x: Placed) -> list:
    """Each shard's region of the whole tensor in :func:`to_whole`, or
    ``None`` for a replica that rank 0 of its axis gives instead."""
    mesh, ext, shape = x.mesh, x.mesh.shape, x.shape
    out = []
    for s in range(mesh.nshards):
        c = mesh.coords(s)
        if any(c[a] for a in mesh.axis_names if a not in x.spec):
            out.append(None)
        else:
            out.append(tuple(_part(n, ax, c, ext)
                             for n, ax in zip(shape, x.spec)))
    return out


def _whole(pieces, mesh: DeviceMesh, shape, regions) -> torch.Tensor:
    out = torch.empty(shape, dtype=pieces[0].dtype, device=mesh.device)
    for s, region in enumerate(regions):
        if region is not None:
            mesh._copy(pieces[s], None, src=s, out=_region(out, region))
    return out


class _ToWhole(torch.autograd.Function):
    """:func:`to_whole` under autograd: each part's slice of the whole
    gradient goes back to the piece it came from, nothing to the
    replicas it skipped."""

    @staticmethod
    def forward(ctx, mesh, shape, regions, *pieces):
        ctx.mesh, ctx.regions = mesh, regions
        return _whole(pieces, mesh, shape, regions)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        wait_current(mesh)
        out = [None if region is None else mesh._copy(_region(g, region), s)
               for s, region in enumerate(ctx.regions)]
        return (None, None, None) + _bw_join(mesh, out)


def to_whole(x: Placed) -> torch.Tensor:
    """The whole tensor on shard 0's device (the current stream there),
    each part moved from the first shard that holds it.  Under autograd
    each part's gradient goes back to that shard (:class:`_ToWhole`)."""
    return _ToWhole.apply(x.mesh, x.shape, _whole_regions(x), *x.pieces)


def _mean(pieces, mesh: DeviceMesh) -> torch.Tensor:
    parts = [mesh._copy(p, None, src=s) for s, p in enumerate(pieces)]
    return _rank_sum(parts) / mesh.nshards


class _MeanOverMesh(torch.autograd.Function):
    """:func:`mean_over_mesh` under autograd: each piece gets ``1 /
    nshards`` of the gradient, moved to its shard."""

    @staticmethod
    def forward(ctx, mesh, *pieces):
        ctx.mesh = mesh
        return _mean(pieces, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        wait_current(mesh)
        share = g / mesh.nshards
        out = [mesh._copy(share, s) for s in range(mesh.nshards)]
        return (None,) + _bw_join(mesh, out)


def mean_over_mesh(x: Placed) -> torch.Tensor:
    """The mean of a 0-d placed value over every shard (the reference's
    ``pmean`` over all axes), summed in shard order on shard 0's
    device."""
    return _MeanOverMesh.apply(x.mesh, *x.pieces)


def replica_groups(x: Placed) -> list:
    """The shards holding each part of ``x``, one tuple a part in the
    order of its first shard, each in rank (shard) order: the shards
    that differ only on the axes ``x``'s spec does not use."""
    mesh = x.mesh
    groups: Dict[Tuple[int, ...], list] = {}
    for s in range(mesh.nshards):
        c = mesh.coords(s)
        key = tuple(c[a] for a in mesh.axis_names if a in x.spec)
        groups.setdefault(key, []).append(s)
    return [tuple(g) for g in groups.values()]


def sum_replica_grads(x: Placed, grads: Sequence[Optional[torch.Tensor]]
                      ) -> Placed:
    """The gradient of the placed parameter ``x`` from its pieces'
    partial gradients ``grads`` (``None``: zero): each part's replicas'
    gradients summed once, in rank order, on the part's first shard, and
    that sum copied to every other replica, so that every replica holds
    the same bits.  An fsdp leaf's data parts were reduce-scattered by
    its gather's backward; here its model replicas are summed, and a
    replicated leaf's over data and model."""
    mesh = x.mesh
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(x.pieces, grads)]
    out = list(grads)
    for group in replica_groups(x):
        if len(group) == 1:
            continue
        first = group[0]
        parts = [grads[first]] + [mesh.move(grads[r], first, src=r)
                                  for r in group[1:]]
        with mesh.on(first):
            total = _rank_sum(parts)
        out[first] = total
        for r in group[1:]:
            out[r] = mesh.move(total, r, src=first)
    return Placed(out, mesh, x.spec)


# ----------------------------------------------------------------------
# Sharded vectors
# ----------------------------------------------------------------------
_aten = torch.ops.aten
#: elementwise ops a sharded vector runs slab by slab, each on its shard's
#: stream (a 0-d operand moved to each shard first)
_POINTWISE = {_aten.add.Tensor, _aten.sub.Tensor, _aten.mul.Tensor,
              _aten.div.Tensor, _aten.add.Scalar, _aten.sub.Scalar,
              _aten.mul.Scalar, _aten.div.Scalar, _aten.neg.default,
              _aten.clone.default, _aten.detach.default,
              _aten.zeros_like.default, _aten.empty_like.default,
              _aten.full_like.default, _aten._to_copy.default}


class ShardedVector(torch.Tensor):
    """A vector of a sharded solve: one slab a shard, each a tensor of its
    own on its shard's device (``slabs``, in shard order, and ``mesh``).
    A sharded grid of the PCG grid steps is one too: its slabs are
    ``(nz / n, ny, nx)`` z-slabs, the first dimension split.

    It is a wrapper tensor of the whole shape (shard 0's device is its
    ``device``), so the solvers' step bodies run on it unchanged: the
    elementwise ops in ``_POINTWISE`` run slab by slab on each shard's
    stream, ``copy_`` copies slab into slab, a view that keeps every
    slab whole (the whole shape, a grid flattened, a vector viewed as
    whole planes) is the same view of each slab, and an index range of
    the first dimension inside one shard is that slab's piece.
    Every other op raises ``NotImplementedError`` naming it: nothing
    gathers the slabs onto one device but :func:`gather` (and
    :func:`replicate`), called where the API hands a result back."""

    slabs: Tuple[torch.Tensor, ...]
    mesh: DataMesh

    @staticmethod
    def __new__(cls, slabs: Sequence[torch.Tensor], mesh: DataMesh):
        slabs = tuple(slabs)
        if len(slabs) != mesh.nshards:
            raise ValueError(f"{len(slabs)} slabs for a mesh of "
                             f"{mesh.nshards} shards")
        rest = slabs[0].shape[1:]
        for s, slab in enumerate(slabs):
            if (slab.dim() < 1 or slab.shape[1:] != rest
                    or slab.device != mesh.devices[s]
                    or slab.dtype != slabs[0].dtype):
                raise ValueError(
                    f"slab {s} must be a {slabs[0].dtype} tensor of shape "
                    f"(n, *{tuple(rest)}) on {mesh.devices[s]}, got "
                    f"{slab.dtype} of shape {tuple(slab.shape)} on "
                    f"{slab.device}")
        n = sum(slab.shape[0] for slab in slabs)
        out = torch.Tensor._make_wrapper_subclass(
            cls, (n, *rest), dtype=slabs[0].dtype, device=mesh.device)
        out.slabs, out.mesh = slabs, mesh
        return out

    def __repr__(self) -> str:
        shape = self.shape[0] if self.dim() == 1 else tuple(self.shape)
        return (f"ShardedVector(n={shape}, dtype={self.dtype}, "
                f"devices={[str(d) for d in self.mesh.devices]})")

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Each slab's first index in the whole vector (of the first
        dimension, for a grid)."""
        out, at = [], 0
        for slab in self.slabs:
            out.append(at)
            at += slab.shape[0]
        return tuple(out)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _POINTWISE:
            return _pointwise(func, args, kwargs)
        if func is _aten.copy_.default:
            return _copy_into(*args, **kwargs)
        if func in (_aten.view.default, _aten._unsafe_view.default,
                    _aten.alias.default):
            return _alias(func, *args)
        if func is _aten.slice.Tensor:
            return _slab_piece(*args)
        raise NotImplementedError(
            f"{func} is not an op a ShardedVector runs: it would read "
            f"across shards; gather explicitly "
            f"(repro_torch.distributed.sharding.gather)")


def _operand(a, s: int, mesh: DataMesh):
    """Shard ``s``'s part of one operand of an elementwise op: a slab, a
    0-d tensor moved to the shard (a host scalar as it is), a number."""
    if isinstance(a, ShardedVector):
        return a.slabs[s]
    if isinstance(a, torch.Tensor):
        if a.dim() != 0:
            raise NotImplementedError(
                f"an elementwise op between a ShardedVector and a plain "
                f"tensor of shape {tuple(a.shape)}: place the tensor on the "
                f"mesh first (ShardedOperator.device_put)")
        if a.device.type == "cpu" and mesh.device.type == "cuda":
            return a
        return mesh.move(a, s)
    return a


def _pointwise(func, args, kwargs) -> ShardedVector:
    if kwargs.get("device") is not None:
        raise NotImplementedError(f"{func} with device= on a ShardedVector")
    first = next(a for a in args if isinstance(a, ShardedVector))
    mesh, shapes = first.mesh, [slab.shape for slab in first.slabs]
    for a in args:
        if isinstance(a, ShardedVector) and (
                a.mesh != mesh or [x.shape for x in a.slabs] != shapes):
            raise ValueError(f"{func}: sharded vectors on different meshes "
                             f"or layouts")
    outs = []
    for s in range(mesh.nshards):
        # the operands move before the shard's stream is made current: a
        # 0-d operand's producer is the caller's stream
        operands = [_operand(a, s, mesh) for a in args]
        with mesh.on(s):
            outs.append(func(*operands, **kwargs))
    return ShardedVector(outs, mesh)


def _copy_into(dst, src, non_blocking: bool = False) -> ShardedVector:
    if not (isinstance(dst, ShardedVector) and isinstance(src, ShardedVector)
            and dst.mesh == src.mesh
            and [x.shape for x in dst.slabs] == [x.shape for x in src.slabs]):
        raise NotImplementedError(
            "copy_ runs between sharded vectors of one layout only")
    for s, (d, v) in enumerate(zip(dst.slabs, src.slabs)):
        with dst.mesh.on(s):
            d.copy_(v)
    return dst


def _alias(func, x: ShardedVector, shape=None) -> ShardedVector:
    if shape is None or tuple(shape) == tuple(x.shape):
        return ShardedVector(x.slabs, x.mesh)
    shape = tuple(shape)
    rest = shape[1:]
    row = math.prod(rest)
    if (-1 in rest or row < 1 or any(slab.numel() % row for slab in x.slabs)
            or shape[0] not in (-1, x.numel() // row)):
        raise NotImplementedError(
            f"{func} to shape {tuple(shape)}: a ShardedVector views each "
            f"slab whole, along its first dimension")
    return ShardedVector([slab.view(-1, *rest) for slab in x.slabs], x.mesh)


def _slab_piece(x: ShardedVector, dim: int = 0, start=None, end=None,
                step: int = 1) -> torch.Tensor:
    """``x[start:end]`` where the range lies inside one shard: that slab's
    piece, on its device."""
    start, end, _ = slice(start, end).indices(x.shape[0])
    for off, slab in zip(x.offsets, x.slabs):
        if dim == 0 and step == 1 and off <= start and end <= off + len(slab):
            return slab[start - off:end - off]
    raise NotImplementedError(
        f"x[{start}:{end}:{step}] spans more than one shard of a "
        f"ShardedVector")


def _whole_on(t: ShardedVector, device: torch.device) -> torch.Tensor:
    """The whole of ``t`` on ``device`` (the current stream there), each
    slab moved into its place from its shard."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    for s, (off, slab) in enumerate(zip(t.offsets, t.slabs)):
        t.mesh.move(slab, device, src=s, out=out[off:off + len(slab)])
    return out


def gather(t: torch.Tensor) -> torch.Tensor:
    """The whole vector on shard 0's device (the current stream there):
    the one function that gathers a sharded vector's slabs, called where
    the API hands a result back.  A plain tensor comes back as it is."""
    if not isinstance(t, ShardedVector):
        return t
    return _whole_on(t, t.mesh.device)


def replicate(t: ShardedVector) -> Tuple[torch.Tensor, ...]:
    """A whole copy of ``t`` on each distinct device of its mesh, in the
    order of their first shards: the reference's replicated ``P()``
    value on a mesh (the grid steps' in-memory ESR copy of ``p``).  One
    copy where every shard shares a device."""
    return tuple(_whole_on(t, dev) for dev in dict.fromkeys(t.mesh.devices))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A vector on the host as numpy: a sharded one slab by slab, each
    pulled on its shard's stream into one host buffer in block order."""
    if not isinstance(t, ShardedVector):
        return t.detach().cpu().numpy()
    out = torch.empty(t.shape, dtype=t.dtype)
    for s, (off, slab) in enumerate(zip(t.offsets, t.slabs)):
        with t.mesh.on(s):
            # straight into the host buffer, on the shard's stream
            out[off:off + len(slab)].copy_(slab.detach())
    return out.numpy()


# ----------------------------------------------------------------------
# The sharded partition and operator
# ----------------------------------------------------------------------
class ShardedPartition:
    """A block partition whose vectors may be :class:`ShardedVector` s of
    ``layout`` on ``mesh``: the restrictions read the failed blocks'
    pieces from their shards (by :meth:`DataMesh.move`, onto the device
    of the first block's shard, the recovery's device), the scatters and
    fills write them into copies of the touched slabs on their shards.
    A plain tensor goes to the base partition."""

    def __init__(self, base, layout: "ShardLayout", mesh: DataMesh):
        self.base, self.layout, self.mesh = base, layout, mesh

    def __getattr__(self, name):
        return getattr(self.base, name)

    def _pieces(self, blocks: Sequence[int]):
        """``(shard, lo, hi, start)``: each run of consecutive blocks of
        ``blocks`` inside one shard, as a range of its slab and the run's
        first value in the union vector."""
        bs, bps = self.base.block_size, self.layout.blocks_per_shard
        out = []
        for i, blk in enumerate(blocks):
            s, lo = divmod(blk, bps)
            if (out and out[-1][0] == s and out[-1][2] == lo * bs
                    and blk == blocks[i - 1] + 1):
                out[-1][2] += bs
            else:
                out.append([s, lo * bs, (lo + 1) * bs, i * bs])
        return out

    def device_of(self, x, blocks: Sequence[int]) -> torch.device:
        if not isinstance(x, ShardedVector):
            return x.device
        return self.mesh.devices[self.layout.shard_of_block(blocks[0])]

    def restrict(self, x, blocks: Sequence[int]) -> torch.Tensor:
        if not isinstance(x, ShardedVector):
            return self.base.restrict(x, blocks)
        dev = self.device_of(x, blocks)
        out = torch.empty(len(blocks) * self.base.block_size, dtype=x.dtype,
                          device=dev)
        for s, lo, hi, start in self._pieces(blocks):
            self.mesh.move(x.slabs[s][lo:hi], dev, src=s,
                           out=out[start:start + hi - lo])
        return out

    def _rewrite(self, x: ShardedVector, blocks: Sequence[int],
                 write) -> ShardedVector:
        slabs = list(x.slabs)
        touched = set()
        for s, lo, hi, start in self._pieces(blocks):
            if s not in touched:
                touched.add(s)
                with self.mesh.on(s):
                    slabs[s] = slabs[s].clone()
            write(s, slabs[s][lo:hi], start)
        return ShardedVector(slabs, self.mesh)

    def scatter(self, x, v: torch.Tensor, blocks: Sequence[int]):
        if not isinstance(x, ShardedVector):
            return self.base.scatter(x, v, blocks)

        def write(s, piece, start):
            self.mesh.move(v[start:start + len(piece)], s, out=piece)

        return self._rewrite(x, blocks, write)

    def fill_blocks(self, x, blocks: Sequence[int], value: float):
        if not isinstance(x, ShardedVector):
            return self.base.fill_blocks(x, blocks, value)

        def write(s, piece, start):
            with self.mesh.on(s):
                piece.fill_(value)

        return self._rewrite(x, blocks, write)

    def zero_blocks(self, x, blocks: Sequence[int]):
        if not isinstance(x, ShardedVector):
            return self.base.zero_blocks(x, blocks)
        return self.fill_blocks(x, blocks, 0.0)

    def map_blocks(self, x, fn):
        if not isinstance(x, ShardedVector):
            return self.base.map_blocks(x, fn)
        outs = []
        for s, slab in enumerate(x.slabs):
            with self.mesh.on(s):
                outs.append(fn(slab, self.layout.blocks_of(s)))
        return ShardedVector(outs, self.mesh)


class ShardedOperator:
    """An operator whose vectors are laid out block-sharded on a ``data``
    mesh: :class:`ShardedVector` s, one slab a shard.

    Every attribute but those below (``nblocks``, ``n``, ``diag``,
    ``grid``, ...) delegates to the base operator.  The wrapper adds
    ``layout`` and ``mesh`` — the driver and the solvers' order-pinned
    reductions key off both (``getattr(op, "mesh", None)``) —, a
    :class:`ShardedPartition` as ``partition`` and :meth:`device_put`.
    ``apply`` on a :class:`~repro_torch.core.poisson.StencilOperator`
    runs K1's halo mode once per slab, on its shard's device and stream,
    after moving each slab's two halo planes from its neighbours, and
    counts the halo bytes in ``halo_bytes``; ``offblock_apply`` reads
    the planes around the failed runs from their shards.  A plain tensor
    goes to the base operator (on a one-device mesh the stencil still
    runs slab by slab)."""

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
        self.partition = ShardedPartition(base.partition, layout, mesh)
        #: bytes the sharded applies have moved between shards (halo
        #: planes), since construction
        self.halo_bytes = 0

    def __getattr__(self, name):
        return getattr(self.base, name)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        base = self.base
        stencil = isinstance(base, StencilOperator)
        if isinstance(x, ShardedVector):
            if not stencil:
                raise NotImplementedError(
                    f"a sharded apply of {type(base).__name__}: only the "
                    f"stencil's z-slabs are laid out on a mesh")
            _, ny, nx = base.grid
            self.halo_bytes += halo_nbytes(base.grid, self.layout.nshards,
                                           x.dtype)
            out = slab_stencil7([slab.view(-1, ny, nx) for slab in x.slabs],
                                self.mesh)
            return ShardedVector([o.view(-1) for o in out], self.mesh)
        if not stencil or x.dim() != 1:
            return base.apply(x)
        nshards = self.layout.nshards
        self.halo_bytes += halo_nbytes(base.grid, nshards, x.dtype)
        return sharded_stencil7(x.reshape(base.grid), nshards).reshape(-1)

    def inblock_apply(self, v: torch.Tensor, blocks: Sequence[int]):
        """``A[F, F] v`` of the union vector ``v`` (on the recovery's
        device): the base's."""
        return self.base.inblock_apply(v, blocks)

    def offblock_apply(self, x: torch.Tensor, blocks: Sequence[int]):
        """``A[F, ~F] x[~F]``: for a sharded stencil vector, the planes
        next to each failed run moved from their shards to the recovery's
        device, and K1's halo mode there over a zero slab."""
        if not isinstance(x, ShardedVector):
            return self.base.offblock_apply(x, blocks)
        if not isinstance(self.base, StencilOperator):
            raise NotImplementedError(
                f"offblock_apply of a sharded {type(self.base).__name__}")
        base, mesh = self.base, self.mesh
        dev = self.partition.device_of(x, blocks)
        planes = base.grid[0] // self.layout.nshards
        _, ny, nx = base.grid

        def plane(z):
            s, at = divmod(z, planes)
            return mesh.move(x.slabs[s].view(planes, ny, nx)[at], dev, src=s)

        return base.offblock_from_planes(blocks, plane, x.dtype, dev)

    def device_put(self, x: torch.Tensor) -> "ShardedVector":
        """Place a full-length vector on the mesh: slab ``s`` a copy of
        shard ``s``'s range on its device (a sharded vector of this mesh
        is returned as it is)."""
        if isinstance(x, ShardedVector):
            if x.mesh != self.mesh:
                raise ValueError("the vector lives on another mesh")
            return x
        return self.mesh.place(x)


def place_preconditioner(precond, op: ShardedOperator):
    """``precond`` for vectors on ``op``'s mesh: a copy whose ``op`` is
    ``op`` (so its restrictions take sharded vectors), its ``inv_diag``
    placed as a :class:`ShardedVector` and block Jacobi's factors copied
    onto their shards' devices; ``base`` is the original, for callers
    that apply it to plain vectors.  One already placed on ``op`` is
    returned as it is."""
    if getattr(precond, "op", None) is op:
        return precond
    placed = copy.copy(precond)
    placed.op, placed.base = op, precond
    inv_diag = getattr(precond, "inv_diag", None)
    if inv_diag is not None:
        placed.inv_diag = op.device_put(inv_diag)
    if hasattr(precond, "factors"):
        placed.placed_factors = {
            op.layout.blocks_of(s): op.mesh.move(
                precond.factors(op.layout.blocks_of(s)), s)
            for s in range(op.layout.nshards)}
    return placed


def base_preconditioner(precond):
    """The preconditioner a placed one was made from (itself if none)."""
    return getattr(precond, "base", precond)


def shard_problem(op, b: torch.Tensor, nshards: int,
                  mesh: Optional[DataMesh] = None):
    """Shard a block-partitioned problem across ``nshards`` shards.

    Returns ``(sharded_op, sharded_b)``: the operator wrapped in a
    :class:`ShardedOperator` over a 1-D ``data`` mesh (by default every
    shard on ``b``'s device; pass ``mesh=make_data_mesh(nshards)`` for
    one card a shard) and the rhs placed on it as a
    :class:`ShardedVector`.  ``nshards`` must divide the operator's block
    count (blocks are the failure unit; shards are whole groups of
    them)."""
    layout = ShardLayout(nblocks=op.nblocks, nshards=nshards)
    if mesh is None:
        mesh = make_data_mesh(nshards, device=b.device)
    sharded = ShardedOperator(op, layout, mesh)
    return sharded, sharded.device_put(b)


def place_state(state, mesh: DataMesh, vector_fields: Sequence[str]):
    """Re-pin a solver state NamedTuple to the mesh: every vector field a
    :class:`ShardedVector` (a plain one placed by :meth:`DataMesh.place`),
    every other tensor on shard 0's device.  The driver applies it after
    ``init_state`` and after ``reconstruct``."""
    out = {}
    for f, v in zip(state._fields, state):
        if f in vector_fields and not isinstance(v, ShardedVector):
            v = mesh.place(v)
        elif isinstance(v, torch.Tensor) and not isinstance(v, ShardedVector):
            v = v.to(mesh.device)
        out[f] = v
    return type(state)(**out)
