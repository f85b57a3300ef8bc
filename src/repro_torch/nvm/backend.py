"""The persistence-backend API (port of the ``repro/nvm/backend.py``
subset the port's paths need; numpy, and torch for the erasure stripe's
device encode).

- :class:`PersistenceBackend` — the ABC every backend implements: it
  *declares* its guarantee through :class:`BackendCapabilities` and
  *opens* a :class:`PersistSession` for each solve.
- :class:`PersistSession` — the per-solve lifecycle the driver speaks:
  ``begin/commit/drain/abort`` (overlapped pipeline), ``persist``
  (synchronous write-through), ``fetch``, ``durable_run`` and the failure
  injection points ``fail`` / ``fail_storage``.
- :class:`CoreBackendSession` over the schema-driven NVM backends, and
  the backend registry with its spec parser, holding ``nvm-prd``,
  ``nvm-homogeneous`` and the K+P Reed-Solomon stripe ``erasure(...)``
  (:class:`ErasureCodedBackend`, :class:`ErasureSession`).

The replicated and tiered composites, the in-memory ``esr`` backend and
the deprecated pre-zoo entry points are not ported yet.  The slot wire
format is the reference's, byte for byte.
"""
from __future__ import annotations

import abc
import dataclasses
import difflib
import re
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_cg import stripe_bytes
from repro_torch.nvm import gf256
from repro_torch.nvm.store import CostModel, PersistStager, Tier

if TYPE_CHECKING:
    from repro_torch.core.state import RecoverySchema, RecoverySet  # noqa: F401


class UnrecoverableFailure(RuntimeError):
    """The recovery data needed to reconstruct a failed block is gone —
    every redundancy copy died with the failure, or the persistence
    service itself (PRD node, local pools, peer RAM) was lost and the
    backend's :class:`BackendCapabilities` do not cover that loss."""


OVERLAP_NATIVE = "native"
OVERLAP_DRIVER_STAGED = "driver-staged"


@dataclass
class SessionTraffic:
    """Per-device-shard byte accounting at the driver/session boundary
    (DESIGN.md §10).

    Counts *logical* slot-payload bytes as the driver sees them — what a
    node's NIC moves to (persist) or from (recovery fetch) the
    persistence service for the blocks a shard owns.  Composites meter
    once at the top of the storage tree: a replicated quorum read serves
    from ONE mirror, an erasure fetch reassembles K chunks that sum to
    one slot, so in both cases a recovery moves exactly the lost shard's
    slot bytes.  Keys are shard indices (everything is shard 0 for an
    unsharded solve)."""

    persist_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    fetch_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)

    def note_persist(self, shard: int, nbytes: int) -> None:
        self.persist_bytes[shard] = self.persist_bytes.get(shard, 0) + nbytes

    def note_fetch(self, shard: int, nbytes: int) -> None:
        self.fetch_bytes[shard] = self.fetch_bytes.get(shard, 0) + nbytes


@dataclass(frozen=True)
class BackendCapabilities:
    """What a backend *guarantees*, declared instead of implied.

    - ``durability`` — the tier recovery data rests on once committed:
      ``"ram"`` (volatile peer memory), ``"nvm"``, or ``"ssd"``.
      Composites join their children's tiers (``"ram+nvm"``).
    - ``survives_node_loss`` — committed recovery data remains usable
      after compute-node failures (possibly after the node returns, as
      in the homogeneous architecture).
    - ``survives_prd_loss`` — committed recovery data remains usable
      after the persistence-service node itself (the PRD node, the
      local pool service, the peer-RAM fabric) crashes.  Only
      redundant compositions can honestly declare this.
    - ``overlap`` — ``"native"`` when the backend pipelines
      ``begin/commit`` itself; ``"driver-staged"`` when overlap is
      provided by fronting it with a volatile staging tier.
    - ``max_block_failures`` — largest set of concurrently failed
      blocks a fetch can serve; ``None`` means unbounded (any number
      of compute blocks may fail simultaneously).
    - ``max_storage_failures`` — how many persistence-service (PRD /
      pool / storage) node losses committed data remains fetchable
      through: 0 for the base architectures, ``N-1`` for an N-way
      mirror, 1 for a K+parity erasure stripe.  Must agree with
      ``survives_prd_loss`` (which is this field viewed as a boolean);
      the campaign planner (:func:`repro_torch.solvers.driver.plan_campaign`)
      budgets ``FailureEvent(prd=True)`` events against it.
    """

    durability: str
    survives_node_loss: bool
    survives_prd_loss: bool
    overlap: str
    max_block_failures: Optional[int] = None
    max_storage_failures: int = 0

    def __post_init__(self):
        if self.overlap not in (OVERLAP_NATIVE, OVERLAP_DRIVER_STAGED):
            raise ValueError(
                f"overlap must be {OVERLAP_NATIVE!r} or "
                f"{OVERLAP_DRIVER_STAGED!r}, got {self.overlap!r}")
        if not self.durability:
            raise ValueError("durability tier must be a non-empty string")
        if not isinstance(self.max_storage_failures, int) \
                or self.max_storage_failures < 0:
            raise ValueError(
                f"max_storage_failures must be an int >= 0, got "
                f"{self.max_storage_failures!r}")
        if self.survives_prd_loss != (self.max_storage_failures > 0):
            raise ValueError(
                f"incoherent capabilities: survives_prd_loss="
                f"{self.survives_prd_loss} but max_storage_failures="
                f"{self.max_storage_failures}; a backend survives PRD "
                f"loss exactly when it tolerates >= 1 storage failure")

    def max_shard_failures(self, blocks_per_shard: int) -> Optional[int]:
        """The shard-axis view of ``max_block_failures``: how many
        whole device shards (of ``blocks_per_shard`` contiguous blocks
        each, DESIGN.md §10) a fetch can serve concurrently.  ``None``
        passes through from an unbounded block budget; otherwise the
        declared block budget is divided — killing a shard kills every
        block it owns, so a backend that serves ``B`` block failures
        serves exactly ``B // blocks_per_shard`` shard failures."""
        if blocks_per_shard < 1:
            raise ValueError(
                f"blocks_per_shard must be >= 1, got {blocks_per_shard}")
        if self.max_block_failures is None:
            return None
        return self.max_block_failures // blocks_per_shard


class PersistSession(abc.ABC):
    """One solve's persistence stream on an open backend.

    The driver speaks only this interface; costs are modeled seconds
    (the simulation contract of ``nvm/store.py``).  Lifecycle::

        session = backend.open_session(schema)
        session.persist(k, scalars, vectors)      # sync write-through
        session.begin(...); session.commit()      # overlapped pipeline
        session.fail(blocks); session.drain()     # failure + barrier
        sets = session.fetch(failed_blocks, ks)   # recovery reads
    """

    def __init__(self, schema: RecoverySchema):
        self.schema = schema
        self._storage_down = False
        self._trace = None
        self.traffic = SessionTraffic()
        self._shard_of_block: Optional[Dict[int, int]] = None
        self._slot_nbytes: Optional[int] = None

    # -- per-shard addressing (DESIGN.md §10) ---------------------------
    def bind_shards(self, shard_of_block: Optional[Mapping[int, int]] = None,
                    slot_nbytes: Optional[int] = None) -> None:
        """Bind the block -> owning-device-shard map (and the per-block
        slot payload size) so the session can address and meter traffic
        per shard.  The driver calls this once per solve with the
        block -> shard map (all blocks -> shard 0: the port runs
        unsharded solves only); composite
        sessions propagate the *map* to their children like
        :meth:`set_tracer`, but only the driver-bound top session gets
        ``slot_nbytes`` — metering happens once, at the driver boundary."""
        if shard_of_block is not None:
            self._shard_of_block = {int(b): int(s)
                                    for b, s in shard_of_block.items()}
        if slot_nbytes is not None:
            self._slot_nbytes = int(slot_nbytes)

    def _note_persist_traffic(self) -> None:
        """Meter one persisted event: every block's slot chunk leaves its
        owning shard.  No-op until the driver binds both the shard map
        and the slot size."""
        if self._slot_nbytes is None or self._shard_of_block is None:
            return
        for shard in self._shard_of_block.values():
            self.traffic.note_persist(shard, self._slot_nbytes)

    def _note_fetch_traffic(self, blocks: Sequence[int], nruns: int) -> None:
        """Meter one served recovery fetch: only the failed blocks' slot
        chunks move, ``nruns`` (= ``schema.history``) slots per block —
        the recovery-traffic-proportional-to-the-lost-shard claim."""
        if self._slot_nbytes is None or self._shard_of_block is None:
            return
        for blk in blocks:
            self.traffic.note_fetch(self._shard_of_block.get(int(blk), 0),
                                    nruns * self._slot_nbytes)

    # -- observability (DESIGN.md §9) -----------------------------------
    def set_tracer(self, tracer) -> None:
        """Attach a ``repro_torch.obs`` tracer (detach with None or any falsy
        tracer).  The driver calls this once per solve when tracing is
        enabled; composite sessions propagate it to their children, so
        one call instruments the whole storage tree.  Sessions guard
        every record site with ``if self._trace is not None`` — with no
        tracer attached the session runs zero tracer callables."""
        self._trace = tracer or None

    # -- fused persist staging (DESIGN.md §13) --------------------------
    def set_encode_mode(self, mode: str) -> None:
        """Accept one of the reference's parity-encode mode names
        (``"ref"``, ``"pallas"``, ``"auto"``) so its call sites port
        unchanged.  In the port the route follows the vectors a stripe
        is handed (:class:`ErasureSession`), so no session changes
        behaviour; the stripe validates the name, the base ignores it."""

    # -- overlapped pipeline (DESIGN.md §6) -----------------------------
    @abc.abstractmethod
    def begin(self, k: int, scalars: Mapping[str, float],
              vectors: Mapping[str, np.ndarray]) -> float:
        """Stage a persistence event; returns the critical-path cost."""

    @abc.abstractmethod
    def commit(self) -> float:
        """Flush the oldest staged event; returns the overlappable cost."""

    @abc.abstractmethod
    def drain(self) -> float:
        """Barrier: commit everything staged and settle in-flight epochs
        so every committed event is durable."""

    @abc.abstractmethod
    def abort(self) -> None:
        """Discard staged-but-uncommitted events (they died with their
        origin nodes; an aborted event must never surface later)."""

    # -- synchronous path ----------------------------------------------
    @abc.abstractmethod
    def persist(self, k: int, scalars: Mapping[str, float],
                vectors: Mapping[str, np.ndarray]) -> float:
        """Write one event straight through (the paper's host-pull
        baseline); the whole cost is on the critical path."""

    # -- failure + recovery --------------------------------------------
    @abc.abstractmethod
    def fail(self, blocks: Sequence[int]) -> None:
        """Compute blocks crashed: tear away their in-flight writes and
        whatever recovery copies lived in their volatile memory."""

    def fail_storage(self) -> None:
        """The persistence-service node itself crashed (the ROADMAP's
        'campaign event that kills the PRD node').  The base behavior is
        honest non-survival: committed data becomes unreachable and a
        later :meth:`fetch` raises :class:`UnrecoverableFailure` instead
        of serving data that no longer exists.  Redundant composites
        override this to absorb the loss."""
        self._storage_down = True
        self.abort()

    @abc.abstractmethod
    def fetch(self, failed_blocks: Sequence[int],
              ks: Sequence[int]) -> List[RecoverySet]:
        """Read the recovery sets for iterations ``ks`` over the failed
        union (vectors concatenated in ``failed_blocks`` order).  Must
        raise :class:`UnrecoverableFailure` — never return stale or
        partial data — when the request cannot be served exactly."""

    @abc.abstractmethod
    def durable_run(self) -> Optional[int]:
        """Newest iteration ending a durable consecutive
        ``schema.history``-run, or None before the first complete run."""

    # -- guards ---------------------------------------------------------
    def _check_storage(self) -> None:
        if self._storage_down:
            raise UnrecoverableFailure(
                "persistence-service (PRD) node was lost and this backend "
                "does not declare survives_prd_loss; recovery data is "
                "unreachable")


class PersistenceBackend(abc.ABC):
    """A persistence backend: declared capabilities + session factory.

    Concrete backends also keep whatever storage-level surface they
    need (pools, PRD node, accounting); the driver only ever touches
    the session returned by :meth:`open_session`.
    """

    #: registry name ("esr", "nvm-prd", "replicated", ...)
    name: str = ""

    @property
    @abc.abstractmethod
    def capabilities(self) -> BackendCapabilities:
        """The declared guarantee record (instance-level: e.g. the
        in-memory backend's failure tolerance depends on ``copies``)."""

    @abc.abstractmethod
    def open_session(self, schema: Optional[RecoverySchema] = None,
                     partition=None) -> PersistSession:
        """Open the per-solve lifecycle.  ``schema`` (when given) must
        match the schema the backend was sized for; ``partition`` is
        accepted for future unbound backends and validated when the
        backend knows its own geometry."""

    # -- accounting (paper Fig. 2/8 benchmarks) -------------------------
    def memory_overhead_values(self) -> int:
        """Redundancy values resident in volatile RAM."""
        return 0

    def nvm_values(self) -> int:
        """Values resident on persistent tiers."""
        return 0


def _validate_schema(backend, schema: Optional[RecoverySchema]):
    bound = getattr(backend, "schema", None)
    if schema is not None and bound is not None and bound != schema:
        raise ValueError(
            f"backend persists schema {bound.solver!r} but the session "
            f"was opened for {schema.solver!r}; construct the backend "
            f"with the solver's schema (see repro_torch.solvers.registry."
            f"make_backend)")
    if schema is None and bound is None:
        raise ValueError("open_session needs a schema for an unbound backend")
    return bound if schema is None else schema


class SchemaDrivenBackend(PersistenceBackend):
    """Shared base for the schema-driven storage backends (the NVM
    architectures): session opening with schema/partition
    validation, and the stager-abort hook sessions use on storage loss.
    Concrete classes declare their own :class:`BackendCapabilities`."""

    nblocks: int

    def open_session(self, schema: Optional[RecoverySchema] = None,
                     partition=None) -> "CoreBackendSession":
        schema = _validate_schema(self, schema)
        if (partition is not None
                and getattr(partition, "nblocks", self.nblocks) != self.nblocks):
            raise ValueError(
                f"backend sized for {self.nblocks} blocks but the "
                f"partition has {partition.nblocks}")
        return CoreBackendSession(self, schema)

    def persist_abort(self) -> None:
        """Abort staged-but-uncommitted payloads (storage-loss teardown;
        ``fail()`` also aborts as part of the failure model)."""
        self._stager.abort()


# ----------------------------------------------------------------------
# The RAM staging front: a volatile tier that buys overlap for any
# backend whose own pipeline is synchronous (a duck-typed object that
# speaks only persist_set).
# ----------------------------------------------------------------------
class RAMFront:
    """Double-buffered volatile staging buffer with tier-modeled cost."""

    def __init__(self, flush: Callable[..., float], tier: Tier = Tier.DRAM,
                 cost_model: Optional[CostModel] = None):
        self.tier = tier
        self._stager = PersistStager(flush, cost_model=cost_model)
        # PersistStager models its staging copy as a DRAM write; other
        # front tiers scale by the tier's write cost ratio on commit-path
        # accounting (kept simple: DRAM is the only front used today).
        if tier is not Tier.DRAM:
            raise ValueError("only a DRAM front is calibrated; see §7")

    @property
    def pending(self) -> int:
        return self._stager.pending

    def begin(self, k, scalars, vectors) -> float:
        return self._stager.begin(k, scalars, vectors)

    def commit(self) -> float:
        return self._stager.commit()

    def drain(self) -> float:
        return self._stager.drain()

    def abort(self) -> int:
        return self._stager.abort()


# ----------------------------------------------------------------------
# Sessions over the schema-driven core backends (InMemoryESR,
# NVMESRHomogeneous, NVMESRPRD — and any external object speaking
# persist_set/recover_set/fail).
# ----------------------------------------------------------------------
class CoreBackendSession(PersistSession):
    """Session over a schema-driven backend.

    Backends with a native ``persist_begin/commit/drain`` pipeline are
    delegated to directly; backends exposing only ``persist_set`` are
    fronted by a :class:`RAMFront`, which is exactly the overlap
    behavior the driver used to hand-roll for them.
    """

    def __init__(self, backend, schema: RecoverySchema):
        super().__init__(schema)
        self._backend = backend
        self._native = hasattr(backend, "persist_begin")
        self._front = None if self._native else RAMFront(backend.persist_set)

    def set_tracer(self, tracer) -> None:
        super().set_tracer(tracer)
        # stage/drain attribution comes from the stager itself — the
        # driver-side front's, or the native backend's internal one
        if self._front is not None:
            self._front._stager.tracer = self._trace
        stager = getattr(self._backend, "_stager", None)
        if stager is not None:
            stager.tracer = self._trace

    # -- pipeline -------------------------------------------------------
    def begin(self, k, scalars, vectors) -> float:
        if self._storage_down:
            return 0.0  # the put target is gone; the event is lost
        self._note_persist_traffic()
        if self._native:
            return self._backend.persist_begin(k, scalars, vectors)
        return self._front.begin(k, scalars, vectors)

    def commit(self) -> float:
        if self._storage_down:
            self.abort()
            return 0.0
        if self._native:
            return self._backend.persist_commit()
        return self._front.commit()

    def drain(self) -> float:
        if self._storage_down:
            self.abort()
            return 0.0
        if self._native:
            return self._backend.persist_drain()
        return self._front.drain()

    def abort(self) -> None:
        if self._native:
            # core backends abort their stager inside fail(); expose it
            # directly where available for storage-loss teardown
            aborter = getattr(self._backend, "persist_abort", None)
            if aborter is not None:
                aborter()
        else:
            self._front.abort()

    # -- sync path ------------------------------------------------------
    def persist(self, k, scalars, vectors) -> float:
        if self._storage_down:
            return 0.0
        self._note_persist_traffic()
        cost = self._backend.persist_set(k, scalars, vectors)
        if self._trace is not None:
            self._trace.event("backend.write", k=k, cost_s=cost,
                              backend=type(self._backend).__name__)
        return cost

    # -- failure + recovery ---------------------------------------------
    def fail(self, blocks: Sequence[int]) -> None:
        self._backend.fail(tuple(blocks))
        if not self._native:
            self._front.abort()

    def fail_storage(self) -> None:
        super().fail_storage()
        crash = getattr(self._backend, "storage_crash", None)
        if crash is not None:
            crash()

    def fetch(self, failed_blocks, ks) -> List[RecoverySet]:
        self._check_storage()
        sets = self._backend.recover_set(tuple(failed_blocks), tuple(ks))
        self._note_fetch_traffic(failed_blocks, len(ks))
        return sets

    def durable_run(self) -> Optional[int]:
        if self._storage_down:
            return None
        runner = getattr(self._backend, "durable_run", None)
        return None if runner is None else runner()


def open_persist_session(backend, schema: RecoverySchema,
                         partition=None) -> PersistSession:
    """Normalize a backend object into a :class:`PersistSession`.

    - a :class:`PersistenceBackend` opens its own session;
    - a schema-duck-typed object (``persist_set``/``recover_set``) is
      wrapped in a :class:`CoreBackendSession`.
    """
    if isinstance(backend, PersistenceBackend) or hasattr(backend, "open_session"):
        return backend.open_session(schema, partition)
    if hasattr(backend, "persist_set"):
        return CoreBackendSession(backend, _validate_schema(backend, schema))
    raise TypeError(
        f"{type(backend).__name__} is not a persistence backend: expected "
        f"a PersistenceBackend or a persist_set/recover_set object")


# ----------------------------------------------------------------------
# Erasure-coded composition (RAID-5/6-style rotating parity, DESIGN.md §8)
# ----------------------------------------------------------------------
#: reserved scalar every stripe child persists alongside the solver's
#: scalars: the stripe's parity-rotation offset, recorded durably so a
#: degraded fetch can undo the rotation from any surviving child.
STRIPE_ROT_SCALAR = "_stripe_rot"

#: the reference's parity-encode mode names (DESIGN.md §13), accepted
#: so its call sites port unchanged; in the port the type of the vector
#: handed to a stripe picks the route (:class:`ErasureSession`)
ENCODE_MODES = frozenset({"ref", "pallas", "auto"})


def _check_encode_mode(mode: str) -> None:
    if mode not in ENCODE_MODES:
        raise ValueError(
            f"unknown parity encode mode {mode!r}; expected one of "
            f"{sorted(ENCODE_MODES)}")


def stripe_child_schema(schema):
    """The schema stripe children are bound to: the solver's schema plus
    the reserved :data:`STRIPE_ROT_SCALAR` rotation scalar (appended
    last, so the wire layout of the solver's own fields is unchanged).
    Idempotent — a schema already carrying the scalar passes through."""
    scalars = tuple(schema.scalars)
    if scalars and scalars[-1] == STRIPE_ROT_SCALAR:
        return schema
    if STRIPE_ROT_SCALAR in scalars:
        raise ValueError(
            f"schema {schema.solver!r} already uses the reserved scalar "
            f"{STRIPE_ROT_SCALAR!r} in a non-final position")
    return dataclasses.replace(schema, scalars=scalars + (STRIPE_ROT_SCALAR,))


@dataclass(frozen=True)
class StagedStripe:
    """A vector whose stripe kernel K4 (``ops.fused_cg_update_persist``)
    already cut and encoded on the device: ``chunks`` is its
    ``(nblocks, K, chunk)`` chunk array, ``parity`` its
    ``(nblocks, P, chunk * itemsize)`` parity bytes.

    Private to the port: the driver's fused overlap route hands one in
    as the value of a schema vector in ``begin``, in place of the vector
    itself, and :class:`ErasureSession` then only moves the K+P shards
    to the host instead of encoding them again.  Only a session that
    announced a K4 geometry (:meth:`ErasureSession.fused_geometry`) is
    handed one."""

    chunks: torch.Tensor
    parity: torch.Tensor


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class ErasureSession(PersistSession):
    """Stripe every event across K data shards + P parity shards
    (P ∈ {1, 2}) spread over K+P children with **rotating placement**.

    Write path: each slot vector is split block-wise into K equal chunks
    (zero-padded when K does not divide the block size); the P parity
    shards are Reed-Solomon combinations of the K chunks computed on the
    *stored bytes* (:mod:`repro_torch.nvm.gf256`; P=1 is plain XOR
    parity).  Shard-to-child placement rotates per stripe (RAID-5/6):
    for stripe sequence number ``s`` the rotation offset
    ``r = (P·s) mod (K+P)`` maps logical shard ``j`` onto physical child
    ``(j + r) mod (K+P)``, and ``r`` is recorded durably in every child's
    slot (the :data:`STRIPE_ROT_SCALAR` scalar of the stripe schema).
    Chunks and parity are computed from the same payload and handed to
    the children in one lockstep ``begin``/``persist``.

    The encode route follows the vectors the session is handed:

    - a host numpy vector takes the numpy route (``gf256.rs_encode``),
      byte for byte the reference's ``"ref"`` route;
    - a torch tensor is cut into its K zero-padded chunks on its own
      device and encoded through :func:`repro_torch.kernels.ops.rs_encode`
      (kernel K3 on the card, its plain version on the CPU); the K+P
      shards then cross to the host in one copy;
    - a :class:`StagedStripe` (K4's output) is not encoded again: its
      shards only cross to the host.

    Every route hands the children identical numpy bytes and the same
    rotation.  The vector's type alone picks the route; the encode mode
    (:data:`ENCODE_MODES`) is validated for the reference's call sites
    and selects nothing.  The ``gf256.rs_encode`` span's ``encoder``
    label names the route that ran (``"ref"`` numpy, ``"pallas"`` the
    device route; ``staged`` marks K4's).  ``device_to_host_bytes``
    counts the bytes the device routes copied to the host.

    Read path: ``fetch`` reads every live child, recovers the recorded
    rotation from any surviving slot, un-rotates the shards, and — in
    **degraded mode**, with up to P children lost — reconstructs the
    missing data chunks through the surviving parity
    (:func:`repro_torch.nvm.gf256.rs_reconstruct`), bit-exactly.  More
    than P lost children raise :class:`UnrecoverableFailure`.
    """

    def __init__(self, backend: "ErasureCodedBackend", schema, partition):
        super().__init__(schema)
        self._backend = backend
        self._children = [open_persist_session(c, backend.child_schema, None)
                          for c in backend.children]
        self._stripe_seq = 0
        #: per-child count of parity-shard writes (rotation keeps
        #: max-min <= 1 over any write sequence)
        self.parity_writes = [0] * len(self._children)
        #: bytes the device routes copied to the host
        self.device_to_host_bytes = 0

    def set_tracer(self, tracer) -> None:
        super().set_tracer(tracer)
        for s in self._children:
            s.set_tracer(tracer)

    def set_encode_mode(self, mode: str) -> None:
        _check_encode_mode(mode)

    def bind_shards(self, shard_of_block=None, slot_nbytes=None) -> None:
        super().bind_shards(shard_of_block, slot_nbytes)
        for s in self._children:
            s.bind_shards(shard_of_block=shard_of_block)

    def fused_geometry(self, dtype) -> Optional[Tuple[int, int]]:
        """``(K, P)`` when kernel K4 may stage this stripe's vectors of
        ``dtype`` — K dividing the block size and the stripe storing
        ``dtype`` — else None.  The driver asks once, before its loop."""
        be = self._backend
        if be.block_size % be.k_data != 0 or np.dtype(dtype) != be.dtype:
            return None
        return be.k_data, be.nparity

    # -- stripe geometry ------------------------------------------------
    def _rotation(self) -> int:
        """Allocate the next stripe's rotation offset.  Stepping by P
        (not 1) tiles the parity role over the children so per-child
        parity-write counts never differ by more than one stripe."""
        be = self._backend
        r = (be.nparity * self._stripe_seq) % len(self._children)
        self._stripe_seq += 1
        return r

    def _numpy_shards(self, v) -> List[np.ndarray]:
        """The reference's route: K chunks and P parity shards in numpy."""
        be = self._backend
        k_data, nb, bs, chunk = be.k_data, be.nblocks, be.block_size, be.chunk
        v = np.asarray(v, be.dtype).reshape(nb, bs)
        padded = np.zeros((nb, k_data * chunk), be.dtype)
        padded[:, :bs] = v
        chunks = [np.ascontiguousarray(padded[:, j * chunk:(j + 1) * chunk]
                                       ).reshape(-1)
                  for j in range(k_data)]
        parity = gf256.rs_encode([c.view(np.uint8) for c in chunks],
                                 be.nparity)
        return chunks + [q.view(be.dtype) for q in parity]

    def _device_bytes(self, v) -> torch.Tensor:
        """The ``(K+P, L)`` uint8 shards of a tensor or a
        :class:`StagedStripe`, on its device."""
        be = self._backend
        if isinstance(v, StagedStripe):
            parity = v.parity.transpose(0, 1).reshape(be.nparity, -1)
            return torch.cat([stripe_bytes(v.chunks), parity])
        k_data, nb, bs, chunk = be.k_data, be.nblocks, be.block_size, be.chunk
        v = v.detach().to(_torch_dtype(be.dtype)).reshape(nb, bs)
        if k_data * chunk != bs:
            padded = torch.zeros((nb, k_data * chunk), dtype=v.dtype,
                                 device=v.device)
            padded[:, :bs] = v
            v = padded
        data = stripe_bytes(v.reshape(nb, k_data, chunk))
        return torch.cat([data, ops.rs_encode(data, be.nparity)])

    @staticmethod
    def _on_device(v) -> bool:
        return isinstance(v, (StagedStripe, torch.Tensor))

    def _encode(self, v) -> List[np.ndarray]:
        if not self._on_device(v):
            return self._numpy_shards(v)
        host = self._device_bytes(v).cpu().numpy()  # the one D2H copy
        self.device_to_host_bytes += host.nbytes
        return [row.view(self._backend.dtype) for row in host]

    def _shards(self, vectors) -> List[Dict[str, np.ndarray]]:
        """Split full vectors into K logical chunk vectors + P parity
        shards, each on the route its vector's type selects (class
        docstring).  Chunking happens on the *stored* dtype so the parity
        covers exactly the bits the data children persist."""
        be = self._backend
        out: List[Dict[str, np.ndarray]] = [
            dict() for _ in range(be.k_data + be.nparity)]
        for name in self.schema.vectors:
            v = vectors[name]
            if self._trace is None:
                shards = self._encode(v)
            else:
                encoder = "pallas" if self._on_device(v) else "ref"
                with self._trace.span("gf256.rs_encode", vector=name,
                                      k_data=be.k_data, nparity=be.nparity,
                                      encoder=encoder,
                                      staged=isinstance(v, StagedStripe)):
                    shards = self._encode(v)
            for j, shard in enumerate(shards):
                out[j][name] = shard
        return out

    def _live(self) -> List[PersistSession]:
        return [s for s in self._children if not s._storage_down]

    def _fan_out(self, method: str, k, scalars, vectors) -> float:
        """One lockstep stripe write (begin or persist): data chunks and
        parity leave the same origin NIC back to back, so the modeled
        origin-visible cost is the sum over children — each carrying
        ~1/K of the payload bytes."""
        be = self._backend
        shards = self._shards(vectors)
        rot = self._rotation()
        scalars = dict(scalars)
        scalars[STRIPE_ROT_SCALAR] = float(rot)
        nchildren = len(self._children)
        cost = 0.0
        for j in range(nchildren):
            child = (j + rot) % nchildren
            if j >= be.k_data:
                self.parity_writes[child] += 1
            c = getattr(self._children[child], method)(k, scalars, shards[j])
            if self._trace is not None:
                self._trace.event("stripe.write", child=child, shard=j,
                                  parity=j >= be.k_data, rot=rot, cost_s=c)
            cost += c
        return cost

    # -- pipeline -------------------------------------------------------
    def begin(self, k, scalars, vectors) -> float:
        if self._storage_down:
            return 0.0  # the stripe is gone; the event is lost
        self._note_persist_traffic()
        return self._fan_out("begin", k, scalars, vectors)

    def commit(self) -> float:
        return sum(s.commit() for s in self._children)

    def drain(self) -> float:
        return sum(s.drain() for s in self._children)

    def abort(self) -> None:
        for s in self._children:
            s.abort()

    def persist(self, k, scalars, vectors) -> float:
        if self._storage_down:
            return 0.0
        self._note_persist_traffic()
        return self._fan_out("persist", k, scalars, vectors)

    # -- failure + recovery ---------------------------------------------
    def fail(self, blocks: Sequence[int]) -> None:
        for s in self._children:
            s.fail(blocks)

    def fail_storage(self) -> None:
        """One stripe node crashes (ordered: the first storage-loss event
        takes child 0, the next child 1, ...).  The stripe serves
        degraded fetches while at most P children are lost."""
        for s in self._children:
            if not s._storage_down:
                s.fail_storage()
                break
        if len(self._live()) < self._backend.k_data:
            self._storage_down = True  # > P losses: beyond the code distance

    def fetch(self, failed_blocks, ks) -> List[RecoverySet]:
        be = self._backend
        nchildren = len(self._children)
        per_child: List[Optional[List[RecoverySet]]] = []
        errors: List[str] = []
        for j, s in enumerate(self._children):
            if s._storage_down:
                per_child.append(None)
                errors.append(f"child {j}: storage lost")
                continue
            try:
                per_child.append(s.fetch(failed_blocks, ks))
            except (UnrecoverableFailure, RuntimeError) as e:
                per_child.append(None)
                errors.append(f"child {j}: {e}")
        missing = [j for j, r in enumerate(per_child) if r is None]
        if missing and len(missing) <= be.nparity and self._trace is not None:
            self._trace.event("stripe.degraded", missing=tuple(missing),
                              nparity=be.nparity)
        if len(missing) > be.nparity:
            raise UnrecoverableFailure(
                f"erasure stripe lost {len(missing)} of {nchildren} "
                f"children — {be.nparity}-parity Reed-Solomon "
                f"reconstructs at most {be.nparity} — for iterations "
                f"{tuple(ks)} over blocks {tuple(failed_blocks)}: "
                + "; ".join(errors))
        sets = [self._assemble(per_child, i, kk, tuple(failed_blocks))
                for i, kk in enumerate(ks)]
        # the K data chunks (or their parity reconstruction) reassemble
        # into exactly one slot copy per failed block per run
        self._note_fetch_traffic(failed_blocks, len(ks))
        return sets

    def _assemble(self, per_child, i: int, kk: int,
                  failed: Tuple[int, ...]) -> RecoverySet:
        """Reassemble one iteration's union set from the stripe shards:
        recover the recorded rotation, un-rotate physical children back
        to logical shard order, and rebuild up to P missing data chunks
        through the surviving parity."""
        from repro_torch.core.state import RecoverySet

        be = self._backend
        k_data, chunk, bs = be.k_data, be.chunk, be.block_size
        nchildren = len(self._children)
        nf = len(failed)
        sets = [None if r is None else r[i] for r in per_child]
        donor = next(s for s in sets if s is not None)
        if any(s is not None and s.k != kk for s in sets):
            raise UnrecoverableFailure(
                f"erasure stripe children disagree on iteration {kk}")
        # The rotation is stripe metadata, persisted in every child's
        # slot — read it back rather than re-deriving it, and insist the
        # survivors agree (a disagreement means mixed stripes).
        rots = {s.scalars[STRIPE_ROT_SCALAR] for s in sets if s is not None}
        if len(rots) != 1:
            raise UnrecoverableFailure(
                f"erasure stripe children disagree on the parity rotation "
                f"of iteration {kk}: {sorted(rots)}")
        rot = int(rots.pop())
        logical = [sets[(j + rot) % nchildren] for j in range(nchildren)]
        vectors = {}
        for name in self.schema.vectors:
            shards = [None if s is None else np.ascontiguousarray(
                          np.asarray(s.vectors[name], be.dtype)
                      ).view(np.uint8)
                      for s in logical]
            try:
                if self._trace is None:
                    data = gf256.rs_reconstruct(shards, k_data)
                else:
                    with self._trace.span("gf256.rs_decode", vector=name,
                                          k=kk, missing=tuple(
                                              j for j, s in enumerate(shards)
                                              if s is None)):
                        data = gf256.rs_reconstruct(shards, k_data)
            except ValueError as e:
                raise UnrecoverableFailure(
                    f"erasure stripe cannot reconstruct iteration {kk}: "
                    f"{e}") from None
            data = [d.view(be.dtype) for d in data]
            stacked = np.stack([d.reshape(nf, chunk) for d in data], axis=1)
            vectors[name] = np.ascontiguousarray(
                stacked.reshape(nf, k_data * chunk)[:, :bs]).reshape(-1)
        scalars = {n: v for n, v in donor.scalars.items()
                   if n != STRIPE_ROT_SCALAR}
        return RecoverySet(kk, scalars, vectors)

    def durable_run(self) -> Optional[int]:
        if self._storage_down:
            return None
        runs = [s.durable_run() for s in self._live()]
        if not runs or any(r is None for r in runs):
            return None
        # live children write in lockstep; min is the conservative join
        return min(runs)


def _join_tiers(children) -> str:
    tiers = []
    for c in children:
        t = c.capabilities.durability
        if t not in tiers:
            tiers.append(t)
    return "+".join(tiers)


class ErasureCodedBackend(PersistenceBackend):
    """K+P erasure coding (Reed-Solomon over GF(2^8), P ∈ {1, 2}) with
    rotating parity placement over K+P children.

    Surviving P simultaneous storage-node losses costs a (P+1)-way mirror
    (P+1)x storage, but the stripe only (K+P)/K — the paper's
    memory-footprint argument applied to the redundancy layer itself.
    Spec strings: ``"erasure(nvm-prd x4+p)"`` (4 data + 1 XOR parity,
    distance 2) and ``"erasure(nvm-prd x4+2p)"`` (4 data + P/Q parity,
    distance 3: **any two** children may die).

    Children are *roles rotated per stripe*, so no child is a dedicated
    parity node; the ``data_children``/``parity_children`` split only
    sizes the pool.  All children must be bound to the stripe schema
    (:func:`stripe_child_schema`); the registry factory does this.
    """

    name = "erasure"

    def __init__(self, data_children: Sequence[PersistenceBackend],
                 parity_children, block_size: int, encode: str = "ref"):
        if isinstance(parity_children, PersistenceBackend):
            parity_children = [parity_children]
        _check_encode_mode(encode)
        if len(data_children) < 2:
            raise ValueError(
                f"erasure coding needs >= 2 data children, got "
                f"{len(data_children)} — with one data child the parity "
                f"is a mirror; use replicated(...)")
        if not 1 <= len(parity_children) <= gf256.MAX_PARITY:
            raise ValueError(
                f"erasure coding supports 1 (xK+p) or 2 (xK+2p) parity "
                f"children, got {len(parity_children)} — for more "
                f"distance use replicated(...)")
        self.data_children = list(data_children)
        self.parity_children = list(parity_children)
        self.children = self.data_children + self.parity_children
        if len({id(c) for c in self.children}) != len(self.children):
            # An aliased child is one storage node wearing two stripe
            # hats: its second write lands on the first's slots, and a
            # "survivable" single loss then serves corrupted fetches.
            raise ValueError(
                "stripe children must be distinct backend instances — "
                "the same object appears twice (pass distinct backends, "
                "or spec strings so the factory builds one per role)")
        schemas = {getattr(c, "schema", None) for c in self.children}
        if len(schemas) != 1:
            raise ValueError("all stripe children must persist the same schema")
        nblocks = {c.nblocks for c in self.children}
        if len(nblocks) != 1:
            raise ValueError("all stripe children must cover the same blocks")
        self.nblocks = nblocks.pop()
        self.k_data = len(self.data_children)
        self.nparity = len(self.parity_children)
        self.block_size = int(block_size)
        self.chunk = -(-self.block_size // self.k_data)  # ceil
        self.dtype = np.dtype(getattr(self.children[0], "dtype", np.float64))
        bad = [c.block_size for c in self.children
               if getattr(c, "block_size", self.chunk) != self.chunk]
        if bad:
            raise ValueError(
                f"stripe children must be sized for chunk {self.chunk} "
                f"(= ceil({self.block_size}/{self.k_data})), got {bad}")
        self.child_schema = self.children[0].schema
        child_scalars = tuple(self.child_schema.scalars)
        if not child_scalars or child_scalars[-1] != STRIPE_ROT_SCALAR:
            raise ValueError(
                f"stripe children must persist the stripe schema — the "
                f"solver's schema plus the trailing {STRIPE_ROT_SCALAR!r} "
                f"rotation scalar; bind them with "
                f"schema=stripe_child_schema(schema), or build the stripe "
                f"through create_backend('erasure(...)') which does so")
        # what the driver sees: the solver's own schema, rotation hidden
        self.schema = dataclasses.replace(self.child_schema,
                                          scalars=child_scalars[:-1])

    @property
    def capabilities(self) -> BackendCapabilities:
        caps = [c.capabilities for c in self.children]
        maxes = [c.max_block_failures for c in caps]
        return BackendCapabilities(
            durability=_join_tiers(self.children),
            survives_node_loss=all(c.survives_node_loss for c in caps),
            # the stripe's guarantee: any P children (whatever role the
            # current rotation gives them) may be lost and every
            # committed event remains exact
            survives_prd_loss=True,
            overlap=(OVERLAP_NATIVE
                     if all(c.overlap == OVERLAP_NATIVE for c in caps)
                     else OVERLAP_DRIVER_STAGED),
            max_block_failures=(None if all(m is None for m in maxes)
                                else min(m for m in maxes if m is not None)),
            max_storage_failures=self.nparity,  # P+Q: distance P+1
        )

    def open_session(self, schema=None, partition=None) -> PersistSession:
        schema = _validate_schema(self, schema)
        if partition is not None:
            if getattr(partition, "nblocks", self.nblocks) != self.nblocks:
                raise ValueError(
                    f"stripe sized for {self.nblocks} blocks but the "
                    f"partition has {partition.nblocks}")
            if getattr(partition, "block_size",
                       self.block_size) != self.block_size:
                raise ValueError(
                    f"stripe sized for block_size {self.block_size} but "
                    f"the partition has {partition.block_size}")
        return ErasureSession(self, schema, partition)

    def memory_overhead_values(self) -> int:
        return sum(c.memory_overhead_values() for c in self.children)

    def nvm_values(self) -> int:
        return sum(c.nvm_values() for c in self.children)


# ----------------------------------------------------------------------
# The backend registry
# ----------------------------------------------------------------------
# name -> factory(nblocks, block_size, dtype, schema=..., **opts)
_REGISTRY: Dict[str, Callable] = {}
_SPEC_RE = re.compile(r"^(?P<name>[\w.-]+)\s*(?:\((?P<args>[^()]*)\))?$")
_STRIPE_RE = re.compile(
    r"^(?P<child>[\w.-]+)\s*[x×]\s*(?P<n>\d+)\s*\+\s*(?P<p>\d+)?p$")


def register_backend(name: str, factory: Callable) -> None:
    """Register a backend factory under ``name``.  The factory signature
    is ``factory(nblocks, block_size, dtype, schema=..., **opts) ->
    PersistenceBackend``."""
    _REGISTRY[name] = factory


def register_backend_class(name: str, cls) -> None:
    """Register a backend class whose constructor is ``cls(nblocks,
    block_size, dtype, **opts)`` with a ``schema`` keyword defaulting
    internally."""

    def build(nblocks, block_size, dtype, schema=None, **opts):
        if schema is not None:
            opts["schema"] = schema
        return cls(nblocks, block_size, dtype, **opts)

    build.__name__ = f"make_{cls.__name__}"
    register_backend(name, build)


def _ensure_builtin() -> None:
    # The core backends register themselves at import; import them
    # lazily here to avoid a core <-> nvm module cycle.
    if "nvm-prd" not in _REGISTRY:
        import repro_torch.core.nvm_esr  # noqa: F401


def backend_names() -> List[str]:
    """All registered backend names."""
    _ensure_builtin()
    return sorted(_REGISTRY)


def unknown_name_error(kind: str, name: str, have) -> KeyError:
    """A registry miss with a did-you-mean hint (closest match)."""
    have = sorted(have)
    msg = f"unknown {kind} {name!r}"
    close = difflib.get_close_matches(str(name), have, n=1, cutoff=0.5)
    if close:
        msg += f" — did you mean {close[0]!r}?"
    return KeyError(f"{msg}; have {have}")


def parse_backend_spec(spec: str) -> Tuple[str, dict]:
    """Parse a backend spec string into ``(name, opts)``.

    Grammar::

        "nvm-prd"                -> ("nvm-prd", {})
        "erasure(nvm-prd x4+p)"  -> ("erasure", {"data": ("nvm-prd",)*4,
                                                 "nparity": 1})
        "erasure(nvm-prd x6+2p)" -> ("erasure", {"data": ("nvm-prd",)*6,
                                                 "nparity": 2})

    Argument text of any other family is kept so :func:`create_backend`
    can refuse it by name."""
    m = _SPEC_RE.match(spec.strip())
    if m is None:
        raise ValueError(f"malformed backend spec {spec!r}")
    name, args = m.group("name"), m.group("args")
    if args is None:
        return name, {}
    args = args.strip()
    if name == "erasure":
        stripe = _STRIPE_RE.match(args)
        if stripe is None:
            raise ValueError(
                f"malformed erasure spec {spec!r}: expected "
                f"'erasure(<child> xK+Pp)' (K data nodes + P parity, "
                f"P in {{1, 2}}), e.g. 'erasure(nvm-prd x4+p)' or "
                f"'erasure(nvm-prd x6+2p)'")
        return name, {"data": (stripe.group("child"),) * int(stripe.group("n")),
                      "nparity": int(stripe.group("p") or 1)}
    return name, {"spec_args": args}


def create_backend(spec: str, nblocks: int, block_size: int,
                   dtype=np.float64, **opts) -> PersistenceBackend:
    """Build a backend from a registry name or stripe spec (the single
    constructor path: :func:`repro_torch.solvers.registry.make_backend`
    sizes it from an operator)."""
    _ensure_builtin()
    name, spec_opts = parse_backend_spec(spec)
    if name not in _REGISTRY:
        raise unknown_name_error("backend", name, _REGISTRY)
    if "spec_args" in spec_opts:
        raise ValueError(
            f"backend {name!r} takes no spec arguments, got {spec!r}")
    merged = {**spec_opts, **opts}
    return _REGISTRY[name](nblocks, block_size, dtype, **merged)


def _erasure_factory(nblocks, block_size, dtype,
                     data: Sequence = ("nvm-prd",) * 4,
                     parity: Optional[str] = None,
                     nparity: int = 1,
                     schema=None, encode: str = "ref",
                     **opts) -> ErasureCodedBackend:
    """Build the stripe: children are sized for the chunk (1/K of the
    block, zero-padded) and bound to the stripe schema (the solver's
    schema + the rotation scalar), so the stripe's total footprint is
    ~(K+P)/K of a single backend's."""
    # the constructor refuses K < 2 and P outside {1, 2}
    chunk = -(-int(block_size) // max(len(data), 1))  # ceil
    if schema is None:
        from repro_torch.core.state import PCG_SCHEMA

        schema = PCG_SCHEMA
    child_schema = stripe_child_schema(schema)

    def build(spec):
        if isinstance(spec, PersistenceBackend):
            return spec
        return create_backend(spec, nblocks, chunk, dtype,
                              schema=child_schema, **opts)

    children = [build(c) for c in data]
    parity_spec = parity if parity is not None else data[0]
    parity_children = [build(parity_spec) for _ in range(int(nparity))]
    return ErasureCodedBackend(children, parity_children, block_size,
                               encode=encode)


register_backend("erasure", _erasure_factory)
