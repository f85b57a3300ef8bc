"""The persistence-backend API (port of the ``repro/nvm/backend.py``
subset the main path needs; numpy only).

- :class:`PersistenceBackend` — the ABC every backend implements: it
  *declares* its guarantee through :class:`BackendCapabilities` and
  *opens* a :class:`PersistSession` for each solve.
- :class:`PersistSession` — the per-solve lifecycle the driver speaks:
  ``begin/commit/drain/abort`` (overlapped pipeline), ``persist``
  (synchronous write-through), ``fetch``, ``durable_run`` and the failure
  injection points ``fail`` / ``fail_storage``.
- :class:`CoreBackendSession` over the schema-driven NVM backends, and
  the backend registry with its spec parser, holding ``nvm-prd`` and
  ``nvm-homogeneous``.

The replicated, tiered and erasure composites, the in-memory ``esr``
backend and the deprecated pre-zoo entry points are not ported yet.  The
slot wire format is the reference's, byte for byte.
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
# The backend registry
# ----------------------------------------------------------------------
# name -> factory(nblocks, block_size, dtype, schema=..., **opts)
_REGISTRY: Dict[str, Callable] = {}
_SPEC_RE = re.compile(r"^(?P<name>[\w.-]+)\s*(?:\((?P<args>[^()]*)\))?$")


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
    """Parse a backend spec string into ``(name, opts)``.  The port's
    registry holds only argument-free families (``"nvm-prd"``); argument
    text is kept so :func:`create_backend` can refuse it by name."""
    m = _SPEC_RE.match(spec.strip())
    if m is None:
        raise ValueError(f"malformed backend spec {spec!r}")
    name, args = m.group("name"), m.group("args")
    if args is None:
        return name, {}
    return name, {"spec_args": args.strip()}


def create_backend(spec: str, nblocks: int, block_size: int,
                   dtype=np.float64, **opts) -> PersistenceBackend:
    """Build a backend from a registry name (the single constructor
    path: :func:`repro_torch.solvers.registry.make_backend` sizes it from
    an operator)."""
    _ensure_builtin()
    name, spec_opts = parse_backend_spec(spec)
    if name not in _REGISTRY:
        raise unknown_name_error("backend", name, _REGISTRY)
    if "spec_args" in spec_opts:
        raise ValueError(
            f"backend {name!r} takes no spec arguments, got {spec!r}")
    return _REGISTRY[name](nblocks, block_size, dtype, **opts)
