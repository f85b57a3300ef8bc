"""NVM-ESR: persistence of the minimal recovery set to NVRAM (paper §3-4);
port of ``repro/core/nvm_esr.py`` (numpy only).

Two architectures:

- :class:`NVMESRHomogeneous` — every block persists its shard to **local**
  NVM through a ``libpmemobj``-like pool (paper §4.2, Fig. 5) or, by tier
  choice, to a local SSD (the paper's reference point).  If a block's
  node fails, its pool becomes unreachable until the node recovers
  (Algorithm 5, homogeneous branch) — recovery then reads from the local
  pool, which survived the crash.

- :class:`NVMESRPRD` — all blocks persist to a **remote PRD node** via MPI
  one-sided communication over RDMA with PSCW epochs (paper §4.1, Fig. 4).
  Recovery data stays reachable by every surviving rank even while failed
  nodes are down; reconstruction can start immediately on spare ranks.

Both are **schema-driven** (solver-zoo generalization): slot payloads are
encoded from any solver's :class:`~repro_torch.core.state.RecoverySchema`
(named vectors + scalars), and the slot ring is sized to the schema's
recovery ``history`` — ``2 * history`` slots give burst-level double
buffering: the newest *consecutive valid run* of ``history`` iterations
is the recovery point, and a crash tearing the in-flight slot write
leaves the previous run intact (crash-consistency property tests
exercise this).  For PCG (history=2) this is exactly the 4-slot
``(k-1, k)`` pair ring of the original implementation.

RAM overhead: **zero** — this is the paper's headline claim; NVM holds
``O(n)`` values total versus ``O(n * proc)`` RAM for in-memory ESR.
"""
from __future__ import annotations

import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.esr import InMemoryESR
from repro_torch.core.state import (
    PCG_SCHEMA,
    RecoveryPayload,
    RecoverySchema,
    RecoverySet,
    concat_sets,
    legacy_pair,
    newest_complete_run,
    peek_k,
    require_pcg_schema,
    shard_vectors,
    typed_vectors,
)
from repro_torch.nvm.backend import (
    OVERLAP_NATIVE,
    BackendCapabilities,
    DeprecatedBackendTable,
    SchemaDrivenBackend,
    UnrecoverableFailure,
    register_backend_class,
    warn_legacy_call,
)
from repro_torch.nvm.pmdk import PmemPool
from repro_torch.nvm.prd import PRDNode
from repro_torch.nvm.store import CostModel, PersistStager, Store, Tier


def ring_slots(schema: RecoverySchema) -> int:
    """Slot-ring size: double-buffer the ``history``-long recovery run."""
    return max(2, 2 * schema.history)


class NVMESRHomogeneous(SchemaDrivenBackend):
    """Local-NVM persistence (one pool per block / compute node)."""

    name = "nvm-esr-homogeneous"

    def __init__(
        self,
        nblocks: int,
        block_size: int,
        dtype,
        tier: Tier = Tier.NVM,
        pool_dir: Optional[str] = None,
        cost_model: Optional[CostModel] = None,
        schema: RecoverySchema = PCG_SCHEMA,
    ):
        self.nblocks = nblocks
        self.block_size = block_size
        self.dtype = np.dtype(dtype)
        self.schema = schema
        self.slots = ring_slots(schema)
        self.cost = cost_model if cost_model is not None else CostModel()
        slot_bytes = schema.slot_nbytes(block_size, self.dtype)
        self.pools: List[PmemPool] = []
        for b in range(nblocks):
            path = None if pool_dir is None else os.path.join(pool_dir, f"pool_{b}.pmem")
            # x2 inside PmemPool (its own double buffer) x ring entries
            store = Store((slot_bytes + 64) * self.slots * 2, tier=tier,
                          path=path, cost_model=self.cost)
            pool = PmemPool(store, layout="nvm-esr")
            for s in range(self.slots):
                pool.create(f"slot{s}", slot_bytes)
            self.pools.append(pool)
        self._down: set = set()
        self._event = 0  # persistence-event counter (NOT k: ESRP persists
        #                  with gaps, and k % slots would overwrite a slot
        #                  that is still part of the last complete run)
        self._stager = PersistStager(self.persist_set, cost_model=self.cost)

    @property
    def capabilities(self) -> BackendCapabilities:
        """Local pools survive a node crash (Algorithm 5 waits for the
        node to return), but the pool service itself is the node — a
        persistence-service loss is not survivable without mirroring."""
        return BackendCapabilities(
            durability=self.pools[0].store.tier.value,
            survives_node_loss=True,
            survives_prd_loss=False,
            overlap=OVERLAP_NATIVE,
            max_block_failures=None,
        )

    def storage_crash(self) -> None:
        """Persistence-service loss: every pool's node power-fails at
        once (unflushed writes torn).  Reachability is gone regardless;
        sessions guard fetches with :class:`UnrecoverableFailure`."""
        self._stager.abort()
        for pool in self.pools:
            pool.store.crash()

    # -- overlapped persistence (DESIGN.md §6): stage now, flush later
    def persist_begin(self, k: int, scalars: Mapping[str, float],
                      vectors: Mapping[str, np.ndarray]) -> float:
        """Stage the payload (local DRAM copy); the pmem slot write happens
        at :meth:`persist_commit` and overlaps the next iteration."""
        return self._stager.begin(k, scalars, vectors)

    def persist_commit(self) -> float:
        """Flush the oldest staged payload through the local pools."""
        return self._stager.commit()

    def persist_drain(self) -> float:
        """Drain barrier: commit everything staged.  PmemPool commits are
        synchronous-durable (payload->flush->header->flush), so after this
        returns every committed slot survives a crash."""
        return self._stager.drain()

    # ------------------------------------------------------------------
    def persist_set(self, k: int, scalars: Mapping[str, float],
                    vectors: Mapping[str, np.ndarray]) -> float:
        """Persistence iteration: each block persists its own shard locally.

        Embarrassingly parallel across nodes (paper §5), so the modeled
        wall cost is the **max** over blocks, not the sum.
        """
        slot = self._event % self.slots
        self._event += 1
        typed = typed_vectors(self.schema, vectors, self.dtype)
        per_block = []
        for b, pool in enumerate(self.pools):
            shards = shard_vectors(self.schema, typed, b, self.block_size)
            payload = self.schema.encode(k, scalars, shards)
            per_block.append(pool.persist(f"slot{slot}", payload))
        cost = max(per_block)
        self.cost.add("persist_wall", cost)
        return cost

    def persist(self, k: int, beta: float, p_full: np.ndarray) -> float:
        """Legacy PCG-shaped persist (pre-zoo API; deprecated)."""
        warn_legacy_call(self, "persist")
        require_pcg_schema(self.schema, "persist")
        return self.persist_set(k, {"beta": beta}, {"p": p_full})

    def fail(self, failed_blocks: Sequence[int]) -> None:
        """Node crash: local pools survive but are unreachable until the
        node recovers; in-flight (unflushed) writes are torn away — both
        unflushed store bytes and staged-but-uncommitted payloads."""
        self._stager.abort()
        for b in failed_blocks:
            self.pools[b].store.crash()
            self._down.add(b)

    def node_recovered(self, blocks: Sequence[int]) -> None:
        """Algorithm 5 (homogeneous): wait for failed nodes to come back."""
        for b in blocks:
            self.pools[b].recover()
            self._down.discard(b)

    def recover_set(self, failed_blocks: Sequence[int],
                    ks: Sequence[int]) -> List[RecoverySet]:
        # Homogeneous recovery requires the failed nodes to be up again.
        self.node_recovered(failed_blocks)
        per_k = {kk: [] for kk in ks}
        for b in failed_blocks:
            pool = self.pools[b]
            # content-matched scan: slots are event-addressed, so find the
            # wanted iterations by the k stored in each valid slot (header
            # peek first; only matching slots decode their vectors)
            found = {}
            for sl in range(self.slots):
                raw = pool.read(f"slot{sl}")
                if raw is not None:
                    found[peek_k(raw)] = raw
            for kk in ks:
                if kk not in found:
                    raise UnrecoverableFailure(
                        f"block {b}: no valid slot holds iteration {kk} "
                        f"(have {sorted(found)})")
                per_k[kk].append(self.schema.decode(found[kk], self.dtype))
        return [concat_sets(self.schema, per_k[kk]) for kk in ks]

    def recover(self, failed_blocks: Sequence[int],
                k: int) -> Tuple[RecoveryPayload, RecoveryPayload]:
        """Legacy PCG-shaped recover (pre-zoo API; deprecated): the
        (k-1, k) pair."""
        warn_legacy_call(self, "recover")
        require_pcg_schema(self.schema, "recover")
        return legacy_pair(self.recover_set(failed_blocks, (k - 1, k)))

    def latest_run(self, block: int = 0) -> Optional[int]:
        """Newest k ending a valid consecutive ``history``-run on ``block``."""
        pool = self.pools[block]
        ks = set()
        for s in range(self.slots):
            raw = pool.read(f"slot{s}")
            if raw is not None:
                ks.add(peek_k(raw))
        return newest_complete_run(ks, self.schema.history)

    # the protocol name (PersistSession.durable_run delegates here)
    durable_run = latest_run

    # ------------------------------------------------------------------
    def memory_overhead_values(self) -> int:
        return 0  # the headline claim: zero RAM redundancy

    def nvm_values(self) -> int:
        return self.slots * len(self.schema.vectors) * self.nblocks * self.block_size


class NVMESRPRD(SchemaDrivenBackend):
    """Remote persistence to a PRD sub-cluster node over MPI OSC / RDMA."""

    name = "nvm-esr-prd"

    def __init__(
        self,
        nblocks: int,
        block_size: int,
        dtype,
        tier: Tier = Tier.NVM,
        network: str = "rdma",
        path: Optional[str] = None,
        cost_model: Optional[CostModel] = None,
        async_drain: bool = True,
        schema: RecoverySchema = PCG_SCHEMA,
    ):
        self.nblocks = nblocks
        self.block_size = block_size
        self.dtype = np.dtype(dtype)
        self.schema = schema
        slot_bytes = schema.slot_nbytes(block_size, self.dtype)
        # PRDNode double-buffers by seq parity (2 slots/rank); a
        # ``ring_slots``-deep ring per block is obtained with
        # ``ring_slots/2`` *virtual* ranks per block.
        self.vranks = ring_slots(schema) // 2
        self.prd = PRDNode(
            nranks=nblocks * self.vranks,
            capacity_per_rank=slot_bytes,
            tier=tier,
            network=network,
            path=path,
            cost_model=cost_model,
            async_drain=async_drain,
        )
        self.cost = self.prd.store.cost
        self._event = 0  # persistence-event counter (see NVMESRHomogeneous)
        self._stager = PersistStager(self.persist_set, cost_model=self.cost)

    @property
    def capabilities(self) -> BackendCapabilities:
        """Recovery data stays reachable through arbitrary compute-node
        failures (the PRD architecture's defining property) but the PRD
        node itself is a single point of failure — the paper scopes the
        RAID fix out; the ``erasure(...)`` stripe of
        ``nvm/backend.py`` composes it back in."""
        return BackendCapabilities(
            durability=self.prd.store.tier.value,
            survives_node_loss=True,
            survives_prd_loss=False,
            overlap=OVERLAP_NATIVE,
            max_block_failures=None,
        )

    def storage_crash(self) -> None:
        """The PRD node power-fails: staged origin-side payloads can
        never be put, and unflushed exposure epochs are torn away."""
        self._stager.abort()
        self.prd.crash()

    # -- overlapped persistence (DESIGN.md §6): stage now, put later
    def persist_begin(self, k: int, scalars: Mapping[str, float],
                      vectors: Mapping[str, np.ndarray]) -> float:
        """Stage the payload (local DRAM copy); the PSCW epoch happens at
        :meth:`persist_commit` and overlaps the next iteration.  This
        stacks with the PRD's own target-side overlap: commit returns at
        origin-completion and the PRD drain proceeds asynchronously."""
        return self._stager.begin(k, scalars, vectors)

    def persist_commit(self) -> float:
        """Run the PSCW epoch for the oldest staged payload."""
        return self._stager.commit()

    def persist_drain(self) -> float:
        """Drain barrier: commit staged payloads AND join the PRD exposure
        epoch, so every committed slot is target-side durable."""
        return self._stager.drain() + self.drain()

    # ------------------------------------------------------------------
    def persist_set(self, k: int, scalars: Mapping[str, float],
                    vectors: Mapping[str, np.ndarray]) -> float:
        """One PSCW persistence epoch (paper Fig. 4): all blocks put their
        shard + header, complete, and proceed; the PRD target drains and
        flushes asynchronously.  Returns the origin-visible modeled cost."""
        e = self._event
        self._event += 1
        vr = (e >> 1) % self.vranks  # ring: (vrank offset, parity) by event
        group = [b * self.vranks + vr for b in range(self.nblocks)]
        self.prd.begin_epoch(group)
        typed = typed_vectors(self.schema, vectors, self.dtype)
        origin = 0.0
        for b in range(self.nblocks):
            shards = shard_vectors(self.schema, typed, b, self.block_size)
            payload = self.schema.encode(k, scalars, shards)
            # header seq carries k+1 (content id); the slot is event-chosen
            origin += self.prd.put_rank(b * self.vranks + vr, payload,
                                        seq=k + 1, slot=e & 1)
        self.prd.end_epoch()
        self.cost.add("persist_origin", origin)
        return origin

    def persist(self, k: int, beta: float, p_full: np.ndarray) -> float:
        """Legacy PCG-shaped persist (pre-zoo API; deprecated)."""
        warn_legacy_call(self, "persist")
        require_pcg_schema(self.schema, "persist")
        return self.persist_set(k, {"beta": beta}, {"p": p_full})

    def drain(self) -> float:
        """Join the PRD exposure epoch (target-side persist)."""
        return self.prd.join()

    # ------------------------------------------------------------------
    def fail(self, failed_blocks: Sequence[int]) -> None:
        """Compute-node failures do NOT touch the PRD node: recovery data
        stays reachable (the PRD architecture's defining property).
        Staged-but-uncommitted payloads die with the compute nodes (their
        puts never started); epochs already in flight still complete on
        the PRD side."""
        self._stager.abort()
        self.drain()

    def recover_set(self, failed_blocks: Sequence[int],
                    ks: Sequence[int]) -> List[RecoverySet]:
        per_k = {kk: [] for kk in ks}
        for b in failed_blocks:
            for kk in ks:
                rset = None
                for vr in range(self.vranks):  # content-matched ring scan
                    found = self.prd.read_latest(b * self.vranks + vr,
                                                 want_seq=kk + 1)
                    if found is not None:
                        rset = self.schema.decode(found[1], self.dtype)
                        break
                if rset is None or rset.k != kk:
                    raise UnrecoverableFailure(
                        f"block {b}: no valid PRD slot holds iteration {kk}")
                per_k[kk].append(rset)
        return [concat_sets(self.schema, per_k[kk]) for kk in ks]

    def recover(self, failed_blocks: Sequence[int],
                k: int) -> Tuple[RecoveryPayload, RecoveryPayload]:
        """Legacy PCG-shaped recover (pre-zoo API; deprecated): the
        (k-1, k) pair."""
        warn_legacy_call(self, "recover")
        require_pcg_schema(self.schema, "recover")
        return legacy_pair(self.recover_set(failed_blocks, (k - 1, k)))

    def durable_run(self) -> Optional[int]:
        """Newest iteration ending a complete ``history``-run durable on
        the PRD node (block 0's virtual ranks; this is a drain barrier —
        it joins any in-flight exposure epoch before answering)."""
        ks = set()
        for vr in range(self.vranks):
            for seq, _payload in self.prd.scan_rank(vr):
                ks.add(seq - 1)  # header seq carries k+1
        return newest_complete_run(ks, self.schema.history)

    # ------------------------------------------------------------------
    def memory_overhead_values(self) -> int:
        return 0

    def nvm_values(self) -> int:
        return (2 * self.vranks * len(self.schema.vectors)
                * self.nblocks * self.block_size)


# The NVM architectures in the backend registry
# (:mod:`repro_torch.nvm.backend`); ``repro_torch.solvers.registry.
# make_backend`` and ``repro_torch.api`` size them from an operator.
register_backend_class("nvm-homogeneous", NVMESRHomogeneous)
register_backend_class("nvm-prd", NVMESRPRD)

# Deprecated table view of the pre-redesign registry: iteration and
# membership stay silent (benchmarks sweep the names), construction via
# ``BACKENDS[name](...)`` warns and routes through the class.
BACKENDS = DeprecatedBackendTable({
    "esr": InMemoryESR,
    "nvm-homogeneous": NVMESRHomogeneous,
    "nvm-prd": NVMESRPRD,
})
