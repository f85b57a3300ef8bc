"""In-memory ESR (the paper's baseline; Chen '11 / Pachajoa et al.);
port of ``repro/core/esr.py`` (numpy only).

Redundancy of the recovery set is piggybacked on the SpMV transition
(ASpMV, Algorithm 2) and replicated into the **volatile RAM of peer
processes**.  To tolerate ``c`` simultaneous failures, ``c+1`` copies are
placed; full fault tolerance places a copy at every process —
``O(n * proc)`` values of RAM and an all-to-all every persistence
iteration (paper §2 and §3.1).

Since the solver-zoo generalization the payload is schema-driven
(:class:`repro_torch.core.state.RecoverySchema`): any solver's named
multi-vector/multi-scalar recovery set replicates through the same copy
placement; slot sizes and the wire format derive from the schema.

Copy placement: copy ``i`` of block ``b`` lives in the RAM of rank
``(b + i + 1) mod nblocks``.  A failure of block set ``F`` wipes every
copy hosted on ranks in ``F``; recovery succeeds iff each failed block
still has a surviving copy — which the placement guarantees whenever
``copies > |F|``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

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
from repro_torch.nvm.backend import (  # noqa: F401  (UnrecoverableFailure re-exported)
    OVERLAP_NATIVE,
    BackendCapabilities,
    SchemaDrivenBackend,
    UnrecoverableFailure,
    register_backend_class,
    warn_legacy_call,
)
from repro_torch.nvm.store import (
    NETWORK_SPECS,
    TIER_SPECS,
    CostModel,
    PersistStager,
    Tier,
)


class InMemoryESR(SchemaDrivenBackend):
    """Peer-RAM redundancy backend with explicit copy placement."""

    name = "esr-inmemory"

    def __init__(self, nblocks: int, block_size: int, dtype,
                 copies: Optional[int] = None, slots: Optional[int] = None,
                 schema: RecoverySchema = PCG_SCHEMA):
        self.nblocks = nblocks
        self.block_size = block_size
        self.dtype = np.dtype(dtype)
        self.schema = schema
        # full fault tolerance by default: a copy at every other process
        self.copies = nblocks - 1 if copies is None else copies
        if not (1 <= self.copies <= nblocks - 1):
            raise ValueError(f"copies must be in [1, nblocks-1], got {self.copies}")
        # Ring size 2h-1 (h = history) is the provable minimum that keeps
        # the previous recovery run intact through an in-flight ESRP
        # burst: with event-addressed slots mod (2h-1), burst writes
        # 1..h-1 can never land on the old run's h slots (j - i + h is in
        # [1, 2h-2], never 0 mod 2h-1); only the h-th write may, and at
        # that moment the NEW run is complete.  Floor of 2 keeps a
        # staging slot for single-state schemas (peer-RAM stores are not
        # atomic in reality).  h=2 gives the paper's 3-slot layout.
        self.slots = max(2, 2 * schema.history - 1) if slots is None else slots
        # ram[host_rank][(owner_block, slot)] -> payload bytes
        self.ram: List[Dict[Tuple[int, int], bytes]] = [dict() for _ in range(nblocks)]
        self._event = 0  # event-addressed slots (ESRP persists with gaps)
        self.cost = CostModel()
        self._dram = TIER_SPECS[Tier.DRAM]
        self._net = NETWORK_SPECS["rdma"]
        self._stager = PersistStager(self.persist_set, cost_model=self.cost)

    # ------------------------------------------------------------------
    @property
    def capabilities(self) -> BackendCapabilities:
        """Peer RAM is volatile and dies with its hosts: data survives
        node loss only while ``|failures| <= copies`` (the failed block
        occupies one slot of the failed set, so at most ``copies - 1``
        of its ``copies`` peer hosts can be among the casualties)."""
        return BackendCapabilities(
            durability="ram",
            survives_node_loss=True,
            survives_prd_loss=False,
            overlap=OVERLAP_NATIVE,
            max_block_failures=self.copies,
        )

    # ------------------------------------------------------------------
    def _hosts(self, block: int) -> List[int]:
        return [(block + i + 1) % self.nblocks for i in range(self.copies)]

    # -- overlapped persistence (DESIGN.md §6): stage now, replicate later
    def persist_begin(self, k: int, scalars: Mapping[str, float],
                      vectors: Mapping[str, np.ndarray]) -> float:
        """Stage the payload (local DRAM copy); the peer all-to-all happens
        at :meth:`persist_commit` and overlaps the next iteration."""
        return self._stager.begin(k, scalars, vectors)

    def persist_commit(self) -> float:
        """Replicate the oldest staged payload to the peer hosts."""
        return self._stager.commit()

    def persist_drain(self) -> float:
        """Drain barrier: commit everything staged (nothing else is in
        flight — peer-RAM replication is synchronous once committed)."""
        return self._stager.drain()

    def persist_set(self, k: int, scalars: Mapping[str, float],
                    vectors: Mapping[str, np.ndarray]) -> float:
        """One redundancy iteration: every block's slot payload is sent to
        its ``copies`` peer hosts (modeled as the ASpMV all-to-all surplus)."""
        slot = self._event % self.slots
        self._event += 1
        typed = typed_vectors(self.schema, vectors, self.dtype)
        cost = 0.0
        for b in range(self.nblocks):
            shards = shard_vectors(self.schema, typed, b, self.block_size)
            payload = self.schema.encode(k, scalars, shards)
            for host in self._hosts(b):
                self.ram[host][(b, slot)] = payload
                # network transfer + peer DRAM write (per copy)
                cost += self._net.transfer_cost(len(payload))
                cost += self._dram.write_cost(len(payload))
        self.cost.add("persist", cost)
        return cost

    def persist(self, k: int, beta: float, p_full: np.ndarray) -> float:
        """Legacy PCG-shaped persist (pre-zoo API; deprecated)."""
        warn_legacy_call(self, "persist")
        require_pcg_schema(self.schema, "persist")
        return self.persist_set(k, {"beta": beta}, {"p": p_full})

    # ------------------------------------------------------------------
    def fail(self, failed_blocks: Sequence[int]) -> None:
        """Process crash: the peer-RAM copies hosted on failed ranks die
        too, and any staged-but-uncommitted persist is torn away (the
        failed ranks' contributions to the all-to-all never happened)."""
        self._stager.abort()
        for b in failed_blocks:
            self.ram[b] = {}

    def _find_block_set(self, block: int, kk: int,
                        failed_blocks: Sequence[int]) -> RecoverySet:
        for host in self._hosts(block):
            if host in failed_blocks:
                continue
            # content-matched scan over the host's slots (header peek
            # first: only the matching slot's vectors are decoded)
            for sl in range(self.slots):
                cand = self.ram[host].get((block, sl))
                if cand is None or peek_k(cand) != kk:
                    continue
                self.cost.add("recover", self._net.transfer_cost(len(cand)))
                return self.schema.decode(cand, self.dtype)
        raise UnrecoverableFailure(
            f"block {block}: no surviving copy of iteration {kk} — "
            f"{len(failed_blocks)} failures exceed tolerance c={self.copies} "
            f"(capabilities.max_block_failures)"
        )

    def recover_set(self, failed_blocks: Sequence[int],
                    ks: Sequence[int]) -> List[RecoverySet]:
        """Fetch the recovery sets for iterations ``ks`` over the failed
        union from surviving peer RAM (vectors concatenated in
        ``failed_blocks`` order)."""
        out = []
        for kk in ks:
            per_block = [self._find_block_set(b, kk, failed_blocks)
                         for b in failed_blocks]
            out.append(concat_sets(self.schema, per_block))
        return out

    def recover(self, failed_blocks: Sequence[int],
                k: int) -> Tuple[RecoveryPayload, RecoveryPayload]:
        """Legacy PCG-shaped recover (pre-zoo API; deprecated): the
        (k-1, k) pair."""
        warn_legacy_call(self, "recover")
        require_pcg_schema(self.schema, "recover")
        return legacy_pair(self.recover_set(failed_blocks, (k - 1, k)))

    def durable_run(self) -> Optional[int]:
        """Newest iteration ending a complete ``history``-run still held
        by block 0's surviving peer copies (peer-RAM writes are durable
        the moment they land — there is no flush pipeline)."""
        ks = set()
        for host in self._hosts(0):
            for (owner, _slot), payload in self.ram[host].items():
                if owner == 0:
                    ks.add(peek_k(payload))
        return newest_complete_run(ks, self.schema.history)

    # ------------------------------------------------------------------
    def memory_overhead_values(self) -> int:
        """Redundancy values resident in system RAM.  Paper §3.1 models
        ~history*copies*n (the live slots); steady state here is
        slots*copies*n — the extra n*copies is the ESRP mid-burst staging
        slot."""
        return sum(len(v) for host in self.ram for v in host.values()) // self.dtype.itemsize

    def nvm_values(self) -> int:
        return 0


# The peer-RAM baseline in the backend registry
# (:mod:`repro_torch.nvm.backend`), beside the NVM architectures of
# :mod:`repro_torch.core.nvm_esr`.
register_backend_class("esr", InMemoryESR)
