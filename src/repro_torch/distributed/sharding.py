"""Logical shard layouts (port of ``repro/distributed/sharding.py:145-188``).

The paper's failure unit is a *node*: one shard owning a contiguous run
of partition blocks.  A :class:`ShardLayout` is that mapping, and it is
all a solve needs to resolve ``FailureEvent(shard=...)`` into block sets
and to label per-shard persist and fetch bytes — the multi-tenant
service declares one per tenant (``nshards=``) without placing anything
on devices.  The reference's logical-axis rules (``AxisRules``,
``shard``) belong to the NN stack and its mesh classes
(``ShardedOperator``, ``shard_problem``, ``place_state``) to sharded
solves across cards; neither is ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


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
