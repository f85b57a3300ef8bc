"""Persistent-recovery-data (PRD) sub-cluster node (paper §3, Fig. 1c).

A PRD node owns an NVRAM store exposed to all compute ranks through an MPI
one-sided window (over simulated RDMA).  Recovery data is persisted with
the **PSCW** protocol exactly as in the paper's Fig. 4:

  target:  post(group) ............................ wait_persist()
  origin:  start() -> put_pmem(payload, header) -> complete() -> [compute!]

``complete()`` returns before the target finishes persisting, so compute
ranks overlap the next solver iterations with the PRD flush — the paper's
central latency optimization.  The drain runs on a worker thread here to
preserve that overlap in simulation.

Slot layout per rank (double-buffered, crash consistent)::

    rank_base = rank * 2 * (HEADER_SIZE + capacity)
    slot(seq) = rank_base + (seq % 2) * (HEADER_SIZE + capacity)

Cost model: the PRD NIC serializes incoming puts (one IB FDR link), so the
modeled epoch time grows linearly with total put bytes — reproducing the
Fig. 10 trend of overhead vs. process count.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.nvm.pmdk import HEADER_SIZE, _HEADER, slot_crc
from repro_torch.nvm.store import CostModel, Store, Tier, checksum
from repro_torch.nvm.windows import Window


class PRDNode:
    """One PRD storage node serving ``nranks`` compute ranks."""

    def __init__(
        self,
        nranks: int,
        capacity_per_rank: int,
        tier: Tier = Tier.NVM,
        network: str = "rdma",
        path: Optional[str] = None,
        cost_model: Optional[CostModel] = None,
        async_drain: bool = True,
    ):
        self.nranks = nranks
        self.capacity = int(capacity_per_rank)
        self._slot = HEADER_SIZE + self.capacity
        size = nranks * 2 * self._slot
        self.store = Store(size, tier=tier, path=path, cost_model=cost_model)
        self.window = Window(self.store, network=network, name="prd")
        self.async_drain = async_drain
        self._drainer: Optional[threading.Thread] = None
        self._drain_cost = 0.0

    # ------------------------------------------------------------------
    def _slot_offset(self, rank: int, seq: int) -> int:
        return rank * 2 * self._slot + (seq % 2) * self._slot

    # ---------------------- persistence iteration ----------------------
    def join(self) -> float:
        """Block until the previous exposure epoch finished persisting.

        The epoch's target-side cost is consumed on read: a second join
        with no epoch in between returns 0, so callers accumulating drain
        cost (driver recovery barriers) never double-count."""
        if self._drainer is not None:
            self._drainer.join()
            self._drainer = None
        cost, self._drain_cost = self._drain_cost, 0.0
        return cost

    def begin_epoch(self, group=None) -> None:
        """Target side: open the exposure epoch for ``group`` (default all)."""
        self.join()
        self.window.post(range(self.nranks) if group is None else group)

    def put_rank(self, rank: int, payload: bytes, seq: int,
                 slot: Optional[int] = None) -> float:
        """Origin side: start -> put payload+header -> complete.

        ``slot`` overrides the parity choice (callers doing *periodic*
        persistence pick slots by event count, not by seq — seq gaps would
        otherwise overwrite a slot that is still the recovery point).
        Returns the modeled origin-visible cost; the origin is free to
        compute immediately after this returns.
        """
        if isinstance(payload, np.ndarray):
            payload = np.ascontiguousarray(payload).tobytes()
        if len(payload) > self.capacity:
            raise ValueError(f"payload {len(payload)}B > slot capacity {self.capacity}B")
        off = self._slot_offset(rank, seq if slot is None else slot)
        header = _HEADER.pack(seq, len(payload), slot_crc(payload, seq), 0)
        self.window.start(rank)
        cost = self.window.put(rank, off + HEADER_SIZE, payload)
        cost += self.window.put(rank, off, header)
        self.window.complete(rank)
        return cost

    def end_epoch(self) -> float:
        """Target side: wait_persist.  Async when ``async_drain`` is set."""
        if not self.async_drain:
            self._drain_cost = self.window.wait(persist=True)
            return self._drain_cost

        def _drain() -> None:
            self._drain_cost = self.window.wait(persist=True)

        self._drainer = threading.Thread(target=_drain, name="prd-drainer")
        self._drainer.start()
        return 0.0

    def persist_all(self, payloads: List[bytes], seq: int) -> Dict[str, float]:
        """One full persistence iteration for every rank (paper Fig. 4).

        Returns modeled costs: ``origin`` is what compute ranks observe
        (NIC-serialized puts), ``target`` is the PRD-side flush that
        overlaps subsequent compute.
        """
        if len(payloads) != self.nranks:
            raise ValueError("one payload per rank required")
        self.begin_epoch()
        origin = 0.0
        for rank, payload in enumerate(payloads):
            origin += self.put_rank(rank, payload, seq)
        self.end_epoch()
        return {"origin": origin, "target": self._drain_cost}

    # ----------------------------- recovery -----------------------------
    def read_latest(
        self,
        rank: int,
        reader_rank: Optional[int] = None,
        want_seq: Optional[int] = None,
    ) -> Optional[Tuple[int, bytes]]:
        """Passive-target read of a valid slot of ``rank``.

        Returns the newest valid slot, or — when ``want_seq`` is given —
        only a slot carrying exactly that sequence number.  Any
        surviving/spare rank may call this: the PRD store remains
        accessible after arbitrary compute-node failures (paper §3 model).
        """
        self.join()
        reader = self.nranks if reader_rank is None else reader_rank
        self.window.lock(reader)
        best: Optional[Tuple[int, bytes]] = None
        try:
            for parity in (0, 1):
                off = rank * 2 * self._slot + parity * self._slot
                raw, _ = self.window.get(reader, off, HEADER_SIZE)
                seq, size, crc, _pad = _HEADER.unpack(raw)
                if seq == 0 or size > self.capacity:
                    continue
                if want_seq is not None and seq != want_seq:
                    continue
                payload, _ = self.window.get(reader, off + HEADER_SIZE, size)
                if slot_crc(payload, seq) != crc:
                    continue
                if best is None or seq > best[0]:
                    best = (seq, payload)
        finally:
            self.window.unlock(reader, persist=False)
        return best

    def scan_rank(self, rank: int,
                  reader_rank: Optional[int] = None) -> List[Tuple[int, bytes]]:
        """All valid slots of ``rank`` (both parities), newest first.

        Backend ``durable_run`` scans use this: unlike
        :meth:`read_latest` it returns every CRC-valid slot, so the
        caller can check run completeness across the whole ring."""
        self.join()
        reader = self.nranks if reader_rank is None else reader_rank
        self.window.lock(reader)
        found: List[Tuple[int, bytes]] = []
        try:
            for parity in (0, 1):
                off = rank * 2 * self._slot + parity * self._slot
                raw, _ = self.window.get(reader, off, HEADER_SIZE)
                seq, size, crc, _pad = _HEADER.unpack(raw)
                if seq == 0 or size > self.capacity:
                    continue
                payload, _ = self.window.get(reader, off + HEADER_SIZE, size)
                if slot_crc(payload, seq) != crc:
                    continue
                found.append((seq, payload))
        finally:
            self.window.unlock(reader, persist=False)
        return sorted(found, key=lambda sp: -sp[0])

    def crash(self) -> None:
        """PRD node power-fail; unflushed epochs are lost.  A single
        PRD node is a single point of failure — the paper scopes the
        RAID fix out; this repo composes it back in at the backend
        layer: ``replicated(nvm-prd xN)`` mirrors whole nodes,
        ``erasure(nvm-prd xK+p)`` stripes them with XOR parity
        (DESIGN.md §7/§8)."""
        if self._drainer is not None:
            # the drainer dies with the node; whatever was not flushed is gone
            self._drainer = None
        self.store.crash()
