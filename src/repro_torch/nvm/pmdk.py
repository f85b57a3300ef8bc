"""``libpmemobj``-like persistent object pools over a simulated NVM store.

Mirrors the PMDK usage in the paper (§4.2): each process calls
``pmemobj_create`` once, then ``pmemobj_persist`` at every persistence
iteration.  Crash consistency for whole-object updates is provided by
**double-buffered alternating slots** (Dorożyński et al. [4]): an object is
written to the inactive slot, flushed, and only then is the slot header
(sequence number + CRC32) committed — so one valid copy always survives a
crash that interrupts persistence.

Layout of a named object with two slots::

    [slot0: header | payload][slot1: header | payload]
    header := seq:u64 | size:u64 | crc32:u32 | pad:u32   (24 bytes)
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.nvm.store import Store, checksum

_HEADER = struct.Struct("<QQII")  # seq, size, crc32, pad
HEADER_SIZE = _HEADER.size
_META = struct.Struct("<QQ")


def slot_crc(payload: bytes, seq: int) -> int:
    """CRC binding payload AND header fields (seq, size): a torn write
    cannot forge a header that self-validates (e.g. seq=1/size=0/crc=0
    would match crc32(b'') if the CRC covered only the payload)."""
    return checksum(payload + _META.pack(seq, len(payload)))


class PmemPool:
    """A persistent memory pool holding named, double-buffered objects."""

    def __init__(self, store: Store, layout: str = "nvm-esr"):
        self.store = store
        self.layout = layout
        self._objects: Dict[str, Tuple[int, int]] = {}  # name -> (offset, capacity)
        self._cursor = 0
        self._seq: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def create(self, name: str, capacity: int) -> None:
        """Reserve space for an object of up to ``capacity`` payload bytes."""
        if name in self._objects:
            raise ValueError(f"object {name!r} already exists")
        slot = HEADER_SIZE + capacity
        need = 2 * slot
        if self._cursor + need > self.store.size:
            raise MemoryError(
                f"pool exhausted: need {need} bytes for {name!r}, "
                f"{self.store.size - self._cursor} free"
            )
        self._objects[name] = (self._cursor, capacity)
        self._seq[name] = 0
        self._cursor += need

    def has(self, name: str) -> bool:
        return name in self._objects

    def _slot_offsets(self, name: str) -> Tuple[int, int, int]:
        base, capacity = self._objects[name]
        slot = HEADER_SIZE + capacity
        return base, base + slot, capacity

    # ------------------------------------------------------------------
    def persist(self, name: str, payload: bytes) -> float:
        """``pmemobj_persist``: durably commit ``payload`` under ``name``.

        Returns the modeled cost (seconds).  Write ordering is the
        crash-safe one: payload -> flush -> header -> flush.
        """
        if isinstance(payload, np.ndarray):
            payload = payload.tobytes()
        off0, off1, capacity = self._slot_offsets(name)
        if len(payload) > capacity:
            raise ValueError(f"payload {len(payload)}B > capacity {capacity}B")
        seq = self._seq[name] + 1
        target = off0 if seq % 2 == 0 else off1
        cost = 0.0
        cost += self.store.write(target + HEADER_SIZE, payload)
        cost += self.store.flush()
        header = _HEADER.pack(seq, len(payload), slot_crc(payload, seq), 0)
        cost += self.store.write(target, header)
        cost += self.store.flush()
        self._seq[name] = seq
        return cost

    def persist_array(self, name: str, arr: np.ndarray) -> float:
        return self.persist(name, np.ascontiguousarray(arr).tobytes())

    # ------------------------------------------------------------------
    def _read_slot(self, off: int, capacity: int) -> Optional[Tuple[int, bytes]]:
        raw, _ = self.store.read(off, HEADER_SIZE)
        seq, size, crc, _pad = _HEADER.unpack(raw)
        if seq == 0 or size > capacity:
            return None
        payload, _ = self.store.read(off + HEADER_SIZE, size)
        if slot_crc(payload, seq) != crc:
            return None  # torn write — slot invalid
        return seq, payload

    def read(self, name: str) -> Optional[bytes]:
        """Return the newest *valid* committed copy (None if never persisted)."""
        off0, off1, capacity = self._slot_offsets(name)
        best: Optional[Tuple[int, bytes]] = None
        for off in (off0, off1):
            got = self._read_slot(off, capacity)
            if got is not None and (best is None or got[0] > best[0]):
                best = got
        return None if best is None else best[1]

    def read_array(self, name: str, dtype, shape) -> Optional[np.ndarray]:
        raw = self.read(name)
        if raw is None:
            return None
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

    # ------------------------------------------------------------------
    def recover(self) -> None:
        """Re-open after a crash: re-derive per-object sequence numbers."""
        for name in self._objects:
            off0, off1, capacity = self._slot_offsets(name)
            seqs = []
            for off in (off0, off1):
                got = self._read_slot(off, capacity)
                if got is not None:
                    seqs.append(got[0])
            self._seq[name] = max(seqs) if seqs else 0
