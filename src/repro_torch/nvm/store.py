"""Tiered byte-addressable stores with calibrated cost models.

Simulation contract
-------------------
*Semantics* are real: ``Store`` is byte-addressable; writes become durable
only at ``flush()`` boundaries; ``crash()`` discards everything that was not
flushed (volatile tiers lose everything).  This is exactly the programming
model of Optane DCPMM in App-Direct mode (CLWB + SFENCE ≙ ``flush``).

*Performance* is modeled: every operation returns a modeled cost in seconds
derived from per-tier latency/bandwidth constants calibrated to the paper's
cluster (Fig. 6: DDR4-2933 DRAM, Optane DCPMM 2666 MT/s "Apache Pass",
SATA-SSD 6 Gb/s, Mellanox IB FDR 56 Gb/s).  Benchmarks report both the
modeled time (used for the Fig. 9/10 reproductions) and the measured wall
time of the simulation itself.
"""
from __future__ import annotations

import enum
import os
import threading
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np


class Tier(enum.Enum):
    DRAM = "dram"
    NVM = "nvm"
    SSD = "ssd"


@dataclass(frozen=True)
class TierSpec:
    """Latency/bandwidth model of one persistence tier (per process)."""

    name: str
    write_latency_s: float
    write_bw_Bps: float
    read_latency_s: float
    read_bw_Bps: float
    flush_latency_s: float
    persistent: bool

    def write_cost(self, nbytes: int) -> float:
        return self.write_latency_s + nbytes / self.write_bw_Bps

    def read_cost(self, nbytes: int) -> float:
        return self.read_latency_s + nbytes / self.read_bw_Bps

    def flush_cost(self, nbytes: int) -> float:
        # Draining write-pending-queues scales with dirty bytes.
        return self.flush_latency_s + nbytes / self.write_bw_Bps


# Calibration constants (see DESIGN.md §2).  Sources: paper Fig. 6 cluster,
# Izraelevitz et al. '19 Optane characterization, vendor SATA-SSD specs.
TIER_SPECS: Dict[Tier, TierSpec] = {
    # DDR4-2933, single-process slice of socket bandwidth.
    Tier.DRAM: TierSpec("dram", 90e-9, 12.0e9, 80e-9, 14.0e9, 0.0, False),
    # 4 interleaved 256GB DCPMMs (2 sockets x 2 channels): ~2.3 GB/s write
    # per DIMM sustained, ~6.8 GB/s read per DIMM.
    Tier.NVM: TierSpec("nvm", 170e-9, 9.2e9, 300e-9, 27.0e9, 600e-9, True),
    # 240GB SATA 6Gb/s SSD; fsync forces block I/O + barrier.
    Tier.SSD: TierSpec("ssd", 60e-6, 0.48e9, 90e-6, 0.52e9, 250e-6, True),
}


@dataclass(frozen=True)
class NetworkSpec:
    """One-sided transport model (origin -> target NIC -> target memory)."""

    name: str
    latency_s: float
    bw_Bps: float

    def transfer_cost(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bw_Bps


NETWORK_SPECS: Dict[str, NetworkSpec] = {
    # IB FDR 4x = 56 Gb/s; RDMA put/get bypasses the remote CPU.
    "rdma": NetworkSpec("rdma", 1.5e-6, 6.8e9),
    # SSH-FS style remote file access (paper's remote-SSD reference).
    "sshfs": NetworkSpec("sshfs", 120e-6, 1.1e9),
    # local loop-back (homogeneous architecture: no network).
    "local": NetworkSpec("local", 0.0, float("inf")),
}


@dataclass
class CostModel:
    """Accumulates modeled seconds per category; thread-safe."""

    seconds: Dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, category: str, cost_s: float) -> float:
        with self._lock:
            self.seconds[category] = self.seconds.get(category, 0.0) + cost_s
        return cost_s

    def total(self) -> float:
        with self._lock:
            return sum(self.seconds.values())

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()


class Store:
    """A byte-addressable region on one tier with crash-faithful durability.

    Writes land in the working image immediately (byte-addressable stores
    are CPU-visible before persistence, like DCPMM behind the cache
    hierarchy).  ``flush(lo, hi)`` makes a range durable.  ``crash()``
    rewinds the working image to the last durable state — unflushed bytes
    are torn away, which is what a power failure does to cache lines that
    never reached the DIMM's write-pending queue.
    """

    def __init__(
        self,
        size: int,
        tier: Tier = Tier.NVM,
        path: Optional[str] = None,
        cost_model: Optional[CostModel] = None,
    ):
        self.size = int(size)
        self.tier = tier
        self.spec = TIER_SPECS[tier]
        self.cost = cost_model if cost_model is not None else CostModel()
        self._working = bytearray(self.size)
        self._durable = bytearray(self.size) if self.spec.persistent else None
        self._dirty_lo: Optional[int] = None
        self._dirty_hi: Optional[int] = None
        self._lock = threading.RLock()
        self._path = path
        if path is not None and self.spec.persistent:
            self._load_backing(path)

    # -- backing file (lets a *new* Store instance play a rebooted node) --
    def _load_backing(self, path: str) -> None:
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read(self.size)
            self._durable[: len(data)] = data
            self._working[: len(data)] = data

    def _sync_backing(self) -> None:
        if self._path is not None and self._durable is not None:
            with open(self._path, "wb") as f:
                f.write(self._durable)
                f.flush()
                os.fsync(f.fileno())

    # ------------------------------- ops -------------------------------
    def write(self, offset: int, data: bytes) -> float:
        """Store bytes into the working image; NOT yet durable."""
        end = offset + len(data)
        if end > self.size:
            raise ValueError(f"write [{offset}:{end}) beyond store size {self.size}")
        with self._lock:
            self._working[offset:end] = data
            self._dirty_lo = offset if self._dirty_lo is None else min(self._dirty_lo, offset)
            self._dirty_hi = end if self._dirty_hi is None else max(self._dirty_hi, end)
        return self.cost.add("write", self.spec.write_cost(len(data)))

    def read(self, offset: int, nbytes: int) -> Tuple[bytes, float]:
        end = offset + nbytes
        if end > self.size:
            raise ValueError(f"read [{offset}:{end}) beyond store size {self.size}")
        with self._lock:
            data = bytes(self._working[offset:end])
        return data, self.cost.add("read", self.spec.read_cost(nbytes))

    def flush(self) -> float:
        """Persist all dirty bytes (CLWB+SFENCE / msync / fsync analogue)."""
        with self._lock:
            if self._dirty_lo is None:
                return self.cost.add("flush", self.spec.flush_cost(0))
            lo, hi = self._dirty_lo, self._dirty_hi
            if self._durable is not None:
                self._durable[lo:hi] = self._working[lo:hi]
            self._dirty_lo = self._dirty_hi = None
        return self.cost.add("flush", self.spec.flush_cost(hi - lo))

    def crash(self, torn_write: Optional[Tuple[int, bytes]] = None) -> None:
        """Power-fail: lose unflushed bytes; volatile tiers lose all.

        ``torn_write`` optionally lands a partial write *after* the rewind,
        modeling a crash that interrupts an in-flight store sequence (used
        by crash-consistency property tests).
        """
        with self._lock:
            if self._durable is None:
                self._working = bytearray(self.size)
            else:
                self._working = bytearray(self._durable)
                if torn_write is not None:
                    off, frag = torn_write
                    self._working[off : off + len(frag)] = frag
                    self._durable[off : off + len(frag)] = frag
            self._dirty_lo = self._dirty_hi = None
            self._sync_backing()

    def durable_snapshot(self) -> bytes:
        with self._lock:
            if self._durable is None:
                return b"\x00" * self.size
            return bytes(self._durable)


def checksum(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class PersistStager:
    """Double-buffered staging area for overlapped persistence.

    Splits a persistence event into the part the solver must wait for and
    the part it can hide behind compute (DESIGN.md §6):

    - ``begin(k, scalars, vectors)`` captures the recovery payload into a
      staging buffer.  The device->host pull already happened in
      ``RecoverableSolver.recovery_set``; what remains on the critical
      path is a local DRAM copy of the slot bytes, whose modeled cost is
      returned.  Nothing is durable yet.
    - ``commit()`` runs the backend's flush function on the *oldest*
      staged payload — the expensive tier/network write — and returns its
      modeled cost.  The driver calls this while the next iteration's
      compute is in flight, so the cost overlaps.
    - ``drain()`` commits everything still staged: the barrier a backend
      must pass before a recovery point may be declared durable.
    - ``abort()`` discards staged payloads.  A failure tears in-flight
      persistence away; backends call this from ``fail()`` so an aborted
      slot write can never be committed later as if it had survived.

    Depth is 2 (double buffering): one payload may be committing while
    the next is being staged — enough for an ESRP burst to stay one event
    ahead.  A third ``begin`` without an intervening ``commit`` is a
    driver bug and raises.
    """

    DEPTH = 2

    def __init__(self, flush_fn: Callable[..., float],
                 cost_model: Optional[CostModel] = None):
        self._flush = flush_fn
        self._staged: deque = deque()
        self.cost = cost_model if cost_model is not None else CostModel()
        self._dram = TIER_SPECS[Tier.DRAM]
        #: a repro_torch.obs tracer (set through PersistSession.set_tracer);
        #: None keeps every stager operation tracer-callable-free
        self.tracer = None

    @property
    def pending(self) -> int:
        """Number of staged-but-uncommitted payloads."""
        return len(self._staged)

    def begin(self, k: int, scalars: Mapping[str, float],
              vectors: Mapping[str, "np.ndarray"]) -> float:
        if len(self._staged) >= self.DEPTH:
            raise RuntimeError(
                f"persist staging depth {self.DEPTH} exceeded: commit or "
                f"drain before staging iteration {k}")
        # A real copy, not a view: the caller may reuse its buffers while
        # the staged payload waits for commit (the cost charged below IS
        # this copy).
        vecs = {name: np.array(v) for name, v in vectors.items()}
        nbytes = 8 + 8 * len(scalars) + sum(v.nbytes for v in vecs.values())
        self._staged.append((int(k), dict(scalars), vecs))
        cost = self.cost.add("stage", self._dram.write_cost(nbytes))
        if self.tracer is not None:
            # The staging copy is the exposed part of an overlapped
            # event; the flush below is the hidden part (DESIGN.md §6).
            self.tracer.event("stage.copy", k=int(k), nbytes=nbytes,
                              cost_s=cost, exposed=True)
        return cost

    def commit(self) -> float:
        if not self._staged:
            return 0.0
        k, scalars, vectors = self._staged.popleft()
        cost = self._flush(k, scalars, vectors)
        if self.tracer is not None:
            self.tracer.event("stage.flush", k=int(k), cost_s=cost,
                              exposed=False)
        return cost

    def drain(self) -> float:
        total = 0.0
        drained = len(self._staged)
        while self._staged:
            total += self.commit()
        if self.tracer is not None and drained:
            self.tracer.event("stage.drain", events=drained, cost_s=total)
        return total

    def abort(self) -> int:
        n = len(self._staged)
        if n and self.tracer is not None:
            # The discard is observable: SolveReport.persist_aborts
            # counts the driver-side event, and this closes the stager
            # leg of the trace triangle — every stage.copy is matched by
            # a stage.flush or accounted for by a stage.abort (the
            # conservation law check_trace_report verifies).
            self.tracer.event("stage.abort", count=n,
                              ks=tuple(int(k) for k, _, _ in self._staged))
        self._staged.clear()
        return n
