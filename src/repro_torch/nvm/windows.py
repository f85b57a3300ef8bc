"""MPI one-sided-communication (OSC) windows with persistence extensions.

Implements the epoch discipline of MPI-3 RMA (paper §4.1) over a simulated
NVM/DRAM store, including the ``*_persist`` extensions of Dorożyński et
al. [4, 5]:

- **fence**  — collective active-target sync; ``fence_persist`` flushes the
  window to NVM before the epoch closes.
- **PSCW**   — generalized active-target sync (Post-Start-Complete-Wait).
  Origins ``start``/``complete`` an *access epoch*; the target
  ``post``/``wait``s an *exposure epoch*.  ``wait_persist`` drains and
  flushes.  The key NVM-ESR optimization: origins exit their access epoch
  (``complete``) and continue computing while the target is still
  persisting inside its exposure epoch.
- **passive target** — ``lock``/``unlock`` (+ ``unlock_persist``).

Epoch misuse raises :class:`EpochError`, mirroring MPI's erroneous-program
semantics; tests assert the discipline.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.nvm.store import NETWORK_SPECS, NetworkSpec, Store


class EpochError(RuntimeError):
    """RMA call outside the required epoch (erroneous MPI program)."""


class Window:
    """One window: a region of a target store exposed to origin ranks.

    A single ``Window`` object plays the whole communicator's view: rank-
    indexed epoch state is tracked per origin, and the target side is the
    store owner.  ``disp_unit`` follows MPI (byte displacements here).
    """

    def __init__(
        self,
        store: Store,
        size: Optional[int] = None,
        base: int = 0,
        network: str = "rdma",
        name: str = "win",
    ):
        self.store = store
        self.base = base
        self.size = store.size - base if size is None else size
        self.net: NetworkSpec = NETWORK_SPECS[network]
        self.name = name
        self._lock = threading.RLock()
        # target-side epoch state
        self._exposed_to: Optional[Set[int]] = None
        self._completed: Set[int] = set()
        # origin-side epoch state
        self._access: Set[int] = set()
        # passive target
        self._locked_by: Optional[int] = None
        # pending (unflushed) put bytes for cost accounting
        self._pending_bytes = 0

    # ----------------------------- PSCW: target -----------------------------
    def post(self, group: Iterable[int]) -> None:
        """MPI_Win_post: open an exposure epoch for ``group`` origins."""
        with self._lock:
            if self._exposed_to is not None:
                raise EpochError("post inside an open exposure epoch")
            self._exposed_to = set(group)
            self._completed = set()

    def wait(self, persist: bool = True) -> float:
        """MPI_Win_wait / MPI_Win_Wait_persist: close the exposure epoch.

        Blocks (logically) until every origin in the posted group has
        completed; with ``persist`` the window range is flushed to the
        backing tier before returning, guaranteeing recovery data reached
        NVM (paper Fig. 4).
        """
        with self._lock:
            if self._exposed_to is None:
                raise EpochError("wait without a posted exposure epoch")
            missing = self._exposed_to - self._completed
            if missing:
                raise EpochError(f"wait before origins {sorted(missing)} completed")
            self._exposed_to = None
            self._completed = set()
            cost = self.store.flush() if persist else 0.0
            self._pending_bytes = 0
            return cost

    def test(self) -> bool:
        """MPI_Win_test: non-blocking wait probe."""
        with self._lock:
            if self._exposed_to is None:
                raise EpochError("test without a posted exposure epoch")
            return not (self._exposed_to - self._completed)

    # ----------------------------- PSCW: origin -----------------------------
    def start(self, rank: int) -> None:
        """MPI_Win_start: open this origin's access epoch."""
        with self._lock:
            if rank in self._access:
                raise EpochError(f"rank {rank}: start inside an open access epoch")
            self._access.add(rank)

    def complete(self, rank: int) -> None:
        """MPI_Win_complete: origin exits; target may still be persisting."""
        with self._lock:
            if rank not in self._access:
                raise EpochError(f"rank {rank}: complete without start")
            self._access.discard(rank)
            self._completed.add(rank)

    # ----------------------------- RMA ops -----------------------------
    def _check_rma(self, rank: int) -> None:
        if self._locked_by == rank:
            return  # passive-target epoch
        if rank not in self._access:
            raise EpochError(f"rank {rank}: RMA op outside any epoch")
        if self._exposed_to is not None and rank not in self._exposed_to:
            raise EpochError(f"rank {rank}: not in the posted group")

    def put(self, rank: int, offset: int, data: bytes) -> float:
        """MPI_Win_Put_pmem: one-sided write into the window."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).tobytes()
        with self._lock:
            self._check_rma(rank)
            cost = self.net.transfer_cost(len(data))
            cost += self.store.write(self.base + offset, data)
            self._pending_bytes += len(data)
            self.store.cost.add("network", self.net.transfer_cost(len(data)))
            return cost

    def get(self, rank: int, offset: int, nbytes: int) -> Tuple[bytes, float]:
        """MPI_Win_Get_pmem: one-sided read from the window."""
        with self._lock:
            self._check_rma(rank)
            data, cost = self.store.read(self.base + offset, nbytes)
            cost += self.net.transfer_cost(nbytes)
            self.store.cost.add("network", self.net.transfer_cost(nbytes))
            return data, cost

    # ----------------------------- fence -----------------------------
    def fence(self, persist: bool = False) -> float:
        """MPI_Win_fence / MPI_Win_Fence_persist (collective sync)."""
        with self._lock:
            self._access.clear()
            self._completed = set(self._exposed_to) if self._exposed_to else set()
            cost = self.store.flush() if persist else 0.0
            if self._exposed_to is not None:
                self._exposed_to = None
            self._pending_bytes = 0
            return cost

    # ----------------------------- passive target -----------------------------
    def lock(self, rank: int) -> None:
        with self._lock:
            if self._locked_by is not None:
                raise EpochError(f"window already locked by {self._locked_by}")
            self._locked_by = rank

    def unlock(self, rank: int, persist: bool = True) -> float:
        with self._lock:
            if self._locked_by != rank:
                raise EpochError(f"unlock by {rank} but locked by {self._locked_by}")
            self._locked_by = None
            return self.store.flush() if persist else 0.0
