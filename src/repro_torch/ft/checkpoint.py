"""NVM-tier training checkpoints with the paper's persistence protocol
(port of ``repro/ft/checkpoint.py``).

Carries the NVM-ESR design into NN training:

- **minimal-state identification**: only (params, optimizer moments, step,
  data cursor) persist; activations are *reconstructed* by
  recomputation — the training analogue of ESR's solve-don't-store.
- **double-buffered alternating slots** (Dorożyński et al. [4]): two slot
  directories written alternately; a manifest (step + per-file CRC32) is
  committed *after* the payload is durable, so one valid checkpoint always
  survives a crash mid-persist.
- **PSCW-style overlap**: ``save_async`` copies the state from the card
  to the host (the access epoch), returns, and a drainer thread plays
  the PRD target (exposure epoch) writing the files — training overlaps
  the NVM drain as the solver's compute overlaps the PRD flush.
- **elastic restore**: arrays are restored host-side and, with
  ``device``, placed on the current device (the one-card form of the
  reference's ``shardings``).

A slot is the reference's, file for file: a tree flattens as JAX
flattens it (sorted dict keys, ``str(index)`` for a list or tuple entry,
``"/"`` joins; ``"__"`` in file names), every leaf is a C-ordered
``.npy`` with its CRC32 in ``MANIFEST.json``, so equal trees give
byte-identical slot directories and either package restores the other's
slots.  Tensors are written as numpy arrays (bfloat16 as its float32
values).  Tier cost accounting uses the solver backends' calibrated
models (:data:`repro_torch.nvm.store.TIER_SPECS`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.nvm.store import TIER_SPECS, CostModel, Tier


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    tier: Tier = Tier.NVM
    async_drain: bool = True
    keep_fsync: bool = False  # real fsync per file (slow on CI; modeled anyway)


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in JAX's flatten order (``None`` holds no
    leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _rebuild(like: Any, values: Iterator[Any]) -> Any:
    """``like``'s structure holding ``values`` in :func:`_leaves` order."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    return None if like is None else next(values)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy, never a view of a CPU tensor: the drain writes it while
        # the next step updates the state in place
        t = leaf.detach().to("cpu", copy=True)
        leaf = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(leaf)
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _place(arr: np.ndarray, like: Any, device: torch.device) -> torch.Tensor:
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(arr).to(device=device, dtype=dtype)


class NVMCheckpointManager:
    """Double-buffered, asynchronous, tier-modeled checkpoint manager."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.spec = TIER_SPECS[cfg.tier]
        self.cost = CostModel()
        os.makedirs(cfg.directory, exist_ok=True)
        self._seq = self._latest_valid()[0] or 0
        self._drainer: Optional[threading.Thread] = None
        self._last_persist_wall = 0.0
        self._last_persist_model = 0.0
        self._last_persist_bytes = 0

    # ------------------------------------------------------------------
    def _slot_dir(self, seq: int) -> str:
        return os.path.join(self.cfg.directory, f"slot{seq % 2}")

    def _manifest_path(self, slot: str) -> str:
        return os.path.join(slot, "MANIFEST.json")

    # ------------------------------------------------------------------
    def save(self, tree: Any, step: int,
             extra: Optional[Dict[str, Any]] = None) -> float:
        """Synchronous persist; returns modeled seconds.  ``tree`` is a
        tree of tensors and arrays, or a function that returns one (so a
        caller converts its state only when it persists).  A drain still
        in flight finishes first: both would write the next slot."""
        self.join()
        host = self._snapshot(tree)
        return self._drain(host, step, extra or {})

    def save_async(self, tree: Any, step: int,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Access epoch: copy ``tree`` to the host and return; the drain
        overlaps."""
        self.join()
        host = self._snapshot(tree)  # device -> host pull (origin-side cost)

        def _run():
            self._drain(host, step, extra or {})

        if self.cfg.async_drain:
            self._drainer = threading.Thread(target=_run, name="ckpt-drainer")
            self._drainer.start()
        else:
            _run()

    def join(self) -> None:
        if self._drainer is not None:
            self._drainer.join()
            self._drainer = None

    # ------------------------------------------------------------------
    def _snapshot(self, tree: Any) -> Dict[str, np.ndarray]:
        return _flatten(tree() if callable(tree) else tree)

    def _drain(self, flat: Dict[str, np.ndarray], step: int,
               extra: Dict[str, Any]) -> float:
        t0 = time.monotonic()
        seq = self._seq + 1
        slot = self._slot_dir(seq)
        shutil.rmtree(slot, ignore_errors=True)
        os.makedirs(slot, exist_ok=True)
        modeled = 0.0
        entries = {}
        total_bytes = 0
        for key, arr in flat.items():
            fn = key.replace("/", "__") + ".npy"
            path = os.path.join(slot, fn)
            data = arr.tobytes()
            with open(path, "wb") as f:
                np.save(f, arr)
                if self.cfg.keep_fsync:
                    f.flush()
                    os.fsync(f.fileno())
            entries[key] = {"file": fn, "crc": zlib.crc32(data) & 0xFFFFFFFF,
                            "shape": list(arr.shape), "dtype": str(arr.dtype)}
            modeled += self.spec.write_cost(len(data))
            total_bytes += len(data)
        modeled += self.spec.flush_cost(total_bytes)
        # manifest commit AFTER payload is durable (crash-consistent ordering)
        manifest = {"seq": seq, "step": int(step), "entries": entries,
                    "extra": extra}
        mp = self._manifest_path(slot)
        with open(mp + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mp + ".tmp", mp)
        self._seq = seq
        self.cost.add("persist", modeled)
        self._last_persist_wall = time.monotonic() - t0
        self._last_persist_model = modeled
        self._last_persist_bytes = total_bytes
        return modeled

    # ------------------------------------------------------------------
    def _read_manifest(self, slot: str) -> Optional[Dict[str, Any]]:
        mp = self._manifest_path(slot)
        if not os.path.exists(mp):
            return None
        try:
            with open(mp) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None

    def _latest_valid(self) -> Tuple[Optional[int], Optional[str]]:
        best_seq, best_slot = None, None
        for i in (0, 1):
            slot = os.path.join(self.cfg.directory, f"slot{i}")
            m = self._read_manifest(slot)
            if m is None:
                continue
            ok = all(
                os.path.exists(os.path.join(slot, e["file"]))
                for e in m["entries"].values()
            )
            if ok and (best_seq is None or m["seq"] > best_seq):
                best_seq, best_slot = m["seq"], slot
        return best_seq, best_slot

    def _try_load_slot(self, slot: str, flat_keys: List[str]
                       ) -> Optional[Tuple[Dict, Dict]]:
        m = self._read_manifest(slot)
        if m is None:
            return None
        restored = {}
        for key in flat_keys:
            e = m["entries"].get(key)
            if e is None:
                return None  # structure mismatch
            try:
                arr = np.load(os.path.join(slot, e["file"]))
            except (ValueError, OSError):
                return None  # torn/corrupt file (even the npy header)
            if (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != e["crc"]:
                return None  # torn payload detected by checksum
            restored[key] = arr
        return restored, m

    def restore(self, like: Any,
                device: Optional[Union[str, torch.device]] = None
                ) -> Optional[Tuple[Any, int, Dict[str, Any]]]:
        """Restore the newest FULLY-VALID checkpoint into the structure of
        ``like`` (a tree of tensors or arrays, only its structure is
        read).  Slots are tried newest-first; any torn/corrupt payload
        (CRC or even a mangled npy header) makes the whole slot invalid
        and the previous slot wins — the double-buffer guarantee.  The
        leaves come back as numpy arrays or, with ``device``, as tensors
        placed there (in the dtype of a tensor leaf of ``like``):
        elastic restore onto the current device."""
        dev = None if device is None else resolve_device(device)
        self.join()
        like_leaves = list(_leaves(like))
        flat_keys = [key for key, _ in like_leaves]
        candidates = []
        for i in (0, 1):
            slot = os.path.join(self.cfg.directory, f"slot{i}")
            m = self._read_manifest(slot)
            if m is not None:
                candidates.append((m["seq"], slot))
        for _, slot in sorted(candidates, reverse=True):
            got = self._try_load_slot(slot, flat_keys)
            if got is None:
                continue
            restored, m = got
            values = [restored[k] for k in flat_keys]
            if dev is not None:
                values = [_place(v, leaf, dev)
                          for v, (_, leaf) in zip(values, like_leaves)]
            return _rebuild(like, iter(values)), m["step"], m.get("extra", {})
        return None

    # ------------------------------------------------------------------
    @property
    def last_persist_seconds(self) -> Tuple[float, float]:
        """(wall, modeled) duration of the last drain."""
        return self._last_persist_wall, self._last_persist_model

    @property
    def last_persist_bytes(self) -> int:
        """Payload bytes of the last drain."""
        return self._last_persist_bytes
