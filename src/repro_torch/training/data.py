"""Data pipeline: deterministic, host-sharded, resumable (port of
``repro/training/data.py``: the corpora are numpy, copied, so a step's
batch is bitwise the reference's).

Resumability is a single integer cursor (the step), stored inside the
NVM checkpoint's minimal state — the data-pipeline analogue of the
paper's "reconstruct, don't persist" principle: batches are re-derivable
functions of (seed, step), so nothing else needs saving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic synthetic LM batches (zipf-ish token distribution)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        b = self.batch // self.host_count
        z = rng.zipf(1.3, size=(b, self.seq + 1)).astype(np.int64)
        toks = (z % (self.vocab - 1)) + 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class MemmapCorpus:
    """Token-file corpus (np.memmap), strided per host, resumable by step."""

    path: str
    vocab: int
    batch: int
    seq: int
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._ntok = self._data.shape[0]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b = self.batch // self.host_count
        span = self.seq + 1
        out = np.empty((b, span), np.int32)
        for i in range(b):
            # deterministic stride walk; hosts interleave rows
            row = step * self.batch + self.host_index * b + i
            start = (row * span) % max(self._ntok - span, 1)
            out[i] = self._data[start : start + span]
        return {"tokens": out[:, :-1].copy(), "targets": out[:, 1:].copy()}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)


def to_tensors(batch: Dict[str, np.ndarray],
               device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: token ids and targets as
    int64 (the index type), floating arrays as they are."""
    return {k: torch.as_tensor(v).to(device=device,
                                     dtype=torch.int64 if v.dtype.kind in "iu"
                                     else None)
            for k, v in batch.items()}
