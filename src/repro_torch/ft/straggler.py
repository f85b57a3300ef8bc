"""Straggler detection and mitigation for the training runtime (a copy
of ``repro/ft/straggler.py``, pure Python).

At pod scale, slow hosts (thermal throttling, failing NICs, noisy
neighbours on the storage tier) stretch every synchronous step.  The
monitor keeps a robust running estimate of step time (median + MAD over a
sliding window) and classifies each observation:

- **transient** spike (> ``spike_mad`` MADs once): logged, no action;
- **persistent** straggle (``persist_k`` consecutive spikes): mitigation
  hooks fire —
    * persistence drains are deferred (the NVM checkpoint drain is taken
      off the critical path until the step time recovers), and
    * the runtime is advised to *evict + elastically restore* (shrink the
      mesh by the slow host and continue from the NVM checkpoint — the
      same elastic-restore path as failure recovery, DESIGN.md §2).

The monitor is deliberately runtime-agnostic: it consumes durations and
emits advice; launch/train.py and the recovery wrapper act on it.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class StragglerAdvice:
    classification: str          # "normal" | "transient" | "persistent"
    defer_persistence: bool
    suggest_eviction: bool
    step_time_s: float
    median_s: float


class StragglerMonitor:
    def __init__(self, window: int = 50, spike_mad: float = 5.0,
                 persist_k: int = 5, warmup: int = 5):
        self.window = window
        self.spike_mad = spike_mad
        self.persist_k = persist_k
        self.warmup = warmup
        self._times: Deque[float] = deque(maxlen=window)
        self._consecutive = 0
        self.history: List[StragglerAdvice] = []

    def observe(self, step_time_s: float) -> StragglerAdvice:
        if len(self._times) < self.warmup:
            self._times.append(step_time_s)
            adv = StragglerAdvice("normal", False, False, step_time_s, step_time_s)
            self.history.append(adv)
            return adv
        med = statistics.median(self._times)
        mad = statistics.median(abs(t - med) for t in self._times) or med * 0.01
        is_spike = step_time_s > med + self.spike_mad * mad
        if is_spike:
            self._consecutive += 1
        else:
            self._consecutive = 0
            self._times.append(step_time_s)  # don't poison the baseline
        if self._consecutive >= self.persist_k:
            cls = "persistent"
        elif is_spike:
            cls = "transient"
        else:
            cls = "normal"
        adv = StragglerAdvice(
            classification=cls,
            defer_persistence=is_spike,
            suggest_eviction=cls == "persistent",
            step_time_s=step_time_s,
            median_s=med,
        )
        self.history.append(adv)
        return adv

    @property
    def median_step_s(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None
