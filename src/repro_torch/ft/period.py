"""Persistence-period selection (the ESRP trade-off, paper §2; a copy of
``repro/ft/period.py``, pure Python).

ESRP showed: longer periods cut persistence overhead but waste more
iterations on recovery.  The classical optimum (Young '74 / Daly '06) for
persist cost ``delta`` and mean time between failures ``M`` is::

    T_opt = sqrt(2 * delta * M)   (first order; Daly refines higher order)

expressed here in *steps*: ``T_steps = T_opt / step_time``.  The tuner
tracks EWMA estimates of both delta and step time at runtime, so the
period adapts when e.g. the NVM tier degrades or the model grows —
straggler-aware persistence scheduling.
"""
from __future__ import annotations

import dataclasses
import math


def optimal_period(persist_cost_s: float, mtbf_s: float,
                   step_time_s: float) -> int:
    """Young/Daly optimum converted to whole training steps (>= 1)."""
    if persist_cost_s <= 0 or step_time_s <= 0:
        return 1
    t_opt = math.sqrt(2.0 * persist_cost_s * mtbf_s)
    return max(1, int(round(t_opt / step_time_s)))


@dataclasses.dataclass
class PersistencePeriodTuner:
    mtbf_s: float
    alpha: float = 0.2          # EWMA smoothing
    min_period: int = 1
    max_period: int = 10_000
    _delta: float = 0.0
    _step: float = 0.0

    def observe(self, persist_cost_s: float, step_time_s: float) -> None:
        a = self.alpha
        self._delta = persist_cost_s if self._delta == 0 else (
            (1 - a) * self._delta + a * persist_cost_s)
        self._step = step_time_s if self._step == 0 else (
            (1 - a) * self._step + a * step_time_s)

    @property
    def period(self) -> int:
        if self._delta == 0 or self._step == 0:
            return self.min_period
        p = optimal_period(self._delta, self.mtbf_s, self._step)
        return min(max(p, self.min_period), self.max_period)

    def expected_overhead_fraction(self) -> float:
        """Expected runtime overhead at the current optimum: delta/T + T/(2M)."""
        if self._delta == 0 or self._step == 0:
            return 0.0
        t = self.period * self._step
        return self._delta / t + t / (2 * self.mtbf_s)
